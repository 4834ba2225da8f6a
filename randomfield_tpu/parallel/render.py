"""Sharded render programs: DP ensembles x spatial slab/pencil decomposition.

Composition strategy (SURVEY.md section 7, milestone C/D):

* Sampling, symmetrization, sigma evaluation + scaling and filtering run
  as *global* jit-level ops with sharding constraints.  JAX's
  partitionable Threefry means ``normal(key, global_shape)`` yields
  identical values per logical index under ANY sharding — so a sharded
  render equals the single-device render without per-shard key
  bookkeeping, and the Hermitian fixup's cross-shard conjugate pairs
  (hard part #2) lower to two small collective permutes on the
  kz = 0 / Nyquist planes, handled by XLA.
* sigma(k) comes from the scene's sharded grid, built once from the
  same float32 expression as ``tabulate_sigmas``
  (ops/power.py:sigma_inline), so sharded renders still equal the
  single-device render.  Each device holds only its own shard.
  Reading the grid beats evaluating it inline in every program: the
  table gathers doubled a four-GPU 1024^3 render (PERF.md).
* Only the FFT goes through ``shard_map`` (parallel/dfft.py,
  parallel/pencil.py) — the one place where XLA's data-flow sharding
  would otherwise insert a full gather.
* Derived fields (potential/displacement/velocity kernels) fuse the
  elementwise spectral kernel (ops/derived.py:apply_kernel_inline) into
  the same sharded program — k vectors broadcast + shard exactly like
  sigma, so mesh-native derived fields need no extra communication.

Per-(mesh, scene) compiled programs are cached process-wide.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from randomfield_tpu.ops import power as _power
from randomfield_tpu.ops import transform as _transform
from randomfield_tpu.parallel import dfft
from randomfield_tpu.parallel import pencil as _pencil
from randomfield_tpu.parallel.mesh import DATA_AXIS, SPACE_AXIS, field_sharding

__all__ = [
    "make_sharded_render",
    "make_sharded_render_batch",
    "make_sharded_derived",
    "make_sharded_spectrum_bins",
    "make_sharded_displacement_2lpt",
]

_INV_SQRT2 = 0.7071067811865476


def _mesh_specs(mesh, batched):
    """(draws_spec, spectrum_spec, out_sharding) for a mesh family.

    Pencil meshes use the FULLY sharded state-0 spectrum layout (x over
    'spy', ky over 'spx', kz local) so every per-seed buffer scales as
    1/(px*py) per device; the transform enters via its state-0 path
    (one extra kz <-> x all-to-all over 'spy').
    """
    data = DATA_AXIS if (batched and DATA_AXIS in mesh.shape) else None
    if _pencil.is_pencil_mesh(mesh):
        out = _pencil.pencil_field_sharding(mesh, batched=batched)
        if batched:
            draws = P(data, None, _pencil.SPY_AXIS, _pencil.SPX_AXIS, None)
            spec = P(data, _pencil.SPY_AXIS, _pencil.SPX_AXIS, None)
        else:
            draws = P(None, _pencil.SPY_AXIS, _pencil.SPX_AXIS, None)
            spec = P(_pencil.SPY_AXIS, _pencil.SPX_AXIS, None)
    else:
        out = field_sharding(mesh, batched=batched)
        if batched:
            draws = P(data, None, None, SPACE_AXIS, None)
            spec = P(data, None, SPACE_AXIS, None)
        else:
            draws = P(None, None, SPACE_AXIS, None)
            spec = P(None, SPACE_AXIS, None)
    return NamedSharding(mesh, draws), NamedSharding(mesh, spec), out


def _sampled_spectrum(key, lk_tab, val_tab, smoothing_length, shape, spacing,
                      mesh, batched, log_values, dtype, fixed=False,
                      flip=False, sigmas=None, nested=False):
    """Sample + symmetrize + sigma scale + filter, sharded.

    ``sigmas``: None evaluates sigma inline per shard from the table
    (ops/power.py:sigma_inline); an array is a MATERIALIZED sharded
    sigma grid to read instead (identical values — the grid is built
    from the same expression).  Generator._mesh_sigmas picks which.

    ``fixed=True`` pins every mode's magnitude to sigma(k) exactly
    (Angulo-Pontzen variance suppression, ops/sample.py:
    sample_fixed_spectrum) — elementwise on the shard-local draws, so
    it costs no communication and matches the single-device fixed
    render draw-for-draw; ``flip`` negates the phases (the paired
    realization)."""
    from randomfield_tpu.ops import sample as _sample

    nx, ny, nz = shape
    draws_sharding, spec_sharding, _ = _mesh_specs(mesh, batched)
    # the canonical chunked Threefry stream (ops/sample.py:unit_draws):
    # identical per-mode values to the single-device fused and staged
    # pipelines, and — partitionable Threefry — identical under ANY
    # sharding, so the sharded render still equals the unsharded one
    reim_sharding = NamedSharding(
        mesh, P(*(draws_sharding.spec[:1] + draws_sharding.spec[2:]))
        if batched else P(*draws_sharding.spec[1:])
    )
    if nested:
        # the zoom-matched stream: counter-based threefry keyed by the
        # SIGNED mode indices, elementwise on an iota-derived code grid
        # — shards under GSPMD like the positional draws
        def draw1(k):
            d = _sample.nested_unit_draws(k, shape, dtype)
            return d[0], d[1]
    else:
        def draw1(k):
            return _sample.unit_draws_reim(k, shape, dtype)
    if batched:
        re, im = jax.vmap(draw1)(key)
    else:
        re, im = draw1(key)
    re = jax.lax.with_sharding_constraint(re, reim_sharding)
    im = jax.lax.with_sharding_constraint(im, reim_sharding)
    z = jax.lax.complex(re, im) * jnp.asarray(_INV_SQRT2, dtype)
    z = _transform.symmetrize_with_shape(z, nz=nz, scale_self_conjugate=True)
    if fixed:
        mag = jnp.abs(z)
        z = jnp.where(mag > 0, z / jnp.where(mag > 0, mag, 1.0), 1.0)
        if flip:
            z = -z
    if sigmas is None:
        sig = _power.sigma_inline(
            shape, spacing, lk_tab, val_tab, log_values, dtype, layout="xyz"
        )
    else:
        sig = sigmas
    sig = jax.lax.with_sharding_constraint(
        sig, spec_sharding if not batched
        else NamedSharding(mesh, P(*spec_sharding.spec[1:]))
    )
    c = z * sig
    c = _power.filter_modes(c, shape, spacing, smoothing_length)
    return jax.lax.with_sharding_constraint(c, spec_sharding)


def _inverse(c, shape, mesh, batched, weights=None):
    """Distributed Hermitian inverse; optional (nz,) z-weights applied
    inside the shard-local transform program."""
    if _pencil.is_pencil_mesh(mesh):
        out = _pencil.irfftn_pencil(
            c, shape, mesh, batched=batched, assume_hermitian=True,
            input_layout="state0", weights=weights,
        )
        return out
    return dfft.irfftn_slab(c, shape, mesh, batched=batched,
                            assume_hermitian=True, weights=weights)


@functools.lru_cache(maxsize=32)
def make_sharded_render(mesh: Mesh, shape, spacing, from_seed=False,
                        log_values=False, dtype_name="float32",
                        fixed=False, flip=False, nested=False):
    """Compile a single-realization spatially-sharded render for a mesh.

    The returned fn takes ``(key, lk_tab, val_tab, sig, weights,
    smoothing_length)`` where ``lk_tab``/``val_tab`` are the power
    table's interpolation arrays (ops/power.py:_table_arrays) and
    ``sig`` is None (sigma inline per shard) or the scene's
    materialized sharded sigma grid (see :func:`_sampled_spectrum`).

    ``from_seed=True`` makes the program take a uint32 seed scalar and
    derive the PRNG key *inside* jit — required on multi-host meshes,
    where a key committed to one process's local device cannot enter a
    global program (parallel/multihost.py).  Identical draws either way
    (the key value is the same).  ``fixed``/``flip`` select the
    variance-suppressed fixed-field sampling (see _sampled_spectrum).
    """
    dtype = jnp.dtype(dtype_name)
    _, _, out = _mesh_specs(mesh, batched=False)

    def fn(key, lk_tab, val_tab, sig, weights, smoothing_length):
        if from_seed:
            key = jax.random.key(key)
        c = _sampled_spectrum(
            key, lk_tab, val_tab, smoothing_length, shape, spacing, mesh,
            False, log_values, dtype, fixed, flip, sigmas=sig,
            nested=nested,
        )
        return _inverse(c, shape, mesh, False, weights=weights)

    return jax.jit(fn, out_shardings=out)


@functools.lru_cache(maxsize=32)
def make_sharded_render_batch(mesh: Mesh, shape, spacing, from_seed=False,
                              log_values=False, dtype_name="float32",
                              fixed=False, flip=False, nested=False):
    """Compile a seed-batched render: batch over 'data', spatial sharding."""
    dtype = jnp.dtype(dtype_name)
    _, _, out = _mesh_specs(mesh, batched=True)

    def fn(keys, lk_tab, val_tab, sig, weights, smoothing_length):
        if from_seed:
            keys = jax.vmap(jax.random.key)(keys)
        c = _sampled_spectrum(
            keys, lk_tab, val_tab, smoothing_length, shape, spacing, mesh,
            True, log_values, dtype, fixed, flip, sigmas=sig,
            nested=nested,
        )
        return _inverse(c, shape, mesh, True, weights=weights)

    return jax.jit(fn, out_shardings=out)


@functools.lru_cache(maxsize=64)
def make_sharded_derived(mesh: Mesh, shape, spacing, kind, component,
                         from_seed=False, log_values=False,
                         dtype_name="float32"):
    """Compile a mesh-native derived-field render (potential/displacement).

    Same sampled realization as :func:`make_sharded_render` for a given
    key, with the elementwise spectral kernel
    (ops/derived.py:apply_kernel_inline — 1/k^2 or i*k/k^2) fused
    between filtering and the distributed inverse transform.  Gradient
    kernels zero every self-conjugate mode, so the half-pack c2r tail
    stays exact.  fn(key, lk_tab, val_tab, prefactor, smoothing_length).
    """
    from randomfield_tpu.ops import derived as _derived

    dtype = jnp.dtype(dtype_name)
    _, spec_sharding, out = _mesh_specs(mesh, batched=False)

    def fn(key, lk_tab, val_tab, sig, prefactor, smoothing_length):
        if from_seed:
            key = jax.random.key(key)
        c = _sampled_spectrum(
            key, lk_tab, val_tab, smoothing_length, shape, spacing, mesh,
            False, log_values, dtype, sigmas=sig,
        )
        c = _derived.apply_kernel_inline(
            c, shape, spacing, "xyz", kind, component, prefactor
        )
        c = jax.lax.with_sharding_constraint(c, spec_sharding)
        return _inverse(c, shape, mesh, False)

    return jax.jit(fn, out_shardings=out)


@functools.lru_cache(maxsize=32)
def make_sharded_spectrum_bins(mesh: Mesh, shape, spacing, nbins,
                               from_seed=False, log_values=False,
                               dtype_name="float32"):
    """Compile a distributed FFT-free sample_power (config-4 on meshes).

    Samples the seed's spectrum exactly like the sharded render (same
    Threefry draws and sigma), then bins |c_k|^2 V shard-locally
    inside a ``shard_map`` (per-device |k| rebuilt from axis_index
    slices of the 1-D frequency vectors) and psums over the spatial
    axes — the full spectrum is never gathered and no FFT runs.
    Returns (counts, power_sum, k_sum) replicated host-readable arrays.
    """
    import numpy as np

    from randomfield_tpu.ops import grid as _grid
    from randomfield_tpu.validate.stats import _bin_setup, _masked_bins

    dtype = jnp.dtype(dtype_name)
    nx, ny, nz = shape
    volume = nx * ny * nz * spacing**3
    edges, mult = _bin_setup(shape, spacing, nbins)
    kx, ky, kz = (np.asarray(v) for v in _grid.kvectors(shape, spacing))
    pencil = _pencil.is_pencil_mesh(mesh)
    if pencil:
        # fully sharded state-0 spectrum: x over 'spy', ky over 'spx'
        nx_loc = nx // mesh.shape[_pencil.SPY_AXIS]
        ny_loc = ny // mesh.shape[_pencil.SPX_AXIS]
        psum_axes = (_pencil.SPX_AXIS, _pencil.SPY_AXIS)
        in_spec = P(_pencil.SPY_AXIS, _pencil.SPX_AXIS, None)
    else:
        nx_loc = nx
        ny_loc = ny // mesh.shape.get(SPACE_AXIS, 1)
        psum_axes = (SPACE_AXIS,)
        in_spec = P(None, SPACE_AXIS, None)

    def _local_bins(cl):
        # cl: (nx[/py], ny/S, nzh) local block of the sampled spectrum
        if pencil:
            jx = jax.lax.axis_index(_pencil.SPY_AXIS)
            jy = jax.lax.axis_index(_pencil.SPX_AXIS)
        else:
            jx = 0
            jy = jax.lax.axis_index(SPACE_AXIS)
        kx_l = jax.lax.dynamic_slice(jnp.asarray(kx), (jx * nx_loc,), (nx_loc,))
        ky_l = jax.lax.dynamic_slice(jnp.asarray(ky), (jy * ny_loc,), (ny_loc,))
        km = jnp.sqrt(
            (kx_l * kx_l)[:, None, None]
            + (ky_l * ky_l)[None, :, None]
            + jnp.asarray(kz * kz)[None, None, :]
        ).astype(cl.real.dtype)
        p = (cl.real**2 + cl.imag**2) * jnp.asarray(volume, cl.real.dtype)
        counts, psum_, ksum = _masked_bins(
            jnp.broadcast_to(km, p.shape),
            jnp.asarray(mult, cl.real.dtype)[None, None, :], p,
            jnp.asarray(edges, cl.real.dtype), nbins, per_slab=True,
        )
        return jax.lax.psum(jnp.stack([counts, psum_, ksum]), psum_axes)

    def fn(key, lk_tab, val_tab, sig, smoothing_length):
        if from_seed:
            key = jax.random.key(key)
        c = _sampled_spectrum(
            key, lk_tab, val_tab, smoothing_length, shape, spacing, mesh,
            False, log_values, dtype, sigmas=sig,
        )
        bins = jax.shard_map(
            _local_bins, mesh=mesh, in_specs=in_spec, out_specs=P(),
            check_vma=False,
        )(c)
        return bins[0], bins[1], bins[2]

    return jax.jit(fn)


@functools.lru_cache(maxsize=32)
def make_sharded_displacement_2lpt(mesh: Mesh, shape, spacing,
                                   from_seed=False, log_values=False,
                                   dtype_name="float32", component=None):
    """Compile the mesh-native 2LPT correction psi(2) for one seed.

    Same math as ops/derived.py:_second_order_displacement, fully
    distributed: the six tidal fields phi,ij render from the SAME
    sharded sampled spectrum (elementwise k_i k_j / k^2 kernels with
    Nyquist-zeroed gradient vectors, distributed inverse each), the
    quadratic source S2 = sum_{i<j} [phi,ii phi,jj - phi,ij^2] is a
    shard-local pointwise expression (all six fields share the output
    sharding, so no communication), and one distributed forward + up to
    three gradient inverses finish ``psi2_k = (3/7) i k S2_k / k^2``.
    Returns a tuple of per-component fields, each sharded like the
    plain mesh render; ``component`` selects one (None -> all three).
    """
    from randomfield_tpu.models.constrained import _forward_mesh
    from randomfield_tpu.ops import derived as _derived
    from randomfield_tpu.ops import grid as _grid

    dtype = jnp.dtype(dtype_name)
    _, spec_sharding, out = _mesh_specs(mesh, batched=False)
    comps = (0, 1, 2) if component is None else (int(component),)

    def fn(key, lk_tab, val_tab, sig, smoothing_length):
        if from_seed:
            key = jax.random.key(key)
        c = _sampled_spectrum(
            key, lk_tab, val_tab, smoothing_length, shape, spacing, mesh,
            False, log_values, dtype, sigmas=sig,
        )
        k2 = _grid.ksq(shape, spacing, dtype)
        inv = jnp.where(k2 > 0, 1.0 / jnp.where(k2 > 0, k2, 1.0), 0.0)
        gk = _derived._grad_kvectors(shape, spacing, dtype)
        bcasts = ((slice(None), None, None), (None, slice(None), None),
                  (None, None, slice(None)))

        def kv(i):
            return gk[i][bcasts[i]]

        def tid(i, j):
            ck = jax.lax.with_sharding_constraint(
                c * (kv(i) * kv(j) * inv), spec_sharding
            )
            return _inverse(ck, shape, mesh, False)

        d00, d11, d22 = tid(0, 0), tid(1, 1), tid(2, 2)
        d01, d02, d12 = tid(0, 1), tid(0, 2), tid(1, 2)
        s2 = (
            d00 * d11 + d00 * d22 + d11 * d22
            - d01 * d01 - d02 * d02 - d12 * d12
        )
        b = _forward_mesh(s2, shape, mesh, dtype)
        pref = jnp.asarray(3.0 / 7.0, dtype)
        psi = []
        for i in comps:
            g = pref * kv(i) * inv
            bk = jax.lax.with_sharding_constraint(
                jax.lax.complex(-b.imag * g, b.real * g), spec_sharding
            )
            psi.append(_inverse(bk, shape, mesh, False))
        return tuple(psi)

    return jax.jit(fn, out_shardings=tuple(out for _ in comps))
