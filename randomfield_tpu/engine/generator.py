"""The Generator scene/state API — render seeded Gaussian random fields.

Reference parity: ``randomfield/generate.py:Generator`` — constructor does
the expensive scene setup once (sigma(k) tabulation, cosmological
evolution, transform setup), then each ``generate_delta_field(seed)``
renders one realization reusing that state (SURVEY.md sections 3.1-3.2).

Design: the whole per-seed render — counter-based Hermitian
mode sampling, sigma scaling, Gaussian mode filtering, packed c2r inverse
FFT, lightcone growth weighting — is ONE jitted XLA program (the north
star's "fused render pass").  Sampling + scaling + filtering fuse into a
single pass over the half-spectrum; the smoothing length is a traced
scalar so changing it never recompiles.  Ensembles ``vmap`` the same
program over a seed axis, ready to shard over a data-parallel mesh axis
(see randomfield_tpu.parallel).
"""

from __future__ import annotations

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from randomfield_tpu.engine import scene as _scene
from randomfield_tpu.models import cosmology as _cosmo
from randomfield_tpu.ops import grid as _grid
from randomfield_tpu.ops import power as _power
from randomfield_tpu.ops import sample as _sample
from randomfield_tpu.ops import transform as _transform

__all__ = ["Generator", "render", "render_from_noise", "seeds_to_keys"]

# the mode samplers a Generator accepts
SAMPLERS = ("threefry", "nested")


def _spectrum_from_noise_impl(draws, sigmas, smoothing_length, shape, spacing):
    """draws -> scaled, filtered, Hermitian packed spectrum (one fusion)."""
    nz = shape[2]
    real_dtype = draws.dtype
    z = jax.lax.complex(draws[0], draws[1]) * jnp.asarray(
        _sample._INV_SQRT2, real_dtype
    )
    z = _transform.symmetrize_with_shape(z, nz=nz, scale_self_conjugate=True)
    c = z * sigmas.astype(real_dtype)
    return _power.filter_modes(c, shape, spacing, smoothing_length)


def _render_from_noise_impl(draws, sigmas, weights, smoothing_length, shape, spacing):
    c = _spectrum_from_noise_impl(draws, sigmas, smoothing_length, shape, spacing)
    # the spectrum is symmetrized -> the fast half-pack c2r tail is exact
    delta = _transform.irfftn(c, shape, norm="forward", assume_hermitian=True)
    return delta * weights[None, None, :]


def _render_impl(key, sigmas, weights, smoothing_length, shape, spacing,
                 nested=False):
    if nested:
        c = _sample.sample_spectrum_nested(key, sigmas, shape)
        c = _power.filter_modes(c, shape, spacing, smoothing_length)
        delta = _transform.irfftn(c, shape, norm="forward",
                                  assume_hermitian=True)
        return delta * weights[None, None, :]
    draws = _sample.unit_draws(key, shape, sigmas.dtype)
    return _render_from_noise_impl(
        draws, sigmas, weights, smoothing_length, shape, spacing
    )


@functools.partial(jax.jit, static_argnames=("shape", "spacing"))
def render_from_noise(draws, sigmas, weights, smoothing_length, shape, spacing):
    """Render from externally supplied unit normal draws (2, nx, ny, nzh).

    This is the algebra-only path used to pin conventions against the
    float64 oracle (validate/oracle.py:render_from_noise): symmetrize ->
    scale by sigma -> filter -> irfftn -> lightcone weighting.
    """
    return _render_from_noise_impl(
        draws, sigmas, weights, smoothing_length, shape, spacing
    )


@functools.partial(jax.jit, static_argnames=("shape", "spacing", "nested"))
def render(key, sigmas, weights, smoothing_length, shape, spacing,
           nested=False):
    """One fused seeded render: sample -> filter -> irfftn -> lightcone."""
    return _render_impl(key, sigmas, weights, smoothing_length, shape,
                        spacing, nested)


@functools.partial(jax.jit,
                   static_argnames=("shape", "spacing", "flip", "nested"))
def render_fixed(key, sigmas, weights, smoothing_length, shape, spacing,
                 flip=False, nested=False):
    """Variance-suppressed render: |c_k| = sigma(k) exactly (fixed field).

    One fused program like :func:`render` but through
    ops/sample.py:sample_fixed_spectrum — per-mode amplitudes pinned to
    the target, phases Gaussian-uniform; ``flip`` renders the paired
    (phase-shifted-by-pi) realization.
    """
    c = _sample.sample_fixed_spectrum(key, sigmas, shape, flip=flip,
                                      nested=nested)
    c = _power.filter_modes(c, shape, spacing, smoothing_length)
    delta = _transform.irfftn(c, shape, norm="forward", assume_hermitian=True)
    return delta * weights[None, None, :]


@functools.partial(jax.jit,
                   static_argnames=("shape", "spacing", "flip", "nested"))
def _render_fixed_batch(keys, sigmas, weights, smoothing_length, shape,
                        spacing, flip, nested=False):
    def one(k):
        c = _sample.sample_fixed_spectrum(k, sigmas, shape, flip=flip,
                                          nested=nested)
        c = _power.filter_modes(c, shape, spacing, smoothing_length)
        d = _transform.irfftn(c, shape, norm="forward", assume_hermitian=True)
        return d * weights[None, None, :]

    return jax.vmap(one)(keys)


@functools.partial(jax.jit, static_argnames=("shape", "spacing", "layout"))
def _predicted_variance_device(sigmas, smoothing_length, shape, spacing, layout):
    """<delta^2> = sum over packed modes of mult * (sigma * filter)^2.

    The engine folds 1/V into sigma, so the per-mode contribution to the
    field variance is exactly sigma^2 (times the Gaussian filter and the
    kz multiplicity).  Device reduction with axiswise partial sums
    (accumulation-safe, see validate/stats.py:_mean_axiswise); the host
    float64 oracle sum it replaces costs MINUTES at 1024^3 on this VM.
    """
    nx, ny, nz = shape
    nzh = nz // 2 + 1
    dt = sigmas.dtype
    mult = jnp.full((nzh,), 2.0, dt).at[0].set(1.0)
    if nz % 2 == 0:
        mult = mult.at[-1].set(1.0)
    kx, ky, kz = _grid.kvectors(shape, spacing, dt)
    s = jnp.asarray(smoothing_length, dt)
    if layout == "xzy":
        k2 = (kx * kx)[:, None, None] + (kz * kz)[None, :, None] \
            + (ky * ky)[None, None, :]
        m = mult[None, :, None]
    else:
        k2 = (kx * kx)[:, None, None] + (ky * ky)[None, :, None] \
            + (kz * kz)[None, None, :]
        m = mult[None, None, :]
    contrib = m * sigmas * sigmas * jnp.exp(-k2 * s * s)
    while contrib.ndim:
        contrib = jnp.sum(contrib, axis=-1)
    return contrib


@functools.partial(
    jax.jit, static_argnames=("shape", "spacing", "log_values", "dtype_name")
)
def _predicted_variance_table(lk_tab, val_tab, smoothing_length, shape,
                              spacing, log_values, dtype_name):
    """<delta^2> from the power TABLE (no sigma grid input; mesh scenes).

    Same sum as :func:`_predicted_variance_device`, with sigma evaluated
    inline per x-slab chunk under ``lax.map`` so peak memory stays a few
    hundred MB at any grid size (layout is always 'xyz' here — mesh
    scenes never use the staged layout).
    """
    nx, ny, nz = shape
    nzh = nz // 2 + 1
    dt = jnp.dtype(dtype_name)
    volume = nx * ny * nz * float(spacing) ** 3
    mult = jnp.full((nzh,), 2.0, dt).at[0].set(1.0)
    if nz % 2 == 0:
        mult = mult.at[-1].set(1.0)
    kx, ky, kz = _grid.kvectors(shape, spacing, dt)
    s = jnp.asarray(smoothing_length, dt)
    chunks = 1
    for c in range(min(16, nx), 0, -1):
        if nx % c == 0:
            chunks = c
            break

    def one(kxs):
        k2 = (
            (kxs * kxs)[:, None, None]
            + (ky * ky)[None, :, None]
            + (kz * kz)[None, None, :]
        )
        sig = _power._sigma_chunk(
            kxs * kxs, ky, kz, lk_tab, val_tab, log_values, dt, volume
        )
        contrib = mult[None, None, :] * sig * sig * jnp.exp(-k2 * s * s)
        while contrib.ndim:
            contrib = jnp.sum(contrib, axis=-1)
        return contrib

    return jnp.sum(jax.lax.map(one, kx.reshape(chunks, nx // chunks)))


@functools.partial(jax.jit, static_argnames=("shape", "spacing", "nested"))
def _sample_spectrum_jit(key, sigmas, smoothing_length, shape, spacing,
                         nested=False):
    if nested:
        c = _sample.sample_spectrum_nested(key, sigmas, shape)
        return _power.filter_modes(c, shape, spacing, smoothing_length)
    draws = _sample.unit_draws(key, shape, sigmas.dtype)
    return _spectrum_from_noise_impl(draws, sigmas, smoothing_length, shape, spacing)


@functools.partial(
    jax.jit,
    static_argnames=("shape", "spacing", "layout", "kind", "component"),
    donate_argnums=0,
)
def _apply_spectral_kernel(c, prefactor, shape, spacing, layout, kind,
                           component):
    """Elementwise derived-field kernel on a sampled spectrum (in place;
    kernel built inline — see ops/derived.py:apply_kernel_inline)."""
    from randomfield_tpu.ops import derived as _derived

    return _derived.apply_kernel_inline(
        c, shape, spacing, layout, kind, component, prefactor
    )


@functools.partial(
    jax.jit,
    static_argnames=("shape", "spacing", "layout", "kind", "component"),
    donate_argnums=0,
)
def _finish_derived(c, prefactor, shape, spacing, layout, kind, component):
    """kernel + irfftn for the fused derived-field path (Hermitian by
    construction: gradient kernels zero every self-conjugate mode)."""
    from randomfield_tpu.ops import derived as _derived

    c = _derived.apply_kernel_inline(
        c, shape, spacing, layout, kind, component, prefactor
    )
    return _transform.irfftn(c, shape, norm="forward", assume_hermitian=True)


@functools.partial(jax.jit, static_argnames=("shape",), donate_argnums=0)
def _finish_render(c, weights, shape):
    """irfftn + lightcone weighting of an externally sampled spectrum."""
    delta = _transform.irfftn(c, shape, norm="forward", assume_hermitian=True)
    return delta * weights[None, None, :]


@functools.partial(jax.jit, static_argnames=("shape", "spacing", "nested"))
def _render_batch(keys, sigmas, weights, smoothing_length, shape, spacing,
                  nested=False):
    def one(k):
        return _render_impl(k, sigmas, weights, smoothing_length, shape,
                            spacing, nested)

    return jax.vmap(one)(keys)


def seeds_to_keys(seeds):
    """Vectorized integer seeds -> typed PRNG keys."""
    seeds = jnp.asarray(seeds)
    if jnp.issubdtype(seeds.dtype, jax.dtypes.prng_key):
        return seeds
    return jax.vmap(jax.random.key)(seeds.astype(jnp.uint32))


def _as_key(seed):
    if hasattr(seed, "dtype") and jnp.issubdtype(
        jnp.asarray(seed).dtype, jax.dtypes.prng_key
    ):
        return seed
    return jax.random.key(int(seed))


from randomfield_tpu.engine.constrained_api import ConstrainedMixin
from randomfield_tpu.engine.measure import MeasurementMixin


class Generator(MeasurementMixin, ConstrainedMixin):
    """Generate 3-D Gaussian random density fields with a given P(k).

    Parameters (mirroring randomfield/generate.py:Generator.__init__):

    nx, ny, nz : grid dimensions; the z axis is the line of sight.
    grid_spacing : comoving grid spacing in Mpc/h.
    cosmology : a :class:`randomfield_tpu.models.cosmology.Cosmology`,
        a preset name ('Planck13'...), or None for the default Planck13.
    power : tabulated P(k) — (k, Pk) in h/Mpc, (Mpc/h)^3 — or None for
        the default linear table (ref: powertools.load_default_power).
    interpolation : 'log10k' (reference behavior) or 'loglog'.
    dtype : render precision (float32 is the device default; the
        statistical fidelity gate runs against the float64 oracle).
    z0 : redshift of the nearest plane of the lightcone.
    sampler : 'threefry' (counter-based jax.random; layout-independent,
        oracle-reproducible — the default) or 'nested'
        (resolution-nested draws keyed by SIGNED mode indices,
        ops/sample.py:sample_unit_hermitian_nested: grids of different
        size over the same box share every common mode — zoom-matched
        realizations; single-device fused pipeline, dims <= 1024, its
        own deterministic stream).
    mesh : optional ``jax.sharding.Mesh``.  Either ('data', 'space') from
        :func:`randomfield_tpu.parallel.mesh.make_mesh` — 'space' > 1
        shards the grid spatially (slab decomposition + distributed
        irfftn, config 5); 'data' > 1 shards ensemble seed batches
        (config 4) — or ('data', 'spx', 'spy') from
        :func:`randomfield_tpu.parallel.pencil.make_pencil_mesh` for the
        2-D pencil decomposition (scales past the slab limit of
        min(nx, ny) devices).  None = single device.
    verbose : print per-stage timings (ref: the verbose ctor flag).

    The constructor performs all O(N^3) precomputation; every
    ``generate_delta_field`` call is one compiled device program.
    """

    def __init__(self, nx, ny, nz, grid_spacing, cosmology=None, power=None,
                 interpolation="log10k", dtype=jnp.float32, z0=0.0,
                 mesh=None, pipeline="auto", sampler="threefry", verbose=False):
        t0 = time.perf_counter()
        self.cosmology = _cosmo.create_cosmology(cosmology)
        self.scene = _scene.Scene(
            nx=int(nx), ny=int(ny), nz=int(nz), grid_spacing=float(grid_spacing),
            cosmology=self.cosmology, interpolation=interpolation, dtype=dtype,
            z0=float(z0),
        )
        from randomfield_tpu.models.powerspec import resolve_power

        # named model zoo resolves against THIS scene's cosmology (so e.g.
        # Generator(..., cosmology='Planck18', power='eh98') is
        # self-consistent)
        power = resolve_power(power, self.cosmology)
        from randomfield_tpu.engine.staged import pick_pipeline

        # fused, staged and mesh Threefry pipelines all draw the ONE
        # canonical chunked stream (ops/sample.py:unit_draws), so
        # pipeline='auto' never changes realization family across grid
        # sizes (round-4 change; the round-3 warning here is obsolete)
        self.pipeline = pick_pipeline(self.scene.shape, pipeline)
        if mesh is not None:
            if pipeline == "staged":
                raise ValueError(
                    "pipeline='staged' is incompatible with mesh mode "
                    "(the sharded render is its own pipeline); use "
                    "pipeline='auto' or 'fused'"
                )
            self.pipeline = "fused"
        if sampler not in SAMPLERS:
            raise ValueError(
                f"unknown sampler {sampler!r}: choose 'threefry' (the "
                f"default counter-based stream) or 'nested'"
            )
        if sampler == "nested":
            from randomfield_tpu.ops.sample import NESTED_MAX_DIM

            if pipeline == "staged":
                raise ValueError(
                    "sampler='nested' needs the fused pipeline (the staged "
                    "pipeline draws in a different, positional order); use "
                    "pipeline='auto' or 'fused'"
                )
            if max(self.scene.shape) > NESTED_MAX_DIM:
                raise ValueError(
                    f"sampler='nested' packs signed mode indices into 10 "
                    f"bits per axis (max dim {NESTED_MAX_DIM}); got "
                    f"{self.scene.shape}"
                )
            self.pipeline = "fused"
        layout = "xzy" if self.pipeline == "staged" else "xyz"
        self.sampler = sampler
        self._nested = sampler == "nested"
        self._layout = layout
        self._dtype = jnp.dtype(dtype)
        self.mesh = mesh
        self._multiprocess = False
        # mesh scenes store no sigma grid up front: the first sharded
        # program that needs one materializes it, each shard on its own
        # device (the .sigmas property; _mesh_sigmas)
        self.state, self._aux = _scene.build_state(
            self.scene, power, layout=layout, with_sigmas=mesh is None,
        )
        self._table_host = _power.table_arrays_host(
            self._aux["power"], interpolation, dtype
        )
        if mesh is not None:
            from randomfield_tpu.parallel import multihost as _mh
            from randomfield_tpu.parallel import pencil as _pencil
            from randomfield_tpu.parallel.dfft import _check_divisible
            from randomfield_tpu.parallel.mesh import SPACE_AXIS

            if _pencil.is_pencil_mesh(mesh):
                # 2-D (pencil) spatial decomposition — scales past the
                # slab limit of min(nx, ny) devices (parallel/pencil.py)
                _pencil._check_pencil(
                    self.scene.shape,
                    mesh.shape[_pencil.SPX_AXIS], mesh.shape[_pencil.SPY_AXIS],
                )
            else:
                _check_divisible(self.scene.shape, mesh.shape.get(SPACE_AXIS, 1))
            self._multiprocess = _mh.is_multiprocess()
            if self._multiprocess:
                # small per-call inputs must be process-replicated host
                # values, not arrays committed to one process's device
                self.state = self.state._replace(
                    lightcone_weights=np.asarray(self.state.lightcone_weights)
                )
        self.verbose = bool(verbose)
        if self.verbose:
            if self.state.sigmas is not None:
                mb = self.state.sigmas.size * self._dtype.itemsize / 2**20
                sig_note = f"sigma grid {mb:.1f} MiB"
            else:
                sig_note = "sharded sigma grid built on first use (mesh)"
            print(
                f"[randomfield_tpu] scene setup {time.perf_counter() - t0:.3f}s, "
                f"{sig_note}, k in [{self.k_min:.4g}, {self.k_max:.4g}] h/Mpc"
            )

    # ---- introspection ------------------------------------------------------
    @property
    def shape(self):
        return self.scene.shape

    @property
    def grid_spacing(self):
        return self.scene.grid_spacing

    @property
    def power(self):
        """The validated power table in use."""
        return self._aux["power"]

    @property
    def redshifts(self):
        """Redshift of each z plane (host float64)."""
        return self._aux["redshifts"]

    @property
    def growth_function(self):
        """D(z)/D(0) of each z plane (host float64)."""
        return self._aux["growth"]

    @property
    def k_min(self):
        return self.scene.k_bounds[0]

    @property
    def k_max(self):
        return self.scene.k_bounds[1]

    @property
    def sigmas(self):
        """The per-mode sigma grid (device array).

        Mesh scenes store none at construction; the first read (every
        mesh program reads it, see :meth:`_mesh_sigmas`) materializes a
        SHARDED grid (x over the innermost spatial axis for pencil
        meshes, ky-slabs for slab meshes) and caches it.
        """
        if self.state.sigmas is None:
            self.state = self.state._replace(sigmas=self._materialize_sigmas())
        return self.state.sigmas

    def _materialize_sigmas(self):
        from jax.sharding import NamedSharding
        from randomfield_tpu.parallel import pencil as _pencil
        from randomfield_tpu.parallel.mesh import P, SPACE_AXIS, spectrum_sharding

        mesh = self.mesh
        if _pencil.is_pencil_mesh(mesh):
            # fully sharded state-0 placement: x over 'spy', ky over
            # 'spx' — per-device bytes scale as 1/(px*py), unlike the
            # round-2 replicated placement
            sharding = _pencil.pencil_sigma_sharding(mesh)
        else:
            sharding = spectrum_sharding(mesh)
        lk, val = self._table_args()
        shape, sp = self.scene.shape, self.scene.grid_spacing
        log_values = self._table_host[2]
        dt = self._dtype

        fn = jax.jit(
            lambda lk, val: _power.sigma_inline(
                shape, sp, lk, val, log_values, dt, layout="xyz"
            ),
            out_shardings=sharding,
        )
        return fn(lk, val)

    def _table_args(self):
        """(log10k, P) interpolation arrays for program inputs."""
        return self._table_host[0], self._table_host[1]

    def _mesh_sigmas(self):
        """The sigma argument of the mesh render programs: the scene's
        materialized sharded grid (:attr:`sigmas`, built on first use
        and cached).  Reading it is faster than evaluating sigma inline
        per shard (ops/power.py:sigma_inline, selected by passing None):
        a 1024^3 slab render on four H100s takes 20 ms with the grid and
        42 ms inline, whose table gathers dominate the trace (PERF.md
        "Bring-up findings").  The price is one half-spectrum f32 shard
        per device."""
        return self.sigmas

    def predicted_variance(self, smoothing_length=0.0, apply_lightcone=False):
        """Exact expected variance of a rendered field.

        Computed on device — from the tabulated sigma grid, or for mesh
        scenes from the table directly (chunked inline evaluation; no
        grid is stored).  Matches the float64 oracle sum to ~1e-5
        relative — asserted in tests; the host sum costs minutes at
        1024^3.  ``apply_lightcone=True`` predicts the default
        lightcone-weighted render instead: each z-plane is scaled by
        D(z)/D(0), so the global variance picks up the plane-mean of
        D^2 exactly.
        """
        from randomfield_tpu.parallel.multihost import replicated_to_host

        sm = (
            np.asarray(smoothing_length, np.float32)
            if self._multiprocess
            else jnp.asarray(smoothing_length, self._dtype)
        )
        if self.state.sigmas is None:
            lk, val = self._table_args()
            out = _predicted_variance_table(
                lk, val, sm, self.scene.shape, self.scene.grid_spacing,
                self._table_host[2], str(self._dtype),
            )
        else:
            out = _predicted_variance_device(
                self.state.sigmas, sm,
                self.scene.shape, self.scene.grid_spacing, self._layout,
            )
        out = float(replicated_to_host(out))
        if apply_lightcone:
            w = np.asarray(self.growth_function, np.float64)
            out *= float(np.mean(w * w))
        return out

    # ---- rendering -----------------------------------------------------------
    def _weights(self, apply_lightcone):
        w = self.state.lightcone_weights
        if apply_lightcone:
            return w
        # multiprocess keeps weights as host numpy (process-replicated)
        return np.ones_like(w) if isinstance(w, np.ndarray) else jnp.ones_like(w)

    def _smoothing(self, smoothing_length):
        dt = self._dtype
        if self._multiprocess:
            return np.asarray(smoothing_length, dt)
        return jnp.asarray(smoothing_length, dt)

    def _seed_u32(self, seed):
        if hasattr(seed, "dtype") and jnp.issubdtype(
            jnp.asarray(seed).dtype, jax.dtypes.prng_key
        ):
            raise ValueError(
                "multi-process meshes take integer seeds (keys are derived "
                "inside the global program; a key committed to one "
                "process's device cannot enter it)"
            )
        return np.uint32(int(seed))

    def _maybe_verbose(self, out, seed, t0):
        if self.verbose:
            out.block_until_ready()
            dt = time.perf_counter() - t0
            ncells = np.prod(self.scene.shape)
            print(
                f"[randomfield_tpu] render seed={seed}: {dt * 1e3:.1f} ms "
                f"({ncells / dt / 1e9:.2f} Gcells/s)"
            )
        return out

    def generate_delta_field(self, seed=0, smoothing_length=0.0,
                             apply_lightcone=True):
        """Render one realization (ref: generate.py generate method).

        Returns the (nx, ny, nz) real density contrast field delta(x) as a
        device array.  Fixed seed => bit-identical field.
        """
        return self._generate_delta_field(
            seed, smoothing_length, apply_lightcone
        )

    def _generate_delta_field(self, seed, smoothing_length, apply_lightcone):
        t0 = time.perf_counter()
        if self.mesh is not None:
            from randomfield_tpu.parallel.render import make_sharded_render

            fn = make_sharded_render(
                self.mesh, self.scene.shape, self.scene.grid_spacing,
                from_seed=self._multiprocess,
                log_values=self._table_host[2], dtype_name=str(self._dtype),
                nested=self._nested,
            )
            lk, val = self._table_args()
            out = fn(
                self._seed_u32(seed) if self._multiprocess else _as_key(seed),
                lk, val, self._mesh_sigmas(), self._weights(apply_lightcone),
                self._smoothing(smoothing_length),
            )
        elif self.pipeline == "staged":
            from randomfield_tpu.engine.staged import staged_render

            out = staged_render(
                _as_key(seed), self.sigmas, self._weights(apply_lightcone),
                jnp.asarray(smoothing_length, self._dtype),
                self.scene.shape, self.scene.grid_spacing,
            )
        else:
            out = render(
                _as_key(seed), self.state.sigmas, self._weights(apply_lightcone),
                jnp.asarray(smoothing_length, self._dtype),
                self.scene.shape, self.scene.grid_spacing,
                nested=self._nested,
            )
        if self.verbose:
            out.block_until_ready()
            dt = time.perf_counter() - t0
            ncells = np.prod(self.scene.shape)
            print(
                f"[randomfield_tpu] render seed={seed}: {dt * 1e3:.1f} ms "
                f"({ncells / dt / 1e9:.2f} Gcells/s)"
            )
        return out

    def generate_fixed_field(self, seed=0, smoothing_length=0.0,
                             apply_lightcone=True, flip=False):
        """Variance-suppressed 'fixed' realization (Angulo-Pontzen 2016).

        Per-mode amplitudes are pinned to sigma(k) EXACTLY (only the
        phases are random), so the realized P(k) carries no sampling
        scatter and the field variance equals ``predicted_variance()``
        to rounding — ensemble means converge dramatically faster for
        P(k)-dominated statistics.  ``flip=True`` renders the paired
        realization (phases shifted by pi; for the Gaussian field this
        is the negation, but nonlinear descendants — lognormal mocks,
        displaced catalogs — differ nontrivially).  Works on the fused
        single-device path and on slab/pencil meshes (the magnitude
        normalization is elementwise on the shard-local draws, so the
        sharded fixed field equals the single-device one exactly); the
        staged pipeline streams the spectrum and never materializes
        per-mode magnitudes, so it raises.
        """
        if self.pipeline != "fused":
            raise ValueError(
                "fixed fields need the fused (or mesh) path (the staged "
                "pipeline streams the spectrum); build the Generator "
                "with pipeline='fused'"
            )
        t0 = time.perf_counter()
        if self.mesh is not None:
            from randomfield_tpu.parallel.render import make_sharded_render

            fn = make_sharded_render(
                self.mesh, self.scene.shape, self.scene.grid_spacing,
                from_seed=self._multiprocess,
                log_values=self._table_host[2], dtype_name=str(self._dtype),
                fixed=True, flip=bool(flip),
            )
            lk, val = self._table_args()
            out = fn(
                self._seed_u32(seed) if self._multiprocess else _as_key(seed),
                lk, val, self._mesh_sigmas(), self._weights(apply_lightcone),
                self._smoothing(smoothing_length),
            )
            return self._maybe_verbose(out, seed, t0)
        out = render_fixed(
            _as_key(seed), self.state.sigmas, self._weights(apply_lightcone),
            jnp.asarray(smoothing_length, self._dtype),
            self.scene.shape, self.scene.grid_spacing, bool(flip),
            nested=self._nested,
        )
        return self._maybe_verbose(out, seed, t0)

    def generate_noise(self, seed=0):
        """A seed's raw unit normal draws, shape (2, nx, ny, nz//2+1).

        The full pre-Hermitian sampling state (before symmetrization,
        sigma scaling and filtering) — export it for IC interchange
        with other codes, or perturb it for sensitivity studies;
        :meth:`generate_from_noise` consumes the same contract, and
        ``generate_from_noise(generate_noise(s)) ==
        generate_delta_field(s)`` exactly on the fused pipeline (both
        Threefry and nested streams).
        """
        if self.pipeline != "fused":
            raise ValueError(
                "noise export matches the fused pipeline's draw order; "
                "build the Generator with pipeline='fused'"
            )
        if self._nested:
            from randomfield_tpu.ops.sample import nested_unit_draws

            return nested_unit_draws(
                _as_key(seed), self.scene.shape, self._dtype
            )
        return _sample.unit_draws(_as_key(seed), self.scene.shape, self._dtype)

    def generate_from_noise(self, draws, smoothing_length=0.0,
                            apply_lightcone=True):
        """Render from externally supplied unit normal draws.

        ``draws``: (2, nx, ny, nz//2+1) — real/imaginary unit normals
        per packed mode (:meth:`generate_noise`'s contract, or any
        other code's white noise mapped onto the packed half-spectrum).
        Runs the oracle-pinned algebra path: symmetrize -> sigma(k)
        scale -> filter -> irfftn -> lightcone
        (engine/generator.py:render_from_noise).  Single-device fused
        scenes (the mesh pipeline samples shard-locally and never
        consumes a materialized noise grid).
        """
        if (self.mesh is not None or self.state.sigmas is None
                or self._layout != "xyz"):
            raise ValueError(
                "generate_from_noise needs a single-device fused scene "
                "with a materialized sigma grid (sampler='threefry' or "
                "'nested', pipeline='fused', mesh=None)"
            )
        nx, ny, nz = self.scene.shape
        want = (2, nx, ny, nz // 2 + 1)
        draws = jnp.asarray(draws, self._dtype)
        if draws.shape != want:
            raise ValueError(
                f"draws must have shape {want} (2 = re/im unit normals "
                f"over the packed half-spectrum), got {draws.shape}"
            )
        return render_from_noise(
            draws, self.state.sigmas, self._weights(apply_lightcone),
            jnp.asarray(smoothing_length, self._dtype),
            self.scene.shape, self.scene.grid_spacing,
        )

    def generate_fixed_fields(self, seeds, smoothing_length=0.0,
                              apply_lightcone=True, flip=False):
        """A vmapped seed batch of fixed fields (leading axis = seed).

        Same realizations as per-seed :meth:`generate_fixed_field`
        calls; for 'fixed & paired' ensembles render the batch twice
        (``flip=False`` and ``flip=True``) and average the statistics.
        """
        if self.pipeline != "fused":
            raise ValueError(
                "fixed fields need the fused (or mesh) path; build the "
                "Generator with pipeline='fused'"
            )
        keys = seeds_to_keys(seeds)
        if self.mesh is not None:
            from randomfield_tpu.parallel.render import make_sharded_render_batch

            fn = make_sharded_render_batch(
                self.mesh, self.scene.shape, self.scene.grid_spacing,
                from_seed=self._multiprocess,
                log_values=self._table_host[2], dtype_name=str(self._dtype),
                fixed=True, flip=bool(flip),
            )
            first = (
                np.asarray(seeds, np.uint32) if self._multiprocess else keys
            )
            lk, val = self._table_args()
            return fn(
                first, lk, val, self._mesh_sigmas(),
                self._weights(apply_lightcone),
                self._smoothing(smoothing_length),
            )
        return _render_fixed_batch(
            keys, self.state.sigmas, self._weights(apply_lightcone),
            jnp.asarray(smoothing_length, self._dtype),
            self.scene.shape, self.scene.grid_spacing, bool(flip),
            nested=self._nested,
        )

    def generate_delta_fields(self, seeds, smoothing_length=0.0,
                              apply_lightcone=True):
        """Render a batch of seeds as one vmapped program (ensemble mode).

        The leading axis of the result is the seed axis; shard it over a
        'data' mesh axis for data-parallel covariance studies (config 4).
        """
        keys = None if self._multiprocess else seeds_to_keys(seeds)
        if self.mesh is None and self.pipeline == "staged":
            # staged grids are near the HBM ceiling: render sequentially
            from randomfield_tpu.engine.staged import staged_render

            sm = jnp.asarray(smoothing_length, self._dtype)
            w = self._weights(apply_lightcone)
            return jnp.stack([
                staged_render(
                    keys[i], self.sigmas, w, sm,
                    self.scene.shape, self.scene.grid_spacing,
                )
                for i in range(len(keys))
            ])
        if self.mesh is not None:
            from randomfield_tpu.parallel.render import make_sharded_render_batch

            fn = make_sharded_render_batch(
                self.mesh, self.scene.shape, self.scene.grid_spacing,
                from_seed=self._multiprocess,
                log_values=self._table_host[2], dtype_name=str(self._dtype),
                nested=self._nested,
            )
            first = (
                np.asarray(seeds, np.uint32) if self._multiprocess else keys
            )
            lk, val = self._table_args()
            return fn(
                first, lk, val, self._mesh_sigmas(),
                self._weights(apply_lightcone),
                self._smoothing(smoothing_length),
            )
        return _render_batch(
            keys, self.state.sigmas, self._weights(apply_lightcone),
            jnp.asarray(smoothing_length, self._dtype),
            self.scene.shape, self.scene.grid_spacing,
            nested=self._nested,
        )

    def generate_nongaussian_field(self, seed, fnl, kind="field",
                                   smoothing_length=0.0):
        """Local-f_NL non-Gaussian realization (models/nongaussian.py).

        ``kind='field'``: delta = g + f_NL (g^2 - <g^2>) on this
        scene's Gaussian render; ``kind='potential'``: f_NL applied to
        the Bardeen-sign linear potential (the standard cosmological
        local model, squeezed-limit enhanced).  f_NL = 0 recovers
        ``generate_delta_field(seed)`` exactly.  Gate with
        :meth:`calculate_bispectrum` vs :meth:`predicted_ng_bispectrum`.
        """
        from randomfield_tpu.models import nongaussian as _ng

        return _ng.generate_local_ng_field(
            self, seed, fnl, kind=kind, smoothing_length=smoothing_length
        )

    def sample_power(self, seed=0, smoothing_length=0.0, nbins=32):
        """Realized binned P(k) of seed's spectrum — WITHOUT any FFT.

        The sampled packed spectrum c_k already determines the
        realization's power (P_hat = |c_k|^2 V); binning it directly
        skips both the inverse render and the forward estimate, making
        P(k)/covariance ensembles (BASELINE config 4) cheap at sizes
        where fields barely fit in HBM.  Identical statistics to
        ``calculate_power(generate_delta_field(seed))`` up to transform
        rounding.
        """
        from randomfield_tpu.validate import stats

        if self.mesh is not None:
            # distributed config-4 path: sharded sampling (identical
            # Threefry draws) + shard-local binning + psum — no FFT, no
            # gather (parallel/render.py:make_sharded_spectrum_bins)
            from randomfield_tpu.parallel.multihost import replicated_to_host
            from randomfield_tpu.parallel.render import make_sharded_spectrum_bins

            fn = make_sharded_spectrum_bins(
                self.mesh, self.scene.shape, self.scene.grid_spacing,
                int(nbins), from_seed=self._multiprocess,
                log_values=self._table_host[2], dtype_name=str(self._dtype),
            )
            lk, val = self._table_args()
            counts, psum, ksum = fn(
                self._seed_u32(seed) if self._multiprocess else _as_key(seed),
                lk, val, self._mesh_sigmas(),
                self._smoothing(smoothing_length),
            )
            counts = replicated_to_host(counts).astype(np.float64)
            psum = replicated_to_host(psum).astype(np.float64)
            ksum = replicated_to_host(ksum).astype(np.float64)
            with np.errstate(invalid="ignore", divide="ignore"):
                return ksum / counts, psum / counts, counts

        sm = jnp.asarray(smoothing_length, self._dtype)
        c = self._sampled_spectrum(seed, sm)
        return stats.spectrum_power(
            c, self.scene.shape, self.scene.grid_spacing, nbins, self._layout
        )

    def sample_power_batch(self, seeds, smoothing_length=0.0, nbins=32):
        """:meth:`sample_power` for a seed batch, one program when possible.

        Loops :meth:`sample_power` over the seeds.  Returns host float64
        ``(k_mean, p_hat[nseeds, nbins], n_modes)`` in ``seeds`` order
        (k_mean/n_modes are seed-independent).
        """
        seeds_list = [int(s) for s in np.asarray(seeds).ravel()]
        ks = ms = None
        rows = []
        for s in seeds_list:
            k, p, m = self.sample_power(
                s, smoothing_length=smoothing_length, nbins=nbins
            )
            ks, ms = k, m
            rows.append(p)
        return ks, np.asarray(rows), ms

    def _sampled_spectrum(self, seed, sm):
        """The seed's packed spectrum c_k (device, ``self._layout``)."""
        if self.mesh is not None:
            raise ValueError(
                "mesh scenes never materialize a full spectrum; "
                "sample_power and the derived-field generators run "
                "their own sharded programs"
            )
        if self.pipeline == "staged":
            from randomfield_tpu.engine.staged import _stage_p1
            from randomfield_tpu.ops.grid import kvectors

            p1 = _stage_p1(self.scene.shape, self.scene.grid_spacing,
                           str(self._dtype))
            kx, ky, kz = kvectors(self.scene.shape, self.scene.grid_spacing,
                                  self._dtype)
            return p1(_as_key(seed), self.sigmas, sm, kx, kz, ky)
        return _sample_spectrum_jit(
            _as_key(seed), self.state.sigmas, sm,
            self.scene.shape, self.scene.grid_spacing,
            nested=self._nested,
        )

    # ---- derived fields (seed-direct: no forward FFT) -----------------------
    def _derived_from_kernel(self, seed, kind, component, prefactor,
                             smoothing_length, c=None):
        """sample -> fused spectral kernel -> inverse pipeline.

        Works at every size the plain render supports — including the
        HBM ceiling, where the field-first path (ops/derived.py
        delta_to_*) cannot hold the forward transform's intermediates.
        Snapshot fields: no lightcone weighting (z enters the kernel).
        """
        from randomfield_tpu.engine.staged import finish_staged

        if self.mesh is not None:
            # mesh-native: the elementwise kernel fuses into the sharded
            # sampled-spectrum program before the distributed inverse
            # transform (parallel/render.py:make_sharded_derived)
            from randomfield_tpu.parallel.render import make_sharded_derived

            fn = make_sharded_derived(
                self.mesh, self.scene.shape, self.scene.grid_spacing,
                kind, int(component), from_seed=self._multiprocess,
                log_values=self._table_host[2], dtype_name=str(self._dtype),
            )
            lk, val = self._table_args()
            if self._multiprocess:
                pref_in = np.asarray(prefactor, np.float32)
            else:
                pref_in = jnp.asarray(prefactor, self._dtype)
            return fn(
                self._seed_u32(seed) if self._multiprocess else _as_key(seed),
                lk, val, self._mesh_sigmas(), pref_in,
                self._smoothing(smoothing_length),
            )
        sm = jnp.asarray(smoothing_length, self._dtype)
        shape, sp = self.scene.shape, self.scene.grid_spacing
        pref = jnp.asarray(prefactor, self._dtype)
        if c is None:
            c = self._sampled_spectrum(seed, sm)
        if self.pipeline == "staged":
            c.block_until_ready()
            c = _apply_spectral_kernel(
                c, pref, shape, sp, self._layout, kind, component
            )
            ones = jnp.ones((self.scene.nz,), self._dtype)
            return finish_staged(
                c, ones, shape, sp, str(self._dtype)
            )
        return _finish_derived(
            c, pref, shape, sp, self._layout, kind, component
        )

    def generate_potential(self, seed=0, z=0.0, smoothing_length=0.0):
        """Dimensionless peculiar potential Phi/c^2 for a seed (snapshot).

        Same realization as ``generate_delta_field(seed)`` put through
        the comoving Poisson equation (ops/derived.py conventions) —
        but computed spectrum-side, so it works at 1024^3 on one chip.
        """
        from randomfield_tpu.ops import derived as _derived

        pref = (-1.5 * self.cosmology.Om0 * (1.0 + float(z))
                / _derived.D_H_MPC_H**2)
        return self._derived_from_kernel(
            seed, "scalar", 0, pref, smoothing_length
        )

    def generate_displacement(self, seed=0, component=None,
                              smoothing_length=0.0, order=1):
        """Lagrangian displacement psi [Mpc/h] for a seed (snapshot).

        ``order=1``: Zel'dovich (``psi_k = i k delta_k / k^2``).
        ``order=2``: 2LPT — adds the second-order correction
        ``psi(2)`` built from the SAME realization's tidal tensor
        (ops/derived.py delta_to_displacement_2lpt single-device; on
        meshes the fully distributed program parallel/render.py:
        make_sharded_displacement_2lpt — the quadratic source is a
        shard-local pointwise product of sharded tidal renders).

        ``component`` 0/1/2 returns one (nx, ny, nz) component (pass it
        at HBM-ceiling sizes: the stacked (3, ...) result needs 3x the
        field memory); None stacks all three.
        """
        if order not in (1, 2):
            raise ValueError(f"order must be 1 or 2, got {order!r}")
        psi = self._gradient_components(
            seed, 1.0, component, smoothing_length
        )
        if order == 2:
            if self.mesh is not None:
                from randomfield_tpu.parallel.render import (
                    make_sharded_displacement_2lpt,
                )

                fn = make_sharded_displacement_2lpt(
                    self.mesh, self.scene.shape, self.scene.grid_spacing,
                    from_seed=self._multiprocess,
                    log_values=self._table_host[2],
                    dtype_name=str(self._dtype),
                    component=None if component is None else int(component),
                )
                lk, val = self._table_args()
                psi2 = fn(
                    self._seed_u32(seed) if self._multiprocess
                    else _as_key(seed),
                    lk, val, self._mesh_sigmas(),
                    self._smoothing(smoothing_length),
                )
                return psi + (
                    jnp.stack(psi2) if component is None else psi2[0]
                )
            from randomfield_tpu.ops import derived as _derived

            delta = self.generate_delta_field(
                seed, smoothing_length=smoothing_length,
                apply_lightcone=False,
            )
            psi2 = _derived.delta_to_displacement_2lpt(
                delta, self.scene.grid_spacing
            )
            psi = psi + (psi2 if component is None else psi2[int(component)])
        return psi

    def _gradient_components(self, seed, prefactor, component,
                             smoothing_length):
        comps = range(3) if component is None else [int(component)]
        c0 = None
        if self.pipeline != "staged" and self.mesh is None and len(comps) > 1:
            # below the ceiling: sample ONCE and feed each donated kernel
            # call a copy (a copy is one memory pass; resampling is a
            # full PRNG + symmetrize pass per component)
            sm = jnp.asarray(smoothing_length, self._dtype)
            c0 = self._sampled_spectrum(seed, sm)
        out = [
            self._derived_from_kernel(
                seed, "grad", i, prefactor, smoothing_length,
                c=None if c0 is None else jnp.copy(c0),
            )
            for i in comps
        ]
        return out[0] if component is not None else jnp.stack(out)

    def generate_tidal_field(self, seed=0, component=None,
                             smoothing_length=0.0):
        """Tidal (T-web) tensor T_ij = d_i d_j phi, grad^2 phi = delta.

        Seed-direct like the other derived fields (no forward FFT;
        works at the HBM ceiling and on slab/pencil meshes).
        ``component`` indexes ops/derived.py:TIDAL_PAIRS (xx, yy, zz,
        xy, xz, yz); None stacks all six as (6, nx, ny, nz) — pass a
        single component at large sizes.  The diagonal sums to the
        seed's density field exactly; classify the stacked result with
        randomfield_tpu.models.web.classify_web.
        """
        comps = range(6) if component is None else [int(component)]
        c0 = None
        if self.pipeline != "staged" and self.mesh is None and len(comps) > 1:
            sm = jnp.asarray(smoothing_length, self._dtype)
            c0 = self._sampled_spectrum(seed, sm)
        out = [
            self._derived_from_kernel(
                seed, "tidal", i, 1.0, smoothing_length,
                c=None if c0 is None else jnp.copy(c0),
            )
            for i in comps
        ]
        return out[0] if component is not None else jnp.stack(out)

    def classify_web(self, seed=0, smoothing_length=0.0, threshold=0.0):
        """Per-voxel T-web class of a realization: 0..3 = void / sheet /
        filament / knot (count of tidal eigenvalues above ``threshold``).

        Renders the six tidal components seed-direct and classifies on
        device (models/web.py); ``smoothing_length`` sets the scale the
        web is defined at (classification on unsmoothed fields is
        Nyquist-noise dominated).
        """
        from randomfield_tpu.models import web as _web

        t = self.generate_tidal_field(seed, smoothing_length=smoothing_length)
        return _web.classify_web(t, threshold)

    def generate_velocity(self, seed=0, z=0.0, component=None,
                          smoothing_length=0.0):
        """Linear peculiar velocity [km/s] for a seed (snapshot):
        v = a H(a) f(a) psi (ops/derived.py conventions)."""
        a = 1.0 / (1.0 + float(z))
        H = self.cosmology.H0 * float(self.cosmology.efunc(float(z)))
        f = float(self.cosmology.growth_rate(float(z)))
        pref = a * H * f / self.cosmology.h
        return self._gradient_components(
            seed, pref, component, smoothing_length
        )

    def _kaiser_bf(self, z, bias, f):
        b = float(bias)
        if b == 0.0:
            raise ValueError("bias must be nonzero for a Kaiser field")
        if f is None:
            f = self.cosmology.growth_rate(float(z))
        return b, float(f)

    def generate_kaiser_field(self, seed=0, z=0.0, bias=1.0, f=None,
                              los_axis=2, smoothing_length=0.0):
        """Linear redshift-space density field (b + f mu^2) delta_k.

        The plane-parallel Kaiser (1987) distortion applied in the
        spectrum — the same realization as ``generate_delta_field(seed,
        apply_lightcone=False)`` boosted per mode by ``b + f mu^2`` with
        ``mu = k_los / |k|`` along physical axis ``los_axis`` and
        ``f`` the logarithmic growth rate (default
        ``cosmology.growth_rate(z)``).  Its multipoles follow the
        textbook ``P_0 = (b^2 + 2bf/3 + f^2/5) P`` family; measure them
        with ``validate.stats.calculate_power_multipoles`` and compare
        against the exactly binned :meth:`predicted_kaiser_multipoles`.
        Seed-direct like the other derived fields (no forward FFT;
        works at the HBM ceiling and on slab/pencil meshes).  Snapshot
        convention: no lightcone weighting (redshift enters only
        through f).
        """
        b, fv = self._kaiser_bf(z, bias, f)
        return self._derived_from_kernel(
            seed, "kaiser", int(los_axis), (b, fv), smoothing_length
        )
