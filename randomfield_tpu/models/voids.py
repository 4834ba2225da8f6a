"""Spherical-underdensity void finding and void statistics.

Voids — large underdense regions — are the density troughs whose
abundance and sizes probe growth and dark energy complementarily to
peaks and halos.  This module implements the standard
spherical-underdensity (SO) definition the accelerator-friendly way: instead of
growing spheres around candidate centers one by one (data-dependent
loops), the mean ENCLOSED density contrast at every voxel for a ladder
of radii comes from FFT top-hat convolutions — one elementwise spectral
multiply + inverse transform per radius, all jitted — and the void
radius field is the running ladder maximum

    R_v(x) = largest R with delta_bar(<R'; x) < threshold
             for every ladder radius R' <= R,

evaluated with pure `lax` arithmetic.  Only the final (tiny) catalog
compaction — local maxima of R_v, greedy non-overlap — runs on host,
mirroring models/halos.py's device-intensity/host-compaction split.

Gates (tests/test_voids.py): a PLANTED spherical underdensity is
recovered deterministically (center exact, radius within one ladder
step of the analytic dilution radius (amp/|t|)^(1/3) R_0); the
underdense volume fraction of Gaussian renders matches the exact
normal-CDF expectation Phi(t sigma0 / sigma_R) with sigma_R the
exact DISCRETE top-hat-filtered sigma on this grid's modes; the
catalog is non-overlapping by construction; and lattice minima counts
equal peak counts of the negated field exactly (validate/peaks.py
symmetry).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from randomfield_tpu.ops import grid as _grid
from randomfield_tpu.ops import transform as _transform

__all__ = [
    "tophat_smooth",
    "void_radius_grid",
    "find_voids",
    "void_size_function",
    "predicted_underdense_fraction",
    "underdense_fraction",
    "minima_statistics",
]


def _tophat_w(x):
    """Spherical top-hat window W(x) = 3 (sin x - x cos x) / x^3, W(0)=1.

    Evaluated in a numerically safe form (series below x = 1e-3).
    """
    x = jnp.asarray(x)
    safe = jnp.where(x > 1e-3, x, 1.0)
    w = 3.0 * (jnp.sin(safe) - safe * jnp.cos(safe)) / safe**3
    return jnp.where(x > 1e-3, w, 1.0 - x * x / 10.0)


@functools.partial(jax.jit, static_argnames=("shape", "spacing", "radius"))
def _tophat_smooth_jit(delta, shape, spacing, radius):
    # field_to_spectrum / spectrum_to_field are a physical-convention
    # round-trip pair (ops/transform.py), so the window multiply is the
    # whole convolution
    c = _transform.field_to_spectrum(delta, spacing)
    km = _grid.kmag(shape, spacing, jnp.float32)
    c = c * _tophat_w(km * jnp.asarray(radius, jnp.float32))
    return _transform.spectrum_to_field(c, spacing, shape)


def tophat_smooth(delta, spacing, radius):
    """Mean enclosed density contrast delta_bar(< radius) at every voxel
    (FFT convolution with the spherical top-hat of that radius)."""
    shape = tuple(int(s) for s in delta.shape[-3:])
    return _tophat_smooth_jit(delta, shape, float(spacing), float(radius))


@functools.partial(jax.jit, static_argnames=("shape", "spacing", "radii",
                                             "threshold"))
def _void_radius_jit(delta, shape, spacing, radii, threshold):
    c0 = _transform.field_to_spectrum(delta, spacing)
    km = _grid.kmag(shape, spacing, jnp.float32)
    t = jnp.asarray(threshold, delta.dtype)
    rv = jnp.zeros(shape, delta.dtype)
    alive = jnp.ones(shape, bool)
    for r in radii:  # static ladder: unrolled, one irfftn per rung
        sm = _transform.spectrum_to_field(
            c0 * _tophat_w(km * jnp.asarray(r, jnp.float32)), spacing, shape)
        alive = alive & (sm < t)
        rv = jnp.where(alive, jnp.asarray(r, rv.dtype), rv)
    return rv


@functools.lru_cache(maxsize=16)
def _make_mesh_void_radius(mesh, shape, spacing, radii, threshold):
    """Distributed R_v grid: sharded forward -> one sharded inverse per
    ladder rung -> elementwise running maximum.  Slab + pencil meshes
    (the same FFT-ladder machinery as the mesh xi/bispectrum
    estimators; parallel/render.py:_inverse)."""
    from randomfield_tpu.models.constrained import _forward_mesh
    from randomfield_tpu.parallel.render import _inverse, _mesh_specs

    nx, ny, nz = shape

    @jax.jit
    def fn(delta):
        _, spec_sharding, _ = _mesh_specs(mesh, batched=False)
        c0 = _forward_mesh(delta, shape, mesh, delta.dtype)  # rfftn / N
        km = _grid.kmag(shape, spacing, jnp.float32)
        t = jnp.asarray(threshold, delta.dtype)
        rv = jnp.zeros(shape, delta.dtype)
        alive = jnp.ones(shape, bool)
        for r in radii:
            ck = c0 * _tophat_w(km * jnp.asarray(r, jnp.float32))
            ck = jax.lax.with_sharding_constraint(ck, spec_sharding)
            sm = _inverse(ck, shape, mesh, False)
            alive = alive & (sm < t)
            rv = jnp.where(alive, jnp.asarray(r, rv.dtype), rv)
        return rv

    return fn


def void_radius_grid(delta, spacing, radii, threshold=-0.4, mesh=None):
    """SO void radius at every voxel: the largest ladder radius R such
    that the enclosed mean contrast stays below ``threshold`` for every
    ladder rung up to R (0 where even the smallest rung fails).

    ``radii``: ascending ladder in the same length units as
    ``spacing``.  One FFT per rung; the ladder is compiled statically.
    With ``mesh`` (slab or pencil) the forward transform and every
    ladder rung run distributed; the result stays sharded like a
    rendered field.
    """
    shape = tuple(int(s) for s in delta.shape[-3:])
    radii = tuple(float(r) for r in radii)
    if any(b <= a for a, b in zip(radii, radii[1:])) or not radii:
        raise ValueError("radii must be a non-empty ascending ladder")
    if threshold >= 0:
        raise ValueError("void threshold must be negative")
    if mesh is not None:
        fn = _make_mesh_void_radius(
            mesh, shape, float(spacing), radii, float(threshold)
        )
        return fn(jnp.asarray(delta))
    return _void_radius_jit(delta, shape, float(spacing), radii,
                            float(threshold))


def _greedy_accept(cand, rv_c, shape, spacing):
    """Greedy non-overlap acceptance in descending R_v (host, tiny).

    ``cand``: (n, 3) integer voxel indices; ties in R_v break by
    lexicographic voxel order (identical to the original argwhere +
    stable-sort behavior)."""
    order = np.lexsort((cand[:, 2], cand[:, 1], cand[:, 0], -rv_c))
    cand = cand[order]
    rv_c = rv_c[order]
    pos = (cand + 0.5) * spacing
    box = np.asarray(shape, np.float64) * spacing
    acc_pos = np.empty((0, 3))
    acc_r = np.empty(0)
    for i in range(pos.shape[0]):
        if acc_pos.shape[0]:
            dvec = np.abs(acc_pos - pos[i])
            dvec = np.minimum(dvec, box - dvec)
            dist = np.sqrt((dvec**2).sum(axis=1))
            if np.any(dist < acc_r):  # center inside an accepted void
                continue
        acc_pos = np.concatenate([acc_pos, pos[i:i + 1]])
        acc_r = np.concatenate([acc_r, rv_c[i:i + 1]])
    return acc_pos, acc_r


@functools.lru_cache(maxsize=16)
def _make_mesh_void_candidates(mesh, shape, budget):
    """Sharded candidate compaction: 27-cube local maxima of R_v with a
    per-shard top-k budget — only (budget, 4) scalars per shard ever
    leave the devices, never a field.  The 6 separable rolled-max
    passes lower to GSPMD halo exchanges (validate/peaks.py pattern).
    """
    from jax.sharding import PartitionSpec as P

    from randomfield_tpu.parallel import pencil as _pencil
    from randomfield_tpu.parallel.mesh import SPACE_AXIS

    nx, ny, nz = shape
    is_pencil = _pencil.is_pencil_mesh(mesh)
    if is_pencil:
        px = mesh.shape[_pencil.SPX_AXIS]
        py = mesh.shape[_pencil.SPY_AXIS]
        nx_loc, ny_loc = nx // px, ny // py
        in_spec = P(_pencil.SPX_AXIS, _pencil.SPY_AXIS, None)
        out_lead = P(_pencil.SPX_AXIS, _pencil.SPY_AXIS)
    else:
        n_space = mesh.shape[SPACE_AXIS]
        nx_loc, ny_loc = nx // n_space, ny
        in_spec = P(SPACE_AXIS, None, None)
        out_lead = P(SPACE_AXIS)
    budget = min(int(budget), nx_loc * ny_loc * nz)

    gather_axes = ((_pencil.SPX_AXIS, _pencil.SPY_AXIS) if is_pencil
                   else (SPACE_AXIS,))

    def _local(key_l, rv_l):
        jx = (jax.lax.axis_index(_pencil.SPX_AXIS) if is_pencil
              else jax.lax.axis_index(SPACE_AXIS))
        x_off = jx * nx_loc
        y_off = (jax.lax.axis_index(_pencil.SPY_AXIS) * ny_loc
                 if is_pencil else jnp.int32(0))
        flat = key_l.reshape(-1)
        mask = flat > -jnp.inf
        n_cand = jnp.sum(mask.astype(jnp.int32))
        vals, idx = jax.lax.top_k(
            jnp.where(mask, rv_l.reshape(-1), -1.0), budget
        )
        i = idx // (ny_loc * nz) + x_off
        rem = idx % (ny_loc * nz)
        j = rem // nz + y_off
        k = rem % nz
        pack = jnp.stack(
            [vals, i.astype(vals.dtype), j.astype(vals.dtype),
             k.astype(vals.dtype)], axis=-1
        )
        # replicate the (tiny) per-shard candidate packs everywhere so
        # the host read is one fully-addressable array on ANY process
        # count (multihost pods included)
        pack = jax.lax.all_gather(pack, gather_axes).reshape(-1, budget, 4)
        ncs = jax.lax.all_gather(n_cand.reshape(1), gather_axes).reshape(-1)
        return pack, ncs

    def fn(key, rv):
        return jax.shard_map(
            _local, mesh=mesh, in_specs=(in_spec, in_spec),
            out_specs=(P(), P()),
            check_vma=False,
        )(key, rv)

    return jax.jit(fn)


def _find_voids_mesh(delta, rv, shape, spacing, mesh, budget, radii):
    d = jnp.asarray(delta)
    # f32-safe lexicographic key (R_v ladder rank, then deeper delta):
    # rv takes only the ladder values, so its integer rank plus a
    # bounded strictly-decreasing function of delta in (0, 0.5) orders
    # (rv, -delta) pairs exactly — the single-device float64
    # "rv - 1e-9 delta" perturbation underflows in f32 (eps(6.0) ~ 5e-7)
    # and would turn every R_v plateau voxel into a candidate
    rank = sum(
        (rv >= jnp.asarray(r, rv.dtype)).astype(jnp.float32)
        for r in radii
    )
    key = rank + 0.25 * (1.0 - jnp.tanh(0.1 * d.astype(jnp.float32)))
    m = key
    for axi in range(3):
        m = jnp.maximum(
            m, jnp.maximum(jnp.roll(m, 1, axis=axi),
                           jnp.roll(m, -1, axis=axi))
        )
    is_max = (key >= m) & (rv > 0)   # m includes self: key == m at maxima
    # mask non-candidates to -inf so the shard-local top-k skips them
    key_m = jnp.where(is_max, key, -jnp.inf)
    from randomfield_tpu.parallel.multihost import replicated_to_host

    fn = _make_mesh_void_candidates(mesh, shape, int(budget))
    pack, n_cand = fn(key_m, rv)
    pack = np.asarray(replicated_to_host(pack)).reshape(-1, 4)
    n_cand = np.asarray(replicated_to_host(n_cand)).reshape(-1)
    if (n_cand > budget).any():
        raise ValueError(
            f"a shard found {int(n_cand.max())} void candidates, over "
            f"the compaction budget {budget}; raise candidate_budget"
        )
    good = pack[:, 0] > 0
    if not good.any():
        return np.zeros((0, 3)), np.zeros(0)
    cand = pack[good, 1:].astype(np.int64).astype(np.float64)
    rv_c = pack[good, 0].astype(np.float64)
    return _greedy_accept(cand, rv_c, shape, float(spacing))


def find_voids(delta, spacing, radii, threshold=-0.4, mesh=None,
               candidate_budget=8192):
    """Non-overlapping SO void catalog.

    Candidates are voxels whose R_v is a 27-cube local maximum with
    R_v > 0 and whose own density is a local minimum of the R_v-selected
    smoothed hierarchy (in practice: R_v local max suffices — ties
    broken toward deeper delta).  Candidates are accepted greedily in
    descending R_v, rejecting any center inside an accepted void
    (periodic minimum-image).  Returns ``(positions, radii_v)`` —
    (n, 3) voxel-center coordinates and radii, host float64.

    With ``mesh`` (slab or pencil) the whole field-intensity side runs
    distributed — the R_v ladder's transforms, the 27-cube maximum
    (GSPMD halo exchanges), and a per-shard top-k compaction capped at
    ``candidate_budget`` candidates per shard — so only the (tiny)
    candidate list ever reaches the host, never a gathered field.  The
    catalog equals the single-device one (same tie-breaking; asserted
    in tests/test_voids.py).
    """
    shape = tuple(int(s) for s in delta.shape[-3:])
    spacing = float(spacing)
    if mesh is not None:
        rv = void_radius_grid(delta, spacing, radii, threshold, mesh=mesh)
        return _find_voids_mesh(delta, rv, shape, spacing, mesh,
                                candidate_budget,
                                tuple(float(r) for r in radii))
    rv = np.asarray(void_radius_grid(delta, spacing, radii, threshold),
                    np.float64)
    d = np.asarray(delta, np.float64)
    # 27-cube local maximum of rv (strict against a deterministic
    # tie-breaker: deeper delta wins inside plateaus)
    key = rv - 1e-9 * d  # deeper (more negative) delta => larger key
    neigh_max = np.full_like(key, -np.inf)
    for sx in (-1, 0, 1):
        for sy in (-1, 0, 1):
            for sz in (-1, 0, 1):
                if sx == sy == sz == 0:
                    continue
                np.maximum(
                    neigh_max,
                    np.roll(np.roll(np.roll(key, sx, 0), sy, 1), sz, 2),
                    out=neigh_max)
    cand = np.argwhere((key > neigh_max) & (rv > 0))
    if cand.size == 0:
        return np.zeros((0, 3)), np.zeros(0)
    rv_c = rv[tuple(cand.T)]
    return _greedy_accept(cand.astype(np.float64), rv_c, shape, spacing)


def void_size_function(radii_v, box_volume, edges):
    """dn/dlnR from a void catalog: counts in ``edges`` (radius bins)
    divided by box volume and dlnR.  Returns ``(r_centers, dndlnr,
    counts)``."""
    edges = np.asarray(edges, np.float64)
    counts, _ = np.histogram(np.asarray(radii_v, np.float64), bins=edges)
    dlnr = np.diff(np.log(edges))
    centers = np.sqrt(edges[:-1] * edges[1:])
    return centers, counts / (float(box_volume) * dlnr), counts


def _discrete_sigma_r(power, shape, spacing, radius, interpolation):
    """Exact top-hat-filtered sigma on this grid's discrete modes."""
    from randomfield_tpu.ops import power as _power

    table = _power.validate_power(power)
    _power.require_coverage(table, shape, spacing)
    km = np.asarray(_grid.kmag(shape, spacing, jnp.float32), np.float64)
    pg = np.asarray(_power.interpolate_power(
        table, jnp.asarray(km, jnp.float32), interpolation), np.float64)
    pg[km == 0] = 0.0
    x = km * float(radius)
    with np.errstate(invalid="ignore", divide="ignore"):
        w = np.where(x > 1e-3,
                     3.0 * (np.sin(x) - x * np.cos(x)) / np.maximum(x, 1e-3)**3,
                     1.0 - x * x / 10.0)
    nz = shape[2]
    nzh = nz // 2 + 1
    mult = np.full(nzh, 2.0)
    mult[0] = 1.0
    if nz % 2 == 0:
        mult[-1] = 1.0
    volume = shape[0] * shape[1] * shape[2] * float(spacing) ** 3
    var = np.sum(mult[None, None, :] * w**2 * pg) / volume
    return float(np.sqrt(var))


def predicted_underdense_fraction(power, shape, spacing, radius,
                                  threshold, interpolation="log10k"):
    """EXACT expected volume fraction with delta_bar(<radius) <
    threshold for a Gaussian field: Phi(threshold / sigma_R), sigma_R
    the exact discrete top-hat-filtered rms on this grid's modes (the
    marginal of each voxel of the smoothed field is N(0, sigma_R^2))."""
    s = _discrete_sigma_r(power, tuple(int(x) for x in shape),
                          float(spacing), float(radius), interpolation)
    from math import erf, sqrt

    return 0.5 * (1.0 + erf(float(threshold) / s / sqrt(2.0)))


def underdense_fraction(delta, spacing, radius, threshold):
    """Measured volume fraction with delta_bar(<radius) < threshold."""
    sm = tophat_smooth(delta, spacing, radius)
    return float(jnp.mean((sm < jnp.asarray(threshold, sm.dtype)).astype(
        jnp.float32)))


def minima_statistics(delta, spacing, nbins=14, nu_min=-5.0, nu_max=2.0,
                      sigma0=None, mesh=None):
    """Lattice minima counts binned by depth nu = delta/sigma0.

    By the Gaussian field's sign symmetry this is exactly
    validate/peaks.py:peak_statistics of ``-delta`` with reflected
    bins; BBKS expectations apply with nu -> -nu
    (peaks.bbks_expected_counts on the reflected edges).  Returns
    ``(nu_centers, counts, total)`` with centers ascending in nu.
    """
    from randomfield_tpu.validate.peaks import peak_statistics

    centers, counts, total = peak_statistics(
        -jnp.asarray(delta), spacing, nbins=nbins, nu_min=-float(nu_max),
        nu_max=-float(nu_min), sigma0=sigma0, mesh=mesh)
    return -centers[::-1], counts[::-1], total
