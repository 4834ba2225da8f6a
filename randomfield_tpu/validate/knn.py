"""k-nearest-neighbour CDFs of tracer catalogs, with exact random gates.

The kNN-CDF (Banerjee & Abel 2021) is the CDF of the distance from
volume-filling query points to their k-th nearest tracer — a summary
that is sensitive to ALL connected N-point functions at once (the void
probability function is its k=1, large-r tail) and has become a
standard beyond-P(k) statistic for galaxy surveys.

Design: instead of per-query nearest-neighbour searches
(tree traversals — hostile to matmul units and to static shapes), use the
counting identity

    P(d_k <= r) = P(N(< r) >= k)

— the k-th neighbour is within r iff at least k tracers are.  With
query points on every grid cell, ``N(< r)`` at EVERY cell is one FFT
circular convolution of the NGP count grid with the exact lattice-ball
indicator (periodic minimum image), so a ladder of radii is a ladder
of spectrum multiplies against one cached forward transform — the same
static-shapes pattern as the void finder (models/voids.py).  Counts
are integers, so the convolution is rounded to the nearest integer and
the CDF evaluation is EXACT (no float threshold ambiguity).

Exactness: for ``n`` tracers thrown uniformly at random onto the M
lattice cells (each independently; NGP counts), ``N(< r)`` at any query
cell is Binomial(n, m(r)/M) with ``m(r)`` the lattice-ball cell count —
so ``E[CDF_k(r)] = 1 - BinomialCDF(k-1; n, m(r)/M)`` exactly, on the
same lattice balls the estimator counts with
(:func:`random_knn_cdf`).  Clustered catalogs have no closed form; the
gates there are the exact small-grid brute-force parity and the
clustering inequality (clustering empties space: CDF_1 drops below the
random curve at fixed r).

Reference: the reference package has no catalog statistics at all
(SURVEY.md section 0).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from randomfield_tpu.ops import transform as _transform

__all__ = [
    "lattice_ball_sizes",
    "count_in_spheres",
    "knn_cdf",
    "knn_cdf_positions",
    "random_knn_cdf",
]


def _min_image_ax(n, spacing):
    return np.minimum(np.arange(n), n - np.arange(n)) * float(spacing)


def _ball_indicator(shape, spacing, radius):
    """Exact periodic lattice-ball membership indicator (host float64)."""
    ax = [_min_image_ax(n, spacing) for n in shape]
    r2 = (
        (ax[0] ** 2)[:, None, None]
        + (ax[1] ** 2)[None, :, None]
        + (ax[2] ** 2)[None, None, :]
    )
    return (r2 <= float(radius) ** 2 + 1e-9 * float(spacing) ** 2)


def lattice_ball_sizes(shape, spacing, radii):
    """Number of lattice cells in the periodic ball of each radius."""
    shape = tuple(int(s) for s in shape)
    return np.array([
        int(_ball_indicator(shape, spacing, r).sum()) for r in radii
    ])


@functools.partial(
    jax.jit, static_argnames=("shape", "spacing", "radii", "ks")
)
def _knn_jit(counts, shape, spacing, radii, ks):
    ck = _transform.field_to_spectrum(counts, spacing)
    scale = jnp.asarray(1.0 / spacing**3, ck.dtype)
    ncells = shape[0] * shape[1] * shape[2]
    rows = []
    for r in radii:
        kern = jnp.asarray(
            _ball_indicator(shape, spacing, r), counts.dtype
        )
        kk = _transform.field_to_spectrum(kern, spacing)
        n_r = jnp.round(
            _transform.spectrum_to_field(ck * kk * scale, spacing, shape)
        )
        rows.append(
            jnp.stack([
                jnp.sum((n_r >= k).astype(jnp.float32)) / ncells
                for k in ks
            ])
        )
    return jnp.stack(rows, axis=1)  # (len(ks), len(radii))


def count_in_spheres(counts, spacing, radius):
    """Integer tracer count within ``radius`` of every cell (periodic
    lattice ball, one FFT convolution, rounded to exact integers)."""
    shape = tuple(int(s) for s in counts.shape[-3:])
    counts = jnp.asarray(counts, jnp.float32)
    ck = _transform.field_to_spectrum(counts, float(spacing))
    kern = jnp.asarray(
        _ball_indicator(shape, float(spacing), radius), jnp.float32
    )
    kk = _transform.field_to_spectrum(kern, float(spacing))
    scale = jnp.asarray(1.0 / float(spacing) ** 3, ck.dtype)
    return jnp.round(
        _transform.spectrum_to_field(ck * kk * scale, float(spacing), shape)
    )


@functools.lru_cache(maxsize=16)
def _make_mesh_knn(mesh, shape, spacing, radii, ks):
    """Distributed kNN-CDF: sharded forward of the count grid, one
    sharded kernel forward + product inverse per ladder radius, GSPMD
    tail-fraction reductions.  The lattice-ball indicator is built
    in-program from 1-D minimum-image axes (broadcast iota — shards
    like any field; no host-side N^3 grid exists).  Slab + pencil."""
    from randomfield_tpu.models.constrained import _forward_mesh
    from randomfield_tpu.parallel.render import _inverse, _mesh_specs

    nx, ny, nz = shape
    ncells = nx * ny * nz
    ax = [jnp.asarray(_min_image_ax(n, spacing), jnp.float32)
          for n in shape]
    eps = 1e-9 * float(spacing) ** 2

    @jax.jit
    def fn(counts):
        _, spec_sharding, out_sharding = _mesh_specs(mesh, batched=False)
        counts = jax.lax.with_sharding_constraint(counts, out_sharding)
        c = _forward_mesh(counts, shape, mesh, jnp.float32)  # rfftn / N
        c = jax.lax.with_sharding_constraint(c, spec_sharding)
        r2 = (
            (ax[0] ** 2)[:, None, None]
            + (ax[1] ** 2)[None, :, None]
            + (ax[2] ** 2)[None, None, :]
        )
        rows = []
        for r in radii:
            kern = (r2 <= r * r + eps).astype(jnp.float32)
            kern = jax.lax.with_sharding_constraint(kern, out_sharding)
            kk = _forward_mesh(kern, shape, mesh, jnp.float32)
            prod = c * kk * jnp.asarray(float(ncells), jnp.complex64)
            prod = jax.lax.with_sharding_constraint(prod, spec_sharding)
            n_r = jnp.round(_inverse(prod, shape, mesh, False))
            rows.append(jnp.stack([
                jnp.sum((n_r >= k).astype(jnp.float32)) / ncells
                for k in ks
            ]))
        return jnp.stack(rows, axis=1)

    return fn


def knn_cdf(counts, spacing, radii, ks=(1, 2, 3), mesh=None):
    """kNN-CDFs from an NGP tracer count grid.

    ``CDF_k(r) = P(N(< r) >= k)`` over every lattice cell as query
    point.  ``radii`` in Mpc/h; returns an array shaped
    ``(len(ks), len(radii))``.  Exact-expectation companion for random
    catalogs: :func:`random_knn_cdf`.  One forward FFT + one kernel
    forward + one inverse per radius; with ``mesh`` (slab or pencil)
    every transform runs distributed and nothing field-sized is
    gathered (the integer-rounded counting identity keeps the mesh
    estimate exactly equal to the single-device one).
    """
    shape = tuple(int(s) for s in counts.shape[-3:])
    radii = tuple(float(r) for r in radii)
    ks = tuple(int(k) for k in ks)
    if any(k < 1 for k in ks):
        raise ValueError(f"ks must be >= 1, got {ks}")
    if mesh is not None:
        from randomfield_tpu.parallel.multihost import replicated_to_host

        fn = _make_mesh_knn(mesh, shape, float(spacing), radii, ks)
        out = replicated_to_host(fn(jnp.asarray(counts, jnp.float32)))
        return np.asarray(out, np.float64)
    out = _knn_jit(
        jnp.asarray(counts, jnp.float32), shape, float(spacing), radii, ks
    )
    return np.asarray(out, np.float64)


def knn_cdf_positions(positions, shape, spacing, radii, ks=(1, 2, 3),
                      mesh=None):
    """kNN-CDFs from tracer positions (NGP-painted, periodic box).

    With ``mesh`` the catalog paints through the sharded NGP painter
    (parallel/paint.py — host pre-bins by block owner, two-sweep halo
    exchange) and the CDF ladder runs distributed; counts recovered
    exactly from the contrast grid (integer weights), so the result
    equals the single-device estimate."""
    shape = tuple(int(s) for s in shape)
    if mesh is not None:
        import numpy as _np

        from randomfield_tpu.parallel.paint import paint_sharded

        delta, w_mean = paint_sharded(
            _np.asarray(positions), shape, float(spacing), mesh,
            window="ngp",
        )
        counts = jnp.round((delta + 1.0) * w_mean)
        return knn_cdf(counts, spacing, radii, ks, mesh=mesh)
    from randomfield_tpu.models.zeldovich import _paint

    positions = jnp.asarray(positions)
    if positions.shape[0] != 3:
        raise ValueError(
            f"positions must be (3, ...), got {positions.shape}"
        )
    weights = jnp.ones(positions.shape[1:], positions.dtype)
    counts = _paint(positions, weights, shape, float(spacing), 1)
    return knn_cdf(counts, spacing, radii, ks)


def _log_binom_cdf_tail(kmax, n, p):
    """log-stable Binomial P(N <= kmax) for small kmax (host float64)."""
    if p >= 1.0:
        return 0.0 if kmax < n else 1.0
    if p <= 0.0:
        return 1.0
    total = 0.0
    log1mp = np.log1p(-p)
    logp = np.log(p)
    for j in range(int(kmax) + 1):
        logc = (
            np.sum(np.log(np.arange(n - j + 1, n + 1)))
            - np.sum(np.log(np.arange(1, j + 1)))
        )
        total += np.exp(logc + j * logp + (n - j) * log1mp)
    return min(total, 1.0)


def random_knn_cdf(n_tracers, shape, spacing, radii, ks=(1, 2, 3)):
    """EXACT expected kNN-CDFs of a uniform random lattice catalog.

    ``n_tracers`` points thrown independently and uniformly over the M
    cells give ``N(< r) ~ Binomial(n, m(r)/M)`` at every query cell
    with ``m(r)`` the same lattice-ball size the estimator convolves
    with, so ``E[CDF_k(r)] = 1 - BinomCDF(k-1; n, m(r)/M)`` with no
    continuum or Poisson approximation.  (The Poisson form
    ``1 - GammaInc`` is the n -> inf limit.)  Shapes match
    :func:`knn_cdf`.
    """
    shape = tuple(int(s) for s in shape)
    m = lattice_ball_sizes(shape, spacing, radii)
    M = shape[0] * shape[1] * shape[2]
    n = int(n_tracers)
    ks = tuple(int(k) for k in ks)
    out = np.empty((len(ks), len(radii)), np.float64)
    for j, mj in enumerate(m):
        p = mj / M
        for i, k in enumerate(ks):
            out[i, j] = 1.0 - _log_binom_cdf_tail(k - 1, n, p)
    return out
