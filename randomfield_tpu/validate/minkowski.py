"""Minkowski functionals V0..V3 with exact Gaussian expectations.

Morphology is the third classic validation axis after two-point
statistics and one-point moments (the reference validates only the
latter two — SURVEY.md section 3.5; this module is capability the new
framework adds on top).  The four 3-D Minkowski functional densities

    v0 = volume fraction of the excursion set {u >= nu}
    v1 = surface area / 6
    v2 = integrated mean curvature / (6 pi)
    v3 = integrated Gaussian curvature / (4 pi)   (Euler characteristic)

have closed-form expectations for a Gaussian random field (Tomita 1986;
Schmalzing & Buchert 1997) that depend ONLY on the spectral moments
sigma0^2 = <f^2> and sigma1^2 = <|grad f|^2>:

    v0(nu) = erfc(nu / sqrt(2)) / 2
    v_k(nu) = (lam)^k (w3 / (w_{3-k} w_k)) H_{k-1}(nu)
              exp(-nu^2/2) / (2 pi)^{(k+1)/2},   k = 1, 2, 3

with lam = sigma1 / (sqrt(3) sigma0), w_k the unit-ball volumes
(w0, w1, w2, w3) = (1, 2, pi, 4 pi/3) and Hermite H_0 = 1, H_1 = nu,
H_2 = nu^2 - 1.  Because the measurement below differentiates
SPECTRALLY (exact for the band-limited field) and the prediction
computes sigma0/sigma1 from the same discrete modes with the same
Nyquist-zeroed gradient vectors, measured-vs-predicted residuals are
pure sample noise plus the O(dnu^2) threshold-binning bias — no lattice
discretization systematics (the usual plague of Crofton-type counting
estimators).

Design: one forward transform + nine spectral-kernel
inverses build (grad u, Hessian u); the Koenderink curvature invariants
are pointwise; the delta(u - nu) threshold binning is the same one-hot
matmul contraction as every other estimator here (scatter-add
serializes colliding updates).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from randomfield_tpu.ops import derived as _derived
from randomfield_tpu.ops import grid as _grid
from randomfield_tpu.ops import power as _power
from randomfield_tpu.ops import transform as _transform

__all__ = [
    "minkowski_functionals",
    "gaussian_minkowski",
    "spectral_moments",
    "make_sharded_minkowski",
]


def _grad_bcast(shape, spacing, dtype):
    kx, ky, kz = _derived._grad_kvectors(shape, spacing, dtype)
    return (
        kx[:, None, None], ky[None, :, None], kz[None, None, :],
    )


@functools.partial(jax.jit, static_argnames=("shape", "spacing"))
def _field_invariants(u, shape, spacing):
    """(w1, w2, w3) per voxel: |g|, |g|(k1+k2), |g| k1 k2.

    g = grad u and A = Hess u via spectral kernels (Nyquist-zeroed odd
    derivatives, ops/derived.py conventions); the level-set curvatures
    in terms of derivatives:

        |g| (k1 + k2) = (g.A.g - |g|^2 tr A) / |g|^2
        |g| k1 k2     = (g.cof(A).g) / |g|^3
    """
    a = _transform.rfftn(u, norm="forward")
    kv = _grad_bcast(shape, spacing, u.dtype)
    g = [
        _transform.irfftn(
            jax.lax.complex(-a.imag * kv[i], a.real * kv[i]),
            shape, norm="forward",
        )
        for i in range(3)
    ]
    A = {}
    for i in range(3):
        for j in range(i, 3):
            A[(i, j)] = _transform.irfftn(
                -(kv[i] * kv[j]) * a, shape, norm="forward"
            )
    g2 = g[0] * g[0] + g[1] * g[1] + g[2] * g[2]
    trA = A[(0, 0)] + A[(1, 1)] + A[(2, 2)]
    gAg = (
        g[0] * g[0] * A[(0, 0)]
        + g[1] * g[1] * A[(1, 1)]
        + g[2] * g[2] * A[(2, 2)]
        + 2.0 * (
            g[0] * g[1] * A[(0, 1)]
            + g[0] * g[2] * A[(0, 2)]
            + g[1] * g[2] * A[(1, 2)]
        )
    )
    # g . cof(A) . g for symmetric A
    gcofg = (
        g[0] * g[0] * (A[(1, 1)] * A[(2, 2)] - A[(1, 2)] ** 2)
        + g[1] * g[1] * (A[(0, 0)] * A[(2, 2)] - A[(0, 2)] ** 2)
        + g[2] * g[2] * (A[(0, 0)] * A[(1, 1)] - A[(0, 1)] ** 2)
        + 2.0 * g[0] * g[1] * (A[(0, 2)] * A[(1, 2)] - A[(0, 1)] * A[(2, 2)])
        + 2.0 * g[0] * g[2] * (A[(0, 1)] * A[(1, 2)] - A[(0, 2)] * A[(1, 1)])
        + 2.0 * g[1] * g[2] * (A[(0, 1)] * A[(0, 2)] - A[(1, 2)] * A[(0, 0)])
    )
    safe = jnp.where(g2 > 0, g2, 1.0)
    w1 = jnp.sqrt(g2)
    w2 = jnp.where(g2 > 0, (gAg - g2 * trA) / safe, 0.0)
    w3 = jnp.where(g2 > 0, gcofg / (safe * jnp.sqrt(safe)), 0.0)
    return w1, w2, w3


@functools.partial(jax.jit, static_argnames=("nbins",))
def _threshold_bins(u, w1, w2, w3, edges, nbins):
    """Per-threshold-bin (count, sum w1, sum w2, sum w3) + tail counts.

    One one-hot matmul contraction per x-slab (vmapped); also returns the
    count of voxels >= each edge (exact, for v0) via the reverse
    cumulative of the counts plus the above-last-edge tail.
    """
    idx = jnp.searchsorted(edges, u, side="right", method="compare_all") - 1
    below = idx < 0
    above = idx >= nbins
    idx_c = jnp.clip(idx, 0, nbins - 1)

    def slab(args):
        ix, b, av, x1, x2, x3 = args
        oh = (
            ix.ravel()[:, None] == jnp.arange(nbins, dtype=ix.dtype)
        ).astype(x1.dtype)
        valid = (~(b | av)).ravel().astype(x1.dtype)
        mat = jnp.stack([
            valid,
            valid * x1.ravel(),
            valid * x2.ravel(),
            valid * x3.ravel(),
        ])
        out = jax.lax.dot(mat, oh, precision=jax.lax.Precision.HIGHEST)
        return out, jnp.sum(av.ravel().astype(x1.dtype))

    outs, tails = jax.lax.map(
        slab, (idx_c, below, above, w1, w2, w3)
    )
    return jnp.sum(outs, axis=0), jnp.sum(tails)


@functools.lru_cache(maxsize=16)
def make_sharded_minkowski(mesh, shape, spacing, nbins,
                           dtype_name="float32"):
    """Compile the mesh-native Minkowski measurement (slab or pencil).

    One distributed forward transform + nine elementwise-kernel
    distributed inverses build (grad u, Hess u) sharded like the render;
    the curvature invariants are shard-local pointwise; the threshold
    binning runs as ``nbins`` fused masked global reductions (XLA psums
    over the spatial axes — mesh-family agnostic, unlike a shard_map
    with a hard-coded field spec).  fn(delta, sigma0, edges) ->
    ((4, nbins) sums, above-last-edge tail count).
    """
    from randomfield_tpu.models.constrained import _forward_mesh
    from randomfield_tpu.parallel.render import _inverse, _mesh_specs

    dtype = jnp.dtype(dtype_name)
    _, spec_sharding, _ = _mesh_specs(mesh, batched=False)

    def fn(delta, sigma0, edges):
        u = jnp.asarray(delta, dtype) / sigma0
        a = _forward_mesh(u, shape, mesh, dtype)
        kv = _grad_bcast(shape, spacing, dtype)

        def inv(ck):
            ck = jax.lax.with_sharding_constraint(ck, spec_sharding)
            return _inverse(ck, shape, mesh, False)

        g = [
            inv(jax.lax.complex(-a.imag * kv[i], a.real * kv[i]))
            for i in range(3)
        ]
        A = {}
        for i in range(3):
            for j in range(i, 3):
                A[(i, j)] = inv(-(kv[i] * kv[j]) * a)
        g2 = g[0] * g[0] + g[1] * g[1] + g[2] * g[2]
        trA = A[(0, 0)] + A[(1, 1)] + A[(2, 2)]
        gAg = (
            g[0] * g[0] * A[(0, 0)]
            + g[1] * g[1] * A[(1, 1)]
            + g[2] * g[2] * A[(2, 2)]
            + 2.0 * (
                g[0] * g[1] * A[(0, 1)]
                + g[0] * g[2] * A[(0, 2)]
                + g[1] * g[2] * A[(1, 2)]
            )
        )
        gcofg = (
            g[0] * g[0] * (A[(1, 1)] * A[(2, 2)] - A[(1, 2)] ** 2)
            + g[1] * g[1] * (A[(0, 0)] * A[(2, 2)] - A[(0, 2)] ** 2)
            + g[2] * g[2] * (A[(0, 0)] * A[(1, 1)] - A[(0, 1)] ** 2)
            + 2.0 * g[0] * g[1]
            * (A[(0, 2)] * A[(1, 2)] - A[(0, 1)] * A[(2, 2)])
            + 2.0 * g[0] * g[2]
            * (A[(0, 1)] * A[(1, 2)] - A[(0, 2)] * A[(1, 1)])
            + 2.0 * g[1] * g[2]
            * (A[(0, 1)] * A[(0, 2)] - A[(1, 2)] * A[(0, 0)])
        )
        safe = jnp.where(g2 > 0, g2, 1.0)
        w1 = jnp.sqrt(g2)
        w2 = jnp.where(g2 > 0, (gAg - g2 * trA) / safe, 0.0)
        w3 = jnp.where(g2 > 0, gcofg / (safe * jnp.sqrt(safe)), 0.0)

        idx = jnp.searchsorted(
            edges, u, side="right", method="compare_all"
        ) - 1
        above = idx >= nbins

        def one(b):
            m = jnp.where(idx == b, jnp.ones((), dtype),
                          jnp.zeros((), dtype))
            return jnp.stack([
                jnp.sum(m), jnp.sum(m * w1), jnp.sum(m * w2),
                jnp.sum(m * w3),
            ])

        sums = jax.lax.map(one, jnp.arange(nbins))
        return sums.T, jnp.sum(above.astype(dtype))

    return jax.jit(fn)


def minkowski_functionals(delta, spacing, nbins=24, nu_max=3.0,
                          sigma0=None, mesh=None):
    """Measured Minkowski functional densities of a 3-D field.

    Thresholds are ``nbins`` uniform values nu in [-nu_max, nu_max] (in
    units of ``sigma0`` — the field's own std by default; pass the
    predicted sigma0 when gating against theory so threshold units are
    noise-free).  Returns ``(nu, v0, v1, v2, v3)``:

    * ``v0`` is exact per threshold (fraction of voxels >= nu sigma0);
    * ``v1..v3`` estimate <w delta(u - nu)> by binning voxels into
      threshold cells of width dnu centered on each nu (bias O(dnu^2));
    * curvature units: lengths in the field's comoving units via
      ``spacing`` (derivatives are spectral);
    * with ``mesh`` (slab or pencil) the whole measurement runs
      distributed — sharded transforms, shard-local invariants, psum
      threshold reductions; parity with single-device is asserted in
      tests.
    """
    shape = tuple(int(s) for s in delta.shape[-3:])
    if sigma0 is None:
        from randomfield_tpu.validate.stats import field_moments

        _, var = field_moments(delta)
        sigma0 = float(np.sqrt(var))
    nu = np.linspace(-float(nu_max), float(nu_max), int(nbins))
    dnu = nu[1] - nu[0]
    edges = np.concatenate([nu - 0.5 * dnu, [nu[-1] + 0.5 * dnu]])
    if mesh is not None:
        from randomfield_tpu.parallel.multihost import replicated_to_host

        fn = make_sharded_minkowski(
            mesh, shape, float(spacing), int(nbins),
        )
        out, tail = fn(
            delta, np.float32(sigma0), np.asarray(edges, np.float32)
        )
        out = np.asarray(replicated_to_host(out), np.float64)
        tail = float(replicated_to_host(tail))
    else:
        d = jnp.asarray(delta)
        u = d / jnp.asarray(sigma0, d.dtype)
        w1, w2, w3 = _field_invariants(u, shape, float(spacing))
        out, tail = _threshold_bins(
            u, w1, w2, w3, jnp.asarray(edges, d.dtype), int(nbins)
        )
        out = np.asarray(out, np.float64)
    n = float(np.prod(shape))
    counts = out[0]
    # exact v0 at each nu: voxels above the bin center = voxels above
    # the bin's lower edge minus those in [edge, center) — the half-bin
    # split is the only O(dnu) term; refine it with the in-bin mean
    # being ~uniform: subtract half the bin count (O(dnu^2) residual).
    above_edge = np.cumsum(counts[::-1])[::-1] + float(tail)
    v0 = (above_edge - 0.5 * counts) / n
    scale = 1.0 / (n * dnu)
    v1 = out[1] * scale / 6.0
    v2 = out[2] * scale / (6.0 * np.pi)
    v3 = out[3] * scale / (4.0 * np.pi)
    return nu, v0, v1, v2, v3


def spectral_moments(power, shape, spacing, smoothing_length=0.0,
                     interpolation="log10k"):
    """(sigma0^2, sigma1^2) of the band-limited field, exactly.

    Sums sigma_eff(k)^2 (and |k_grad|^2 sigma_eff^2) over the packed
    modes with Hermitian multiplicity — the same interpolation,
    smoothing and NYQUIST-ZEROED gradient vectors as the render and the
    spectral-derivative estimator, so :func:`gaussian_minkowski` with
    these moments is the exact expectation of
    :func:`minkowski_functionals` on rendered fields.
    """
    shape = tuple(int(s) for s in shape)
    table = _power.validate_power(power)
    lk, val, log_values = _power.table_arrays_host(
        table, interpolation, jnp.float32
    )
    s0, s1 = _moments_jit(
        jnp.asarray(lk), jnp.asarray(val),
        jnp.asarray(float(smoothing_length), jnp.float32),
        shape, float(spacing), bool(log_values),
    )
    return float(s0), float(s1)


@functools.partial(
    jax.jit, static_argnames=("shape", "spacing", "log_values")
)
def _moments_jit(lk_tab, val_tab, sm, shape, spacing, log_values):
    dtype = jnp.float32
    sig = _power.sigma_inline(
        shape, spacing, lk_tab, val_tab, log_values, dtype, layout="xyz"
    )
    k2 = _grid.ksq(shape, spacing, dtype)
    se2 = (sig * jnp.exp(-0.5 * k2 * sm * sm)) ** 2
    gx, gy, gz = _grad_bcast(shape, spacing, dtype)
    kg2 = gx * gx + gy * gy + gz * gz
    nzh = shape[2] // 2 + 1
    mult = np.full(nzh, 2.0)
    mult[0] = 1.0
    if shape[2] % 2 == 0:
        mult[-1] = 1.0
    m = jnp.asarray(mult, dtype)[None, None, :]
    return jnp.sum(m * se2), jnp.sum(m * kg2 * se2)


def gaussian_minkowski(nu, sigma0_sq, sigma1_sq):
    """Exact Gaussian-field Minkowski densities at thresholds ``nu``.

    Tomita / Schmalzing-Buchert closed forms (module docstring); pass
    the :func:`spectral_moments` of the render's band-limited spectrum.
    Returns ``(v0, v1, v2, v3)``.
    """
    from jax.scipy.special import erfc

    nu = np.asarray(nu, np.float64)
    lam = np.sqrt(float(sigma1_sq) / (3.0 * float(sigma0_sq)))
    e = np.exp(-0.5 * nu * nu)
    v0 = 0.5 * np.asarray(erfc(nu / np.sqrt(2.0)), np.float64)
    v1 = lam * e / (3.0 * np.pi)
    v2 = (2.0 / 3.0) * lam**2 * nu * e / (2.0 * np.pi) ** 1.5
    v3 = lam**3 * (nu * nu - 1.0) * e / (2.0 * np.pi) ** 2
    return v0, v1, v2, v3
