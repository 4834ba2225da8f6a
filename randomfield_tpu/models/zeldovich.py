"""Zel'dovich mock catalogs: displaced particles, painting, catalog P(k).

The canonical consumer loop for a Gaussian-field engine's displacement
output (ops/derived.py: ``psi_k = +i k / k^2 delta_k``, ``x = q + D psi``):

1. ``zeldovich_positions`` — move one particle per grid cell from its
   Lagrangian point q by the displacement field (optionally boosted
   along the line of sight for redshift-space distortions: the
   Zel'dovich RSD mapping ``s = q + psi + f psi_los``).
2. ``poisson_sample`` — discrete tracers: per-cell Poisson counts with
   intensity ``nbar * Vcell * (1 + delta)`` (use a lognormal field for a
   positive-definite intensity; Gaussian fields are clipped at zero).
3. ``paint_cic`` — mass assignment back onto a grid (NGP/CIC/TSC).
4. ``catalog_power`` — the painted field's P(k) with the assignment
   window deconvolved and the weighted shot noise subtracted.

Design: the "catalog" is grid-shaped — positions ``(3, nx,
ny, nz)`` and per-particle weights — so every stage is one jitted
static-shape device program (a variable-length particle list would
force host round-trips and recompilation; weights of zero represent
absent particles for free).  Painting uses XLA scatter-add, which
serializes colliding updates on device — these are validation-scale tools
(fine through ~256^3), not the render hot path, and are documented as
such.  Reference parity: the upstream package ends at Gaussian fields
(SURVEY.md section 0); this module is framework surface for its
standard downstream use (N-body initial conditions and mock catalogs).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from randomfield_tpu.ops import grid as _grid

__all__ = [
    "lagrangian_positions",
    "zeldovich_positions",
    "poisson_sample",
    "paint",
    "paint_cic",
    "catalog_power",
    "catalog_power_multipoles",
    "shot_noise",
    "zeldovich_power",
]


def lagrangian_positions(shape, spacing, dtype=jnp.float32):
    """Unperturbed particle grid q [Mpc/h]: one particle per cell center
    at ``(i + 0.5) * spacing`` (grid layout ``(3, nx, ny, nz)``)."""
    nx, ny, nz = (int(s) for s in shape)
    spacing = float(spacing)
    qx = (jnp.arange(nx, dtype=dtype) + 0.5) * spacing
    qy = (jnp.arange(ny, dtype=dtype) + 0.5) * spacing
    qz = (jnp.arange(nz, dtype=dtype) + 0.5) * spacing
    zero = jnp.zeros((nx, ny, nz), dtype)
    return jnp.stack([
        zero + qx[:, None, None],
        zero + qy[None, :, None],
        zero + qz[None, None, :],
    ])


@functools.partial(jax.jit, static_argnames=("spacing", "f", "los_axis"))
def _zeldovich_positions(psi, spacing, f, los_axis):
    shape = psi.shape[1:]
    q = lagrangian_positions(shape, spacing, psi.dtype)
    x = q + psi
    if f:
        x = x.at[los_axis].add(jnp.asarray(f, psi.dtype) * psi[los_axis])
    box = jnp.asarray(
        [n * spacing for n in shape], psi.dtype
    )[:, None, None, None]
    return jnp.mod(x, box)


def zeldovich_positions(psi, spacing, f=0.0, los_axis=2):
    """Particle positions ``x = q + psi`` (periodic wrap), grid layout.

    ``psi`` is a ``(3, nx, ny, nz)`` displacement field in Mpc/h (e.g.
    ``Generator.generate_displacement``, which carries the lightcone /
    growth scaling already).  ``f`` adds the plane-parallel Zel'dovich
    redshift-space mapping ``s = x + f psi_los`` along ``los_axis``
    (``f = cosmology.growth_rate(z)``; the linear velocity
    ``v = a H f psi`` divided by ``a H``), producing Kaiser-distorted
    catalogs.
    """
    psi = jnp.asarray(psi)
    if psi.ndim != 4 or psi.shape[0] != 3:
        raise ValueError(
            f"psi must be (3, nx, ny, nz), got {psi.shape}"
        )
    return _zeldovich_positions(psi, float(spacing), float(f), int(los_axis))


def poisson_sample(delta, nbar, spacing, seed=0):
    """Per-cell Poisson tracer counts with intensity nbar*Vcell*(1+delta).

    ``nbar`` is the mean tracer density [(Mpc/h)^-3]; negative
    intensities (a Gaussian delta below -1) are clipped to zero —
    lognormal fields (models/lognormal.py) need no clip by
    construction.  Returns a float grid of counts (a weight array for
    :func:`paint` / :func:`catalog_power`).
    """
    delta = jnp.asarray(delta)
    lam = jnp.maximum(
        (1.0 + delta) * (float(nbar) * float(spacing) ** 3), 0.0
    )
    key = jax.random.key(int(seed) ^ 0x5EEDC0DE)
    return jax.random.poisson(key, lam).astype(delta.dtype)


@functools.partial(jax.jit, static_argnames=("shape", "spacing", "order"))
def _paint(positions, weights, shape, spacing, order):
    nx, ny, nz = shape
    u = positions.reshape(3, -1) / jnp.asarray(spacing, positions.dtype)
    w = weights.reshape(-1).astype(positions.dtype)
    grid = jnp.zeros(nx * ny * nz, positions.dtype)
    dims = (nx, ny, nz)
    if order == 1:  # NGP: nearest cell center (particles live at centers)
        idx = [jnp.floor(u[a]).astype(jnp.int32) % dims[a] for a in range(3)]
        flat = (idx[0] * ny + idx[1]) * nz + idx[2]
        return grid.at[flat].add(w).reshape(shape)
    if order == 2:
        # CIC: cell-centered convention — a particle at a cell center
        # gives that cell weight 1 exactly
        uc = u - 0.5
        i0 = jnp.floor(uc).astype(jnp.int32)
        frac = uc - i0.astype(positions.dtype)
        for corner in range(8):
            off = [(corner >> a) & 1 for a in range(3)]
            wc = w
            flat = jnp.zeros_like(i0[0])
            for a in range(3):
                wc = wc * jnp.where(off[a], frac[a], 1.0 - frac[a])
                flat = flat * dims[a] + (i0[a] + off[a]) % dims[a]
            grid = grid.at[flat].add(wc)
        return grid.reshape(shape)
    # TSC: quadratic spline over the 3 nearest cells per axis
    # (Hockney & Eastwood): s = distance to the nearest cell center in
    # cells, weights 0.5(0.5 - s)^2 / 0.75 - s^2 / 0.5(0.5 + s)^2
    uc = u - 0.5
    i0 = jnp.round(uc).astype(jnp.int32)
    s = uc - i0.astype(positions.dtype)
    w3 = [0.5 * (0.5 - s) ** 2, 0.75 - s * s, 0.5 * (0.5 + s) ** 2]
    for corner in range(27):
        off = [(corner // 3**a) % 3 for a in range(3)]
        wc = w
        flat = jnp.zeros_like(i0[0])
        for a in range(3):
            wc = wc * w3[off[a]][a]
            flat = flat * dims[a] + (i0[a] + (off[a] - 1)) % dims[a]
        grid = grid.at[flat].add(wc)
    return grid.reshape(shape)


def paint(positions, shape, spacing, weights=1.0, window="cic"):
    """Mass-assign particles onto a grid -> density contrast delta.

    ``positions``: ``(3, ...)`` array in Mpc/h (any trailing shape).
    ``weights``: scalar or per-particle array broadcastable to the
    trailing shape.  ``window``: ``'ngp'``, ``'cic'`` or ``'tsc'``
    (cell-centered: an NGP/CIC particle exactly at a cell center lands
    wholly in that cell — and a uniform cell-center grid paints to
    exactly zero contrast under all three).  Returns ``(delta,
    w_mean)`` — the contrast grid and the mean painted mass per cell
    (for shot-noise bookkeeping).
    """
    positions = jnp.asarray(positions)
    if positions.shape[0] != 3:
        raise ValueError(f"positions must be (3, ...), got {positions.shape}")
    shape = tuple(int(s) for s in shape)
    orders = {"ngp": 1, "cic": 2, "tsc": 3}
    if window not in orders:
        raise ValueError(
            f"window must be 'ngp', 'cic' or 'tsc', got {window!r}"
        )
    weights = jnp.broadcast_to(
        jnp.asarray(weights, positions.dtype), positions.shape[1:]
    )
    mass = _paint(positions, weights, shape, float(spacing), orders[window])
    mean = jnp.mean(mass)
    return mass / mean - 1.0, mean


def paint_cic(positions, shape, spacing, weights=1.0):
    """CIC-paint particles -> density contrast (see :func:`paint`)."""
    return paint(positions, shape, spacing, weights, window="cic")[0]


def shot_noise(weights, volume, counts=True):
    """Poisson shot-noise power of a painted catalog [(Mpc/h)^3].

    ``counts=True`` (this module's representation — ``weights`` are
    per-cell Poisson tracer COUNTS, :func:`poisson_sample`): the painted
    field's white-noise floor is ``V / N_gal = V * sum(w) / (sum w)^2``
    — per-cell Poisson variance equals the mean, so coincident tracers
    in one cell do NOT inflate the noise.  ``counts=False``: the
    independent weighted-point formula ``V * sum(w^2) / (sum w)^2``
    (FKP-style per-particle weights at independent positions).
    """
    w = np.asarray(weights, np.float64).ravel()
    sw = w.sum()
    num = w.sum() if counts else (w * w).sum()
    return float(volume) * float(num) / (sw * sw)


def catalog_power(positions, spacing, shape=None, weights=1.0, nbins=32,
                  window="cic", subtract_shot_noise=None, interlaced=False,
                  mesh=None):
    """P(k) of a particle catalog: paint, deconvolve, bin, de-noise.

    Paints with ``window``, estimates P(k) with that window deconvolved
    (validate/stats.py ``calculate_power(window=...)``) and subtracts
    the shot noise when the catalog is discrete (``subtract_shot_noise``
    defaults to True for non-scalar weights — per-cell Poisson counts —
    and False for the equal-weight displaced particle grid, which is a
    deterministic density representation, not a sparse sample).  The
    flat-noise subtraction and window deconvolution are exact at
    ``k << k_Nyquist``; near Nyquist, aliasing of the assignment window
    makes both approximate.  ``interlaced=True`` paints a second copy
    of the catalog shifted by half a cell and alias-cancels the two
    spectra (Sefusatti et al. 2016), keeping the estimate accurate to
    much higher k — pair it with ``window='tsc'`` for the standard
    high-fidelity configuration.  Returns ``(k_mean, p_hat, n_modes)``.
    """
    from randomfield_tpu.validate import stats as _stats

    positions = jnp.asarray(positions)
    if shape is None:
        if positions.ndim != 4:
            raise ValueError(
                "pass shape= explicitly for non-grid-layout positions"
            )
        shape = positions.shape[1:]
    shape = tuple(int(s) for s in shape)
    if subtract_shot_noise is None:
        subtract_shot_noise = jnp.ndim(weights) > 0
    if mesh is not None:
        # pod path: sharded painting (parallel/paint.py) + the sharded
        # deconvolving (and optionally interlacing) estimator — the
        # grids never gather
        from randomfield_tpu.parallel.paint import paint_sharded

        pos_np = np.asarray(positions).reshape(3, -1)
        w_np = np.broadcast_to(
            np.asarray(weights, np.float32), pos_np.shape[1:]
        )
        delta, _ = paint_sharded(
            pos_np, shape, float(spacing), mesh, weights=w_np,
            window=window,
        )
        delta2 = None
        if interlaced:
            delta2, _ = paint_sharded(
                pos_np + float(spacing) / 2.0, shape, float(spacing),
                mesh, weights=w_np, window=window,
            )
        k, p, n = _stats.calculate_power(
            delta, float(spacing), nbins=int(nbins), window=window,
            interlaced_with=delta2, mesh=mesh,
        )
        if subtract_shot_noise:
            w = (weights if jnp.ndim(weights)
                 else jnp.full(np.asarray(positions).reshape(3, -1).shape[1:],
                               weights))
            volume = shape[0] * shape[1] * shape[2] * float(spacing) ** 3
            p = p - shot_noise(np.asarray(w), volume)
        return k, p, n
    delta, _ = paint(positions, shape, float(spacing), weights, window)
    delta2 = None
    if interlaced:
        delta2, _ = paint(
            positions + float(spacing) / 2.0, shape, float(spacing),
            weights, window,
        )
    k, p, n = _stats.calculate_power(
        delta, float(spacing), nbins=int(nbins), window=window,
        interlaced_with=delta2,
    )
    if subtract_shot_noise:
        w = weights if jnp.ndim(weights) else jnp.full(positions.shape[1:],
                                                       weights)
        volume = shape[0] * shape[1] * shape[2] * float(spacing) ** 3
        p = p - shot_noise(np.asarray(w), volume)
    return k, p, n


def catalog_power_multipoles(positions, spacing, shape=None, weights=1.0,
                             nbins=32, ells=(0, 2, 4), los_axis=2,
                             window="cic", subtract_shot_noise=None,
                             interlaced=False, mesh=None):
    """Redshift-space multipoles P_ell(k) of a particle catalog.

    Paints with ``window``, runs validate/stats.py
    ``calculate_power_multipoles`` with that window deconvolved
    (``interlaced=True`` adds the half-cell-shifted alias-cancelling
    painting, as in :func:`catalog_power`), and subtracts the (flat,
    hence monopole-only) shot noise under the same default as
    :func:`catalog_power`.  Pair with RSD positions from
    ``zeldovich_positions(psi, spacing, f=...)`` to measure the Kaiser
    quadrupole.  Returns ``(k_mean, p_ell, n_modes)``.
    """
    from randomfield_tpu.validate import stats as _stats

    positions = jnp.asarray(positions)
    if shape is None:
        if positions.ndim != 4:
            raise ValueError(
                "pass shape= explicitly for non-grid-layout positions"
            )
        shape = positions.shape[1:]
    shape = tuple(int(s) for s in shape)
    if subtract_shot_noise is None:
        subtract_shot_noise = jnp.ndim(weights) > 0
    if mesh is not None:
        from randomfield_tpu.parallel.paint import paint_sharded

        pos_np = np.asarray(positions).reshape(3, -1)
        w_np = np.broadcast_to(
            np.asarray(weights, np.float32), pos_np.shape[1:]
        )
        delta, _ = paint_sharded(pos_np, shape, float(spacing), mesh,
                                 weights=w_np, window=window)
        delta2 = None
        if interlaced:
            delta2, _ = paint_sharded(
                pos_np + float(spacing) / 2.0, shape, float(spacing),
                mesh, weights=w_np, window=window,
            )
    else:
        delta, _ = paint(positions, shape, float(spacing), weights, window)
        delta2 = None
        if interlaced:
            delta2, _ = paint(
                positions + float(spacing) / 2.0, shape, float(spacing),
                weights, window,
            )
    k, p_ell, n = _stats.calculate_power_multipoles(
        delta, float(spacing), nbins=int(nbins), ells=ells,
        los_axis=int(los_axis), window=window, interlaced_with=delta2,
        mesh=mesh,
    )
    if subtract_shot_noise and 0 in tuple(ells):
        w = weights if jnp.ndim(weights) else jnp.full(positions.shape[1:],
                                                       weights)
        volume = shape[0] * shape[1] * shape[2] * float(spacing) ** 3
        p_ell[tuple(ells).index(0)] -= shot_noise(np.asarray(w), volume)
    return k, p_ell, n


# ---------------------------------------------------------------------------
# Exact (resummed) Zel'dovich power spectrum — the theory curve for the
# displaced-lattice mocks above
# ---------------------------------------------------------------------------

def _filon_cos_batch(mu, f, x):
    """Batched Filon: ``Int_0^1 f_b(mu) cos(x_b mu) dmu`` per row.

    ``mu``: (m,) shared increasing nodes on [0, 1]; ``f``: (B, m)
    smooth prefactor rows; ``x``: (B,) oscillation frequencies (any
    magnitude — the cosine is integrated analytically against the
    piecewise-linear interpolant of f, the vector twin of
    ops/power.py:_filon_sincos).  Rows with |x| ~ 0 fall back to the
    trapezoid limit.
    """
    x = np.asarray(x, np.float64)
    small = np.abs(x) < 1e-6
    xs = np.where(small, 1.0, x)[:, None]
    s = np.sin(mu[None, :] * xs)
    c = np.cos(mu[None, :] * xs)
    b = np.diff(f, axis=1) / np.diff(mu)[None, :]
    w = np.empty_like(f)
    w[:, 0] = -b[:, 0]
    w[:, -1] = b[:, -1]
    w[:, 1:-1] = b[:, :-1] - b[:, 1:]
    out = (f[:, -1] * s[:, -1] - f[:, 0] * s[:, 0]) / xs[:, 0] \
        + (c * w).sum(axis=1) / (xs[:, 0] * xs[:, 0])
    if small.any():
        trap = np.trapezoid(f[small], mu, axis=1)
        out[small] = trap
    return out


def zeldovich_power(power, k=None, z=0.0, cosmology=None, n_q=12288,
                    q_max=700.0, n_mu=96, n_psi=4096):
    """EXACT Zel'dovich (1LPT-resummed) power spectrum.

    The density of lattice points displaced by the linear field is a
    pure function of the displacement correlators (Taylor & Hamilton
    1996; no perturbative truncation):

        P_ZA(k) = Int d^3q e^{-i k.q} [ e^{-(1/2) k_i k_j C_ij(q)}
                                        - e^{-k^2 sigma_v^2} ],
        C_ij = X delta_ij + Y qhat_i qhat_j,
        X = 2 (sigma_v^2 - psi_perp),  Y = 2 (psi_perp - psi_par),

    with psi_par/psi_perp the displacement autocorrelations already
    used by the streaming model (models/streaming.py:
    velocity_correlations at f = 1).  Writing ``(1/2) C_ij =
    sigma_v^2 delta_ij - Psi_ij`` and pulling one order out
    analytically,

        P_ZA(k) = e^{-k^2 sigma_v^2} P_lin(k)
                  + Int d^3q e^{-i k.q} [ e^{-(1/2) k k C}
                    - e^{-k^2 sigma_v^2} (1 + k_i k_j Psi_ij) ],

    the remainder integrand decays like Psi^2 (compact support — the
    long-range linear tail whose oscillatory transform defeats direct
    quadrature is carried exactly by the first term).  The angular
    integral of the exponential is batched Filon quadrature in mu
    (exact for arbitrary k q — no Bessel-series truncation); the
    subtraction's mu moments are closed form (j0 and the mu^2
    moment); the radial integral is trapezoid on a linear q grid
    resolving the k q oscillation.  This is the theory curve for
    :func:`zeldovich_positions` mocks: the full nonlinear BAO damping
    and small-scale suppression of the displaced lattice, reducing to
    P_lin as k -> 0.  With ``z``/``cosmology`` the input table is
    growth-scaled by D(z)^2 first.  Host float64; returns
    ``(k, p_za)``.
    """
    from randomfield_tpu.models.cosmology import create_cosmology
    from randomfield_tpu.models.streaming import velocity_correlations
    from randomfield_tpu.ops.power import validate_power

    k_t, p_t = validate_power(power)
    z = float(z)
    if z != 0.0:
        cosmo = create_cosmology(cosmology)
        d = float(cosmo.growth_function(z))
        p_t = p_t * d * d
    if k is None:
        k = np.geomspace(max(1e-3, k_t[0]), min(2.0, k_t[-1]), 64)
    k = np.atleast_1d(np.asarray(k, np.float64))
    if np.any(k <= 0):
        raise ValueError("k must be positive")

    from randomfield_tpu.ops.fftlog import resample_loglog

    q = np.linspace(0.0, float(q_max), int(n_q))
    q[0] = 0.5 * q[1]
    psi_par, psi_perp, sv2 = velocity_correlations(
        (k_t, p_t), q, f=1.0, n=int(n_psi))
    x_corr = 2.0 * (sv2 - psi_perp)       # X(q)
    y_corr = 2.0 * (psi_perp - psi_par)   # Y(q)
    alpha = psi_perp                      # k k Psi = k^2 (alpha + beta mu^2)
    beta = psi_par - psi_perp
    mu = np.linspace(0.0, 1.0, int(n_mu))
    mu2 = mu * mu
    p_lin = resample_loglog(np.asarray(k_t, np.float64),
                            np.asarray(p_t, np.float64), k)

    out = np.empty_like(k)
    dq = np.gradient(q)
    for i, kk in enumerate(k):
        kq = kk * q
        damp = np.exp(-kk * kk * sv2)
        g = np.exp(-0.5 * kk * kk
                   * (x_corr[:, None] + y_corr[:, None] * mu2[None, :]))
        ang = _filon_cos_batch(mu, g, kq)          # (n_q,)
        # closed-form mu moments of the subtraction:
        # Int_0^1 cos(x mu) dmu = j0(x);  Int_0^1 mu^2 cos(x mu) dmu
        small = kq < 1e-3
        xs = np.where(small, 1.0, kq)
        j0 = np.where(small, 1.0 - kq * kq / 6.0, np.sin(xs) / xs)
        m2 = np.where(
            small, 1.0 / 3.0 - kq * kq / 10.0,
            ((xs * xs - 2.0) * np.sin(xs) + 2.0 * xs * np.cos(xs))
            / xs**3)
        sub = damp * ((1.0 + kk * kk * alpha) * j0 + kk * kk * beta * m2)
        out[i] = (damp * p_lin[i]
                  + 4.0 * np.pi * np.sum(q * q * (ang - sub) * dq))
    return k, out
