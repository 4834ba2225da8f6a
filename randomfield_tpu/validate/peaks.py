"""BBKS peak statistics with exact Gaussian expectations.

Counts of local density maxima, binned by peak height nu = u / sigma0,
are the classic fourth validation axis (after two-point statistics,
one-point moments and Minkowski morphology — the reference validates
only the first two, SURVEY.md section 3.5; this is added capability).
For a Gaussian random field the differential comoving number density of
maxima has the closed form of Bardeen, Bond, Kaiser & Szalay (1986,
ApJ 304, 15; "BBKS" eqs. 4.3-4.5, A15):

    n_pk(nu) dnu = exp(-nu^2/2) / ((2 pi)^2 R*^3) G(gamma, gamma nu) dnu

with spectral parameters built from the moments
sigma_j^2 = sum_k |k|^{2j} sigma_eff(k)^2 of the (smoothed,
band-limited) field:

    gamma = sigma1^2 / (sigma0 sigma2),    R* = sqrt(3) sigma1 / sigma2

and G the one-dimensional integral of the curvature weight f(x)
(closed form, BBKS A15) against a Gaussian of mean gamma*nu and
variance 1 - gamma^2.  Integrated over all heights this reproduces the
exact total maximum density (29 - 6 sqrt(6)) / (2 5^{3/2} (2 pi)^2)
R*^{-3} ~= 0.01620 R*^{-3} — asserted as a pure-math unit test.

Measurement is lattice-native: a voxel is a peak iff it equals the max
of its 27-cube (6 separable rolled-max passes, not 26 comparisons);
heights are binned with the same one-hot reductions as every other
estimator here.  Unlike the Minkowski estimator, which differentiates
spectrally and is exactly matched to the discrete modes, a lattice
maximum is only an approximation of a continuum maximum — accurate when
the field is well resolved (R* a few grid spacings, i.e. render with a
``smoothing_length`` of ~3+ cells).  The gate's tolerance budgets that
residual discretization bias explicitly; the expectation uses FULL
|k|^2 / |k|^4 moment weights (not the Nyquist-zeroed gradient vectors)
because neighbor comparison samples the underlying band-limited field,
it does not apply a spectral derivative.

Device-native: the separable neighborhood max is 6 rolls (XLA lowers each
to two slices + a concat; under a sharded jit GSPMD turns the wrapped
edges into halo collective-permutes), so the mesh path is the same
program with a sharding constraint — slab and pencil both work.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from randomfield_tpu.ops import grid as _grid
from randomfield_tpu.ops import power as _power

__all__ = [
    "peak_statistics",
    "bbks_moments",
    "bbks_peak_density",
    "bbks_total_density",
    "bbks_expected_counts",
    "make_sharded_peaks",
]


# ---------------------------------------------------------------------------
# Spectral moments (sigma0^2, sigma1^2, sigma2^2)
# ---------------------------------------------------------------------------

def bbks_moments(power, shape, spacing, smoothing_length=0.0,
                 interpolation="log10k"):
    """(sigma0^2, sigma1^2, sigma2^2) of the band-limited field, exactly.

    Sums |k|^{2j} sigma_eff(k)^2 over the packed modes with Hermitian
    multiplicity, with the render's interpolation and smoothing.  Uses
    the full |k|^2 (NOT the Nyquist-zeroed gradient vectors of
    validate/minkowski.py): peak finding compares field values, it does
    not differentiate spectrally, so the continuum moments of the
    band-limited spectrum are the matched expectation inputs.
    """
    shape = tuple(int(s) for s in shape)
    table = _power.validate_power(power)
    lk, val, log_values = _power.table_arrays_host(
        table, interpolation, jnp.float32
    )
    s0, s1, s2 = _bbks_moments_jit(
        jnp.asarray(lk), jnp.asarray(val),
        jnp.asarray(float(smoothing_length), jnp.float32),
        shape, float(spacing), bool(log_values),
    )
    return float(s0), float(s1), float(s2)


@functools.partial(
    jax.jit, static_argnames=("shape", "spacing", "log_values")
)
def _bbks_moments_jit(lk_tab, val_tab, sm, shape, spacing, log_values):
    dtype = jnp.float32
    sig = _power.sigma_inline(
        shape, spacing, lk_tab, val_tab, log_values, dtype, layout="xyz"
    )
    k2 = _grid.ksq(shape, spacing, dtype)
    se2 = (sig * jnp.exp(-0.5 * k2 * sm * sm)) ** 2
    nzh = shape[2] // 2 + 1
    mult = np.full(nzh, 2.0)
    mult[0] = 1.0
    if shape[2] % 2 == 0:
        mult[-1] = 1.0
    m = jnp.asarray(mult, dtype)[None, None, :]
    return (
        jnp.sum(m * se2),
        jnp.sum(m * k2 * se2),
        jnp.sum(m * k2 * k2 * se2),
    )


# ---------------------------------------------------------------------------
# BBKS theory
# ---------------------------------------------------------------------------

def _f_curvature(x):
    """BBKS eq. A15 closed form for f(x) (numpy, float64)."""
    from math import sqrt

    x = np.asarray(x, np.float64)
    # jax.scipy.special.erf works on numpy inputs too, but math.erf via
    # numpy vectorization is dependency-free and exact enough here.
    erf = np.vectorize(__import__("math").erf)
    a = 0.5 * (x**3 - 3.0 * x) * (
        erf(sqrt(2.5) * x) + erf(sqrt(2.5) * 0.5 * x)
    )
    b = np.sqrt(0.4 / np.pi) * (
        (7.75 * x * x + 1.6) * np.exp(-0.625 * x * x)
        + (0.5 * x * x - 1.6) * np.exp(-2.5 * x * x)
    )
    return a + b


def _G(gamma, xstar, n_grid=4001):
    """BBKS eq. 4.5: G(gamma, x*) = <f(x)> over N(x*, 1 - gamma^2)."""
    gamma = float(gamma)
    xstar = np.atleast_1d(np.asarray(xstar, np.float64))
    var = max(1.0 - gamma * gamma, 1e-12)
    hi = max(10.0, float(xstar.max()) + 8.0 * np.sqrt(var))
    x = np.linspace(0.0, hi, n_grid)
    w = _f_curvature(x)
    kern = np.exp(
        -0.5 * (x[None, :] - xstar[:, None]) ** 2 / var
    ) / np.sqrt(2.0 * np.pi * var)
    return np.trapezoid(w[None, :] * kern, x, axis=1)


def bbks_peak_density(nu, sigma0_sq, sigma1_sq, sigma2_sq):
    """Differential comoving peak density n_pk(nu) (per volume per nu).

    BBKS eq. 4.3 with gamma and R* from the supplied spectral moments
    (:func:`bbks_moments` of the render's smoothed band-limited
    spectrum).  ``nu`` is peak height in units of sigma0.
    """
    nu = np.asarray(nu, np.float64)
    s0 = np.sqrt(float(sigma0_sq))
    s1 = np.sqrt(float(sigma1_sq))
    s2 = np.sqrt(float(sigma2_sq))
    gamma = s1 * s1 / (s0 * s2)
    rstar = np.sqrt(3.0) * s1 / s2
    g = _G(gamma, gamma * nu)
    return np.exp(-0.5 * nu * nu) * g / ((2.0 * np.pi) ** 2 * rstar**3)


def bbks_total_density(sigma0_sq, sigma1_sq, sigma2_sq):
    """Exact total maximum density: (29 - 6 sqrt 6) (sigma2 / sqrt(3)
    sigma1)^3 / (2 5^{3/2} (2 pi)^2) — the closed-form integral of
    :func:`bbks_peak_density` over all nu (BBKS eq. 4.11b)."""
    s1 = np.sqrt(float(sigma1_sq))
    s2 = np.sqrt(float(sigma2_sq))
    rstar = np.sqrt(3.0) * s1 / s2
    const = (29.0 - 6.0 * np.sqrt(6.0)) / (
        2.0 * 5.0**1.5 * (2.0 * np.pi) ** 2
    )
    return const / rstar**3


def bbks_expected_counts(edges, volume, sigma0_sq, sigma1_sq, sigma2_sq,
                         n_sub=64):
    """Expected peak counts per nu bin: V * integral of n_pk over each
    bin (fine fixed-grid quadrature), plus the expected total count
    (closed form, all heights)."""
    edges = np.asarray(edges, np.float64)
    counts = np.empty(len(edges) - 1)
    for i in range(len(edges) - 1):
        x = np.linspace(edges[i], edges[i + 1], n_sub)
        counts[i] = np.trapezoid(
            bbks_peak_density(x, sigma0_sq, sigma1_sq, sigma2_sq), x
        )
    total = bbks_total_density(sigma0_sq, sigma1_sq, sigma2_sq)
    return counts * float(volume), total * float(volume)


# ---------------------------------------------------------------------------
# Lattice measurement
# ---------------------------------------------------------------------------

def _cube_max(u):
    """Max over each voxel's 27-cube via 3 separable rolled-max passes."""
    m = u
    for ax in (0, 1, 2):
        m = jnp.maximum(
            m, jnp.maximum(jnp.roll(m, 1, axis=ax), jnp.roll(m, -1, axis=ax))
        )
    return m


@functools.partial(jax.jit, static_argnames=("nbins",))
def _peak_bins(u, edges, nbins):
    peak = u == _cube_max(u)
    idx = jnp.searchsorted(edges, u, side="right",
                           method="compare_all") - 1

    def one(b):
        return jnp.sum((peak & (idx == b)).astype(jnp.int32))

    counts = jax.lax.map(one, jnp.arange(nbins))
    return counts, jnp.sum(peak.astype(jnp.int32))


@functools.lru_cache(maxsize=16)
def make_sharded_peaks(mesh, shape, nbins, dtype_name="float32"):
    """Compile the mesh-native peak measurement (slab or pencil).

    The separable 27-cube max runs on the sharded field (GSPMD converts
    the wrapped-edge rolls into halo exchanges over the spatial mesh
    axes); binning is ``nbins`` masked global sums.  fn(delta, sigma0,
    edges) -> (counts, total).
    """
    from randomfield_tpu.parallel.render import _mesh_specs

    dtype = jnp.dtype(dtype_name)
    _, _, out_sharding = _mesh_specs(mesh, batched=False)

    def fn(delta, sigma0, edges):
        u = jax.lax.with_sharding_constraint(
            jnp.asarray(delta, dtype) / sigma0, out_sharding
        )
        peak = u == _cube_max(u)
        idx = jnp.searchsorted(edges, u, side="right",
                               method="compare_all") - 1

        def one(b):
            return jnp.sum((peak & (idx == b)).astype(jnp.int32))

        counts = jax.lax.map(one, jnp.arange(nbins))
        return counts, jnp.sum(peak.astype(jnp.int32))

    return jax.jit(fn)


def peak_statistics(delta, spacing, nbins=14, nu_min=-2.0, nu_max=5.0,
                    sigma0=None, mesh=None):
    """Lattice peak counts of a 3-D field, binned by height.

    A voxel is a peak iff it is the maximum of its 27-cube (periodic).
    Heights are nu = delta / sigma0 binned into ``nbins`` uniform bins
    over [nu_min, nu_max] (peaks outside the range are counted in
    ``total`` but no bin).  Pass the predicted ``sigma0`` when gating
    against :func:`bbks_expected_counts` so threshold units are
    noise-free.  With ``mesh`` the measurement runs fully distributed.
    Returns ``(nu_centers, counts, total)`` with counts int64 numpy.
    """
    shape = tuple(int(s) for s in delta.shape[-3:])
    if sigma0 is None:
        from randomfield_tpu.validate.stats import field_moments

        _, var = field_moments(delta)
        sigma0 = float(np.sqrt(var))
    edges = np.linspace(float(nu_min), float(nu_max), int(nbins) + 1)
    centers = 0.5 * (edges[:-1] + edges[1:])
    if mesh is not None:
        from randomfield_tpu.parallel.multihost import replicated_to_host

        fn = make_sharded_peaks(mesh, shape, int(nbins))
        counts, total = fn(
            delta, np.float32(sigma0), np.asarray(edges, np.float32)
        )
        counts = np.asarray(replicated_to_host(counts), np.int64)
        total = int(replicated_to_host(total))
    else:
        d = jnp.asarray(delta)
        u = d / jnp.asarray(sigma0, d.dtype)
        counts, total = _peak_bins(
            u, jnp.asarray(edges, d.dtype), int(nbins)
        )
        counts = np.asarray(counts, np.int64)
        total = int(total)
    return centers, counts, total
