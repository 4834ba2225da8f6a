"""Stacked radial profiles around selected points, with exact gates.

"Stacking" — averaging the field in radial shells around a set of
selected positions — is the workhorse estimator for peak/halo/void
profiles.  For a Gaussian random field the angle-averaged expectation
is closed-form (BBKS 1986 section 7):

* value-selected points (voxels with u(x) = delta/sigma0 in a height
  band): E[delta(x + r) | u(x)] = u sigma0 psi(r) with
  psi = xi(r)/sigma0^2 — exact, no approximation;
* peaks of height nu and scaled curvature x = -lap(delta)/sigma2: the
  ANGLE-AVERAGED mean profile conditions only on (nu, x) — the
  gradient and traceless-Hessian constraints are odd / l=2 and cancel
  in the spherical average (the BBKS eq. 7.8 argument) — giving

      E[delta(r)] = [ (nu - gamma x) sigma0 psi(r)
                    + (x - gamma nu) (sigma0^2/sigma2) (-lap psi)(r) ]
                    / (1 - gamma^2)

  with gamma = sigma1^2/(sigma0 sigma2).  Limits pin the algebra:
  r -> 0 gives nu sigma0, and -lap at 0 gives x sigma2.

Device-native measurement: the stack over N_sel positions is one FFT
cross-correlation — Re[conj(W) D] per mode, one inverse transform,
then the SAME minimum-image radial binning as xi(r)
(validate/stats.py) — so the prediction runs the identical binning on
the smoothed power grid and residuals are pure sample noise plus (for
peak selection only) the lattice-maximum discretization bias.  No
per-position gathers, no scatter; selection masks are elementwise.

Reference: the reference has no stacking tools at all (SURVEY.md
section 0 — it renders fields and validates P(k)/variance only).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from randomfield_tpu.ops import grid as _grid
from randomfield_tpu.ops import power as _power
from randomfield_tpu.ops import transform as _transform
from randomfield_tpu.validate import stats as _stats

__all__ = [
    "stacked_profile",
    "peak_profile",
    "predicted_peak_profile",
    "mean_height_in_band",
]


@functools.partial(jax.jit, static_argnames=("shape", "spacing", "nbins"))
def _binned_cross_corr(w, d, shape, spacing, nbins):
    """Radially binned <w(x) d(x+r)> via one FFT cross-correlation."""
    cw = _transform.field_to_spectrum(w, spacing)
    cd = _transform.field_to_spectrum(d, spacing)
    nx, ny, nz = shape
    volume = nx * ny * nz * spacing**3
    p = (cw.real * cd.real + cw.imag * cd.imag) / volume
    # DC carries mean(w)*mean(d): E[mean(d)] = 0, but the realized mean
    # would offset every lag — drop it exactly like the xi estimator
    p = p.at[0, 0, 0].set(0.0)
    return _stats._binned_xi_from_power_grid(p, shape, spacing, nbins)


def stacked_profile(delta, weight, spacing, nbins=24, mesh=None):
    """Mean field value in radial shells around weighted positions.

    ``weight`` is any non-negative selection field on the same grid
    (a 0/1 mask of chosen voxels, a peak indicator, tracer counts —
    anything elementwise).  Returns ``(r_mean, profile, n_cells)``
    where ``profile(r) = sum_x w(x) delta(x+r) / sum_x w(x)`` averaged
    over each periodic minimum-image r shell (same bins as
    :func:`randomfield_tpu.validate.stats.calculate_correlation`; the
    zero-lag cell is excluded — report the on-position mean
    separately).  The realized field mean is subtracted (DC mode
    dropped), matching the xi estimator and the Gaussian expectations.

    With ``mesh`` (slab or pencil) both transforms and the shell
    binning run distributed (the cross-correlation flavor of the mesh
    xi machinery) — nothing field-sized is gathered.
    """
    d = jnp.asarray(delta)
    w = jnp.asarray(weight, d.dtype)
    if d.shape != w.shape:
        raise ValueError(
            f"field and weight must share a grid, got {d.shape} vs "
            f"{w.shape}"
        )
    shape = tuple(int(s) for s in d.shape[-3:])
    if mesh is not None:
        from randomfield_tpu.parallel.multihost import replicated_to_host

        fn = _stats._make_mesh_xi_multipoles(
            mesh, shape, float(spacing), int(nbins), (0,), 2, cross=True
        )
        counts, psums, rsum = fn(w, d)
        r, xi_wd, n = _stats._xi_host(
            replicated_to_host(counts), replicated_to_host(psums),
            replicated_to_host(rsum),
        )
        xi_wd = xi_wd[0] if xi_wd.ndim == 2 else xi_wd
        w_mean = float(jnp.mean(w))
        if w_mean <= 0:
            raise ValueError("weight field sums to zero: nothing selected")
        return r, xi_wd / w_mean, n
    counts, csum, rsum = _binned_cross_corr(
        w, d, shape, float(spacing), int(nbins)
    )
    r, xi_wd, n = _stats._xi_host(counts, csum, rsum)
    w_mean = float(jnp.mean(w))
    if w_mean <= 0:
        raise ValueError("weight field sums to zero: nothing selected")
    return r, xi_wd / w_mean, n


def peak_profile(delta, spacing, moments, nu_min=1.0, nu_max=None,
                 nbins=24):
    """Stacked profile around lattice peaks in a height band.

    ``moments`` is ``(sigma0_sq, sigma1_sq, sigma2_sq)`` from
    :func:`randomfield_tpu.validate.peaks.bbks_moments` of the render's
    smoothed spectrum — it normalizes heights (u = delta/sigma0) and
    curvatures (x = -lap(delta)/sigma2, computed spectrally with the
    full |k|^2, matching the moments).  Peaks are 27-cube maxima with
    ``nu_min <= u`` (and ``u < nu_max`` if given).  Returns
    ``(r_mean, profile, n_peaks, nu_bar, x_bar)`` — feed the measured
    ``nu_bar``/``x_bar`` to :func:`predicted_peak_profile` for the
    matched expectation.
    """
    from randomfield_tpu.validate.peaks import _cube_max

    d = jnp.asarray(delta)
    shape = tuple(int(s) for s in d.shape[-3:])
    s0 = float(np.sqrt(moments[0]))
    s2 = float(np.sqrt(moments[2]))
    u = d / jnp.asarray(s0, d.dtype)
    mask = (u == _cube_max(u)) & (u >= nu_min)
    if nu_max is not None:
        mask = mask & (u < nu_max)
    w = mask.astype(d.dtype)
    n_peaks = int(jnp.sum(w))
    if n_peaks == 0:
        raise ValueError(
            f"no peaks with nu >= {nu_min} — lower nu_min or smooth less"
        )
    lap = _laplacian(d, shape, float(spacing))
    nu_bar = float(jnp.sum(w * u) / n_peaks)
    x_bar = float(jnp.sum(w * (-lap)) / n_peaks) / s2
    r, prof, n = stacked_profile(d, w, spacing, nbins=nbins)
    return r, prof, n_peaks, nu_bar, x_bar


@functools.partial(jax.jit, static_argnames=("shape", "spacing"))
def _laplacian(d, shape, spacing):
    a = _transform.rfftn(d, norm="forward")
    k2 = _grid.ksq(shape, spacing, d.dtype)
    return _transform.irfftn(-k2 * a, shape, norm="forward")


def predicted_peak_profile(power, shape, spacing, nu_bar, x_bar=None,
                           smoothing_length=0.0, nbins=24,
                           interpolation="log10k"):
    """Exact Gaussian expectation of a stacked profile.

    With ``x_bar=None``: the value-selected conditional mean
    ``nu_bar sigma0 psi(r)`` — exact for any height-band mask (pass the
    measured mean height).  With ``x_bar``: the BBKS angle-averaged
    peak profile conditioning on height AND mean curvature (module
    docstring) — exact up to lattice-maximum discretization.  psi and
    -lap psi are binned through the IDENTICAL inverse transform +
    minimum-image shells as the estimator, on the smoothed power grid
    (P * exp(-k^2 s^2)), so the prediction is the exact expectation of
    :func:`stacked_profile`'s bins, not a continuum curve.  The
    spectral moments are grid sums of the same power grid.  Returns
    ``(r_mean, profile)``.
    """
    shape = tuple(int(s) for s in shape)
    table = _power.validate_power(power)
    _power.require_coverage(table, shape, float(spacing))
    kmag = _grid.kmag(shape, float(spacing), jnp.float32)
    pgrid = _power.interpolate_power(table, kmag, interpolation)
    k2 = kmag * kmag
    sm = float(smoothing_length)
    pgrid = pgrid * jnp.exp(-k2 * sm * sm)
    pgrid = jnp.where(kmag > 0, pgrid, 0.0)

    nx, ny, nz = shape
    volume = nx * ny * nz * float(spacing) ** 3
    nzh = nz // 2 + 1
    mult = np.full(nzh, 2.0)
    mult[0] = 1.0
    if nz % 2 == 0:
        mult[-1] = 1.0
    m = jnp.asarray(mult, jnp.float32)[None, None, :]
    s0sq = float(jnp.sum(m * pgrid)) / volume
    s1sq = float(jnp.sum(m * k2 * pgrid)) / volume
    s2sq = float(jnp.sum(m * k2 * k2 * pgrid)) / volume

    counts, psum, rsum = _stats._binned_xi_from_power_grid(
        pgrid, shape, float(spacing), int(nbins)
    )
    r, xi_b, _ = _stats._xi_host(counts, psum, rsum)
    psi = xi_b / s0sq
    s0 = np.sqrt(s0sq)
    if x_bar is None:
        return r, float(nu_bar) * s0 * psi
    counts, psum, rsum = _stats._binned_xi_from_power_grid(
        k2 * pgrid, shape, float(spacing), int(nbins)
    )
    _, neg_lap_xi, _ = _stats._xi_host(counts, psum, rsum)
    neg_lap_psi = neg_lap_xi / s0sq
    s2 = np.sqrt(s2sq)
    gamma = s1sq / (s0 * s2)
    a = (float(nu_bar) - gamma * float(x_bar)) / (1.0 - gamma**2)
    b = (float(x_bar) - gamma * float(nu_bar)) / (1.0 - gamma**2)
    return r, a * s0 * psi + b * (s0sq / s2) * neg_lap_psi


def mean_height_in_band(nu_min, nu_max=None):
    """E[u | nu_min <= u < nu_max] for a unit normal (truncated-normal
    mean) — the a-priori counterpart of the measured ``nu_bar``."""
    from jax.scipy.special import erf

    def phi(x):
        return np.exp(-0.5 * x * x) / np.sqrt(2.0 * np.pi)

    def cdf(x):
        return 0.5 * (1.0 + float(erf(x / np.sqrt(2.0))))

    lo = float(nu_min)
    if nu_max is None:
        return phi(lo) / (1.0 - cdf(lo))
    hi = float(nu_max)
    return (phi(lo) - phi(hi)) / (cdf(hi) - cdf(lo))
