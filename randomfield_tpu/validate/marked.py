"""Marked power spectra, with an exact Wick gate for linear marks.

The marked power spectrum (White 2016; Massara et al. 2021) reweights
the density field by a local function of its smoothed environment
before measuring P(k) — up-weighting low-density regions makes the
statistic sharply more sensitive to neutrino mass and modified gravity
than plain P(k).  The standard mark is

    m(x) = ((1 + delta_s) / (1 + delta_s + delta_R(x)))**p

with ``delta_R`` the density smoothed on scale ``R``; the marked field
is ``m(x) * delta(x)`` and its P(k) is measured with the ordinary
estimator.

Design: the smoothing is one spectrum multiply inside the
same jitted program as the mark evaluation (two transforms total), and
the measurement reuses :mod:`randomfield_tpu.validate.stats`'s one-hot
matmul binning — no new estimator machinery.

Exactness: for the LINEAR mark ``m = 1 + eps * delta_R`` the marked
field is ``g = delta + eps * delta_R * delta``, a quadratic functional
of the Gaussian field, and every term of ``E[P_hat_g]`` follows from
Wick's theorem ON THE DISCRETE PERIODIC LATTICE:

    xi_g(r) = xi(r) + eps^2 * (xi_RR(r) xi(r) + xi_X(r)^2)   (+ DC)

(the odd third-moment cross term vanishes identically for a Gaussian
field), where xi_RR / xi_X are the smoothed-smoothed and
smoothed-unsmoothed lag covariances on this grid's modes.  Forward
transforming that product grid gives the exact per-mode expectation
``E[|g_k|^2]/V``, binned with the estimator's own bins — so
measured-vs-predicted residuals are pure sample noise
(:func:`predicted_linear_marked_power`, gated in
``tests/test_marked.py``).  The White mark has no closed-form
expectation (it is a nonlinear functional); its gates are the exact
``p = 0`` identity and a deterministic Taylor comparison against the
linear mark.

Reference: the reference package has no marked statistics (SURVEY.md
section 0 — it renders Gaussian fields and validates P(k)/variance).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from randomfield_tpu.ops import grid as _grid
from randomfield_tpu.ops import transform as _transform
from randomfield_tpu.validate import stats as _stats

__all__ = [
    "smooth_field",
    "white_mark",
    "marked_field",
    "linear_marked_field",
    "calculate_marked_power",
    "predicted_linear_marked_power",
]


def _window_grid(shape, spacing, R, window, dtype):
    km = _grid.kmag(shape, float(spacing), dtype)
    if window == "gaussian":
        return jnp.exp(-0.5 * (km * R) ** 2)
    if window == "tophat":
        x = km * R
        xs = jnp.where(x > 1e-4, x, 1.0)
        w = 3.0 * (jnp.sin(xs) - xs * jnp.cos(xs)) / xs**3
        return jnp.where(x > 1e-4, w, 1.0 - x**2 / 10.0)
    raise ValueError(f"unknown window {window!r}: 'gaussian' or 'tophat'")


@functools.partial(
    jax.jit, static_argnames=("shape", "spacing", "R", "window")
)
def _smooth_jit(delta, shape, spacing, R, window):
    c = _transform.field_to_spectrum(delta, spacing)
    w = _window_grid(shape, spacing, R, window, delta.dtype)
    return _transform.spectrum_to_field(c * w, spacing, shape)


@functools.lru_cache(maxsize=16)
def _make_smooth_mesh(mesh, shape, spacing, R, window):
    """Distributed smoothing: sharded forward FFT, window multiply on
    the sharded spectrum, distributed inverse.  The window is even in k,
    so the product stays Hermitian and rides the half-pack c2r tail."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from randomfield_tpu.parallel import dfft
    from randomfield_tpu.parallel import pencil as _pencil
    from randomfield_tpu.parallel.mesh import SPACE_AXIS

    is_pencil = _pencil.is_pencil_mesh(mesh)
    spec_sharding = NamedSharding(
        mesh, P(None, _pencil.SPX_AXIS, _pencil.SPY_AXIS) if is_pencil
        else P(None, SPACE_AXIS, None)
    )
    ncells = shape[0] * shape[1] * shape[2]

    @jax.jit
    def fn(delta):
        w = jax.lax.with_sharding_constraint(
            _window_grid(shape, spacing, R, window, delta.dtype),
            spec_sharding,
        )
        if is_pencil:
            c = _pencil.rfftn_pencil(delta, shape, mesh)
            out = _pencil.irfftn_pencil(
                c * w, shape, mesh, assume_hermitian=True,
                input_layout="state1",
            )
        else:
            c = dfft.rfftn_slab(delta, shape, mesh)
            out = dfft.irfftn_slab(
                c * w, shape, mesh, assume_hermitian=True
            )
        return out / ncells

    return fn


def smooth_field(delta, spacing, R, window="gaussian", mesh=None):
    """Smooth a field on scale ``R`` (Mpc/h) by a spectrum multiply.

    ``window='gaussian'`` applies ``exp(-(kR)^2/2)`` (the
    :func:`randomfield_tpu.ops.power.filter_modes` convention);
    ``'tophat'`` the spherical top-hat ``3 (sin x - x cos x)/x^3``,
    x = kR (the sigma(R) window — equivalent to
    :func:`randomfield_tpu.models.voids.tophat_smooth`).

    With ``mesh`` the transforms run distributed (slab or pencil) and
    ``delta`` stays sharded end to end.
    """
    shape = tuple(int(s) for s in delta.shape[-3:])
    if mesh is not None:
        fn = _make_smooth_mesh(
            mesh, shape, float(spacing), float(R), str(window)
        )
        return fn(jnp.asarray(delta))
    return _smooth_jit(
        jnp.asarray(delta), shape, float(spacing), float(R), str(window)
    )


def white_mark(delta_R, p=2.0, delta_s=0.25):
    """The White (2016) mark ``((1+delta_s)/(1+delta_s+delta_R))**p``.

    ``p > 0`` up-weights underdense environments; ``p = 0`` is the
    constant mark (marked P(k) == P(k) exactly).  ``delta_R`` is
    clamped at ``-0.9 * (1 + delta_s)`` to keep the base positive for
    Gaussian fields (which are unbounded below, unlike real densities).
    """
    delta_s = float(delta_s)
    base = 1.0 + delta_s
    dr = jnp.maximum(jnp.asarray(delta_R), -0.9 * base)
    return (base / (base + dr)) ** float(p)


def marked_field(delta, spacing, R=10.0, p=2.0, delta_s=0.25,
                 window="gaussian", mesh=None):
    """``m(x) * delta(x)`` with the White mark of the R-smoothed field."""
    dr = smooth_field(delta, spacing, R, window, mesh=mesh)
    return white_mark(dr, p, delta_s) * jnp.asarray(delta)


def linear_marked_field(delta, spacing, eps, R=10.0, window="gaussian",
                        mesh=None):
    """``(1 + eps * delta_R) * delta`` — the exactly-predictable mark."""
    dr = smooth_field(delta, spacing, R, window, mesh=mesh)
    return (1.0 + float(eps) * dr) * jnp.asarray(delta)


def calculate_marked_power(delta, spacing, nbins=32, R=10.0, p=2.0,
                           delta_s=0.25, window="gaussian", mark=None,
                           mesh=None):
    """Marked power spectrum: P(k) of ``m * delta``.

    ``mark`` overrides the White mark with any callable
    ``delta_R -> m`` (evaluated on the R-smoothed field).  Returns
    ``(k_mean, p_marked, n_modes)`` like
    :func:`randomfield_tpu.validate.stats.calculate_power` (whose
    binning this rides); the field mean only touches the excluded DC
    mode.  With ``mesh`` the smoothing transforms and the estimator run
    distributed (slab or pencil) — the field, its smoothed companion
    and the marked product stay sharded.
    """
    dr = smooth_field(delta, spacing, R, window, mesh=mesh)
    m = white_mark(dr, p, delta_s) if mark is None else mark(dr)
    return _stats.calculate_power(
        m * jnp.asarray(delta), spacing, nbins=nbins, mesh=mesh
    )


@functools.partial(
    jax.jit,
    static_argnames=("shape", "spacing", "eps", "R", "window"),
)
def _linear_marked_expectation(pgrid, shape, spacing, eps, R, window):
    w = _window_grid(shape, spacing, R, window, jnp.float32)
    xi = _transform.spectrum_to_field(
        pgrid.astype(jnp.complex64), spacing, shape
    )
    xi_rr = _transform.spectrum_to_field(
        (pgrid * w * w).astype(jnp.complex64), spacing, shape
    )
    xi_x = _transform.spectrum_to_field(
        (pgrid * w).astype(jnp.complex64), spacing, shape
    )
    xi_tau = xi_rr * xi + xi_x * xi_x
    p_tau = jnp.real(_transform.field_to_spectrum(xi_tau, spacing))
    e_pgrid = pgrid + eps * eps * p_tau
    e_pgrid = e_pgrid.at[0, 0, 0].set(0.0)
    return e_pgrid


def predicted_linear_marked_power(power, shape, spacing, eps, R=10.0,
                                  nbins=32, window="gaussian",
                                  interpolation="log10k"):
    """Exact expectation of the linear-mark marked power spectrum.

    ``E[P_hat_g(k)] = P(k) + eps^2 FT[xi_RR xi + xi_X^2](k)`` on this
    grid's discrete modes (Wick's theorem; the odd cross term vanishes
    for a Gaussian field), binned with
    :func:`~randomfield_tpu.validate.stats.calculate_power`'s exact
    bins/masks — residuals against
    ``calculate_power(linear_marked_field(...))`` are pure sample
    noise.  ``eps = 0`` reduces to the plain predicted P(k) binning.
    """
    from randomfield_tpu.ops import power as _power

    shape = tuple(int(s) for s in shape)
    table = _power.validate_power(power)
    _power.require_coverage(table, shape, float(spacing))
    kmag = _grid.kmag(shape, float(spacing), jnp.float32)
    pgrid = _power.interpolate_power(table, kmag, interpolation)
    pgrid = jnp.where(kmag > 0, pgrid, 0.0)
    e_pgrid = _linear_marked_expectation(
        pgrid, shape, float(spacing), float(eps), float(R), str(window)
    )
    return _stats.bin_power_grid(e_pgrid, shape, float(spacing), nbins)
