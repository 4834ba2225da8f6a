"""Standard (Zel'dovich) BAO reconstruction.

The canonical density-field analysis the mock stack feeds (Eisenstein
et al. 2007; the BOSS/DESI pipeline step): estimate the large-scale
displacement from the observed field, move the tracers back, and
sharpen the BAO feature that nonlinear bulk flows smeared.

    psi_hat(k) = i k / k^2 * S(k) delta_g(k) / [ b (1 + beta mu^2) ]
    delta_d    = field moved BACK by -psi_hat          ("displaced")
    delta_s    = uniform grid moved back by -psi_hat   ("shifted")
    delta_rec  = delta_d - delta_s

with S(k) = exp(-k^2 Sigma^2 / 2) the engine's Gaussian smoothing
convention (ops/power.filter_modes), b the linear tracer bias and
beta = f/b removing the linear Kaiser distortion (``f=0`` for
real-space input).  The combination delta_d - delta_s cancels the
shift-induced large-scale modes, leaving the linearized field.

Everything is grid-shaped and jitted (device-native: the "catalog" is the
painted field, models/zeldovich.py conventions); catalog-level
workflows displace their own positions with
:func:`displacement_at_positions`.

Exactness anchors gated in tests/test_reconstruction.py: with
``smoothing=0, bias=1, f=0`` on a LINEAR field, ``psi_hat`` equals the
engine's seed-direct Zel'dovich displacement field exactly; on a
Zel'dovich-evolved mock, reconstruction measurably raises the
cross-correlation with the initial linear field at quasi-linear k
(the physical point of the method).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from randomfield_tpu.ops import derived as _derived
from randomfield_tpu.ops import grid as _grid
from randomfield_tpu.ops import transform as _transform

__all__ = [
    "estimate_displacement",
    "displacement_at_positions",
    "reconstruct_field",
]


@functools.partial(jax.jit,
                   static_argnames=("shape", "spacing", "los_axis"))
def _estimate(delta, shape, spacing, sigma_s, bias, f, los_axis):
    a = _transform.rfftn(delta, norm="forward")
    inv = _derived._inv_ksq(shape, spacing, delta.dtype)
    kx, ky, kz = _derived._grad_kvectors(shape, spacing, delta.dtype)
    k2 = _grid.ksq(shape, spacing, delta.dtype)
    smooth = jnp.exp(-0.5 * k2 * jnp.asarray(sigma_s, delta.dtype) ** 2)
    # linear Kaiser removal: delta_g = b (1 + beta mu^2) delta
    kvecs = _grid.kvectors(shape, spacing, delta.dtype)
    klos = kvecs[los_axis]
    bc = [None, None, None]
    bc[los_axis] = slice(None)
    mu2 = jnp.where(k2 > 0, klos[tuple(bc)] ** 2 / jnp.where(k2 > 0, k2, 1.0),
                    0.0)
    denom = jnp.asarray(bias, delta.dtype) \
        + jnp.asarray(f, delta.dtype) * mu2
    a = a * smooth / denom
    comps = []
    for kvec, bcast in (
        (kx, (slice(None), None, None)),
        (ky, (None, slice(None), None)),
        (kz, (None, None, slice(None))),
    ):
        grad_k = a * (1j * kvec[bcast] * inv)
        comps.append(_transform.irfftn(grad_k, shape, norm="forward"))
    return jnp.stack(comps)


def estimate_displacement(delta, spacing, smoothing=10.0, bias=1.0, f=0.0,
                          los_axis=2):
    """Estimated Zel'dovich displacement psi_hat [Mpc/h], (3, ...).

    ``smoothing`` is the reconstruction Gaussian Sigma in Mpc/h
    (typically 10-15); ``bias``/``f`` divide out the linear tracer
    model ``b (1 + beta mu^2)`` along ``los_axis``.
    """
    delta = jnp.asarray(delta)
    shape = tuple(int(s) for s in delta.shape[-3:])
    return _estimate(delta, shape, float(spacing), float(smoothing),
                     float(bias), float(f), int(los_axis))


def displacement_at_positions(psi, positions, spacing):
    """NGP-read a displacement grid at comoving positions (host numpy).

    ``psi`` is (3, nx, ny, nz); ``positions`` is (N, 3) Mpc/h in the
    periodic box.  Returns (N, 3).  (Catalog-level reconstruction:
    move galaxies by ``-psi_hat`` at their positions, and the random
    catalog by ``-psi_hat`` likewise.)
    """
    psi = np.asarray(psi)
    shape = np.array(psi.shape[-3:])
    cells = np.floor(np.asarray(positions, np.float64)
                     / float(spacing)).astype(np.int64) % shape
    return np.stack([psi[c][tuple(cells.T)] for c in range(3)], axis=1)


def reconstruct_field(delta, spacing, smoothing=10.0, bias=1.0, f=0.0,
                      los_axis=2, window="cic"):
    """Grid-level reconstruction: returns ``(delta_rec, psi_hat)``.

    Mass elements at cell centers weighted ``1 + delta`` move BACK by
    ``-psi_hat`` and are repainted (``delta_d``); an unweighted uniform
    grid moves the same way (``delta_s``); ``delta_rec = delta_d -
    delta_s``.  One painting window for both, so the window's
    systematics cancel in the difference.
    """
    from randomfield_tpu.models import zeldovich as _zl

    delta = jnp.asarray(delta)
    shape = tuple(int(s) for s in delta.shape[-3:])
    psi = estimate_displacement(delta, spacing, smoothing=smoothing,
                                bias=bias, f=f, los_axis=los_axis)
    q = _zl.lagrangian_positions(shape, float(spacing), delta.dtype)
    moved = q - psi
    delta_d, _ = _zl.paint(moved, shape, float(spacing),
                           weights=1.0 + delta, window=window)
    delta_s, _ = _zl.paint(moved, shape, float(spacing), window=window)
    return delta_d - delta_s, psi
