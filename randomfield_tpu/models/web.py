"""Cosmic-web classification from the tidal (T-web) tensor.

Capability extension beyond the reference package: classify every voxel
of a realization by the signature of the tidal tensor
``T_ij = d_i d_j phi`` (``grad^2 phi = delta``) — the standard T-web
scheme (Hahn et al. 2007): the count of eigenvalues above a threshold
maps to void (0), sheet (1), filament (2), knot (3).

For an isotropic Gaussian field the POINT statistics of T are exactly
known (Doroshkevich 1970): with unit-variance normalization the six
independent components are jointly Gaussian with

    Var(T_ii) = 3 c,   Cov(T_ii, T_jj) = c,   Var(T_ij, i != j) = c

(c = sigma_delta^2 / 15), which fixes the eigenvalue-signature
fractions at threshold 0 to universal constants (~8 / 42 / 42 / 8 %).
The test suite Monte-Carlos that exact covariance independently and
gates the field-measured fractions against it.

Design: eigenvalues of the symmetric 3x3 per voxel come from
the closed-form trigonometric solution (no LAPACK, no batching loop) —
pure elementwise jnp that XLA fuses across the grid; the six tensor
components are rendered seed-direct through the engine's fused spectral
kernels (ops/derived.py kind='tidal'), so the pipeline works at the HBM
ceiling and on slab/pencil meshes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from randomfield_tpu.ops.derived import TIDAL_PAIRS

__all__ = [
    "eigenvalues_sym3",
    "classify_web",
    "web_fractions",
    "WEB_TYPES",
    "TIDAL_PAIRS",
    "doroshkevich_fractions",
]

WEB_TYPES = ("void", "sheet", "filament", "knot")


@jax.jit
def eigenvalues_sym3(t):
    """Eigenvalues of symmetric 3x3 tensors, descending: (3, ...) <- (6, ...).

    ``t`` packs (xx, yy, zz, xy, xz, yz) in :data:`TIDAL_PAIRS` order
    with arbitrary trailing shape.  Closed-form trigonometric solution
    (Smith 1961): exact for distinct eigenvalues, graceful (clamped
    acos) at degeneracies — elementwise, so XLA fuses it over the grid
    instead of calling a batched eigensolver.
    """
    a00, a11, a22, a01, a02, a12 = (t[i] for i in range(6))
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (
        b00 * b00 + b11 * b11 + b22 * b22
        + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)
    )
    p = jnp.sqrt(p2 / 6.0)
    safe_p = jnp.where(p > 0, p, 1.0)
    # r = det(B/p) / 2 for B = A - q I
    det_b = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    )
    r = jnp.clip(det_b / (2.0 * safe_p * safe_p * safe_p), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    two_pi_3 = jnp.asarray(2.0 * np.pi / 3.0, t.dtype)
    lam1 = q + 2.0 * p * jnp.cos(phi)
    lam3 = q + 2.0 * p * jnp.cos(phi + two_pi_3)
    lam2 = 3.0 * q - lam1 - lam3
    zero = jnp.zeros_like(p)
    lam1 = jnp.where(p > 0, lam1, q + zero)
    lam2 = jnp.where(p > 0, lam2, q + zero)
    lam3 = jnp.where(p > 0, lam3, q + zero)
    return jnp.stack([lam1, lam2, lam3])


@functools.partial(jax.jit, static_argnames=())
def _classify(t, threshold):
    lam = eigenvalues_sym3(t)
    return jnp.sum(lam > threshold, axis=0).astype(jnp.int8)


def classify_web(tidal, threshold=0.0):
    """Per-voxel eigenvalue-signature class of a packed tidal tensor.

    ``tidal``: (6, ...) components in :data:`TIDAL_PAIRS` order (from
    ``Generator.generate_tidal_field`` or ``ops.derived.delta_to_tidal``).
    Returns int8 classes 0..3 = the count of eigenvalues above
    ``threshold`` — void / sheet / filament / knot (:data:`WEB_TYPES`).
    A positive threshold (in units of the field, commonly ~0.2-0.4 for
    smoothed fields) sharpens knots/voids (Forero-Romero et al. 2009).
    """
    t = jnp.asarray(tidal)
    return _classify(t, jnp.asarray(threshold, t.dtype))


def web_fractions(classes):
    """Volume fractions of (void, sheet, filament, knot), host float64."""
    c = np.asarray(classes).ravel()
    return np.bincount(c, minlength=4).astype(np.float64) / c.size


def doroshkevich_fractions(threshold=0.0, sigma=1.0, n_samples=2_000_000,
                           seed=0):
    """Exact-covariance Monte Carlo of the Gaussian point statistics.

    Samples tidal tensors directly from the Doroshkevich covariance
    (module docstring) for a field of standard deviation ``sigma`` and
    returns the four signature fractions at ``threshold``.  This is the
    INDEPENDENT oracle the field pipeline is gated against: it never
    touches a grid, an FFT, or the engine's kernels.  float64, host.
    """
    rng = np.random.RandomState(seed)
    c = sigma**2 / 15.0
    sc = np.sqrt(c)
    # diagonal: t_ii = sqrt(2 c) g_i + sqrt(c) g0  (Var 3c, pairwise Cov c)
    g0 = rng.normal(size=n_samples)
    diag = np.sqrt(2.0 * c) * rng.normal(size=(3, n_samples)) + sc * g0
    off = sc * rng.normal(size=(3, n_samples))
    t = np.empty((n_samples, 3, 3))
    t[:, 0, 0], t[:, 1, 1], t[:, 2, 2] = diag
    t[:, 0, 1] = t[:, 1, 0] = off[0]
    t[:, 0, 2] = t[:, 2, 0] = off[1]
    t[:, 1, 2] = t[:, 2, 1] = off[2]
    lam = np.linalg.eigvalsh(t)
    # T and -T are equidistributed: counting both doubles the samples and
    # makes the sheet/filament symmetry at threshold 0 exact
    counts = np.concatenate([
        (lam > threshold).sum(axis=1), (-lam > threshold).sum(axis=1)
    ])
    return np.bincount(counts, minlength=4).astype(np.float64) / (2 * n_samples)
