"""k-space geometry for packed real-to-complex (rfft) spectra.

Reference parity: the k-geometry halves of ``randomfield/transform.py`` and
``randomfield/powertools.py`` (``get_k_bounds``, ``fill_with_log10k``).  The
reference writes log10|k| *in place* into its pyfftw-aligned buffer; here
the k-mesh is a pure function of (shape, spacing) that XLA constant-folds or
fuses into consumers, so nothing is materialized unless explicitly asked.

Conventions
-----------
* Grids are ``(nx, ny, nz)`` real fields with uniform ``spacing`` (Mpc/h by
  convention, but any length unit works — k comes out in its inverse).
* The packed half-spectrum has shape ``(nx, ny, nz // 2 + 1)`` — numpy/XLA
  rfft packing along the *last* axis (the reference packs the same way).
* Wavenumbers are angular: ``k = 2 * pi * f`` with ``f`` the numpy fft
  frequencies, so the fundamental mode of a box of side ``L`` is ``2*pi/L``
  and the Nyquist mode is ``pi / spacing``.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

__all__ = [
    "half_shape",
    "kvectors",
    "kmag",
    "ksq",
    "fill_with_log10k",
    "get_k_bounds",
    "conjugate_plane",
    "hermitian_plane_masks",
    "self_conjugate_kz_planes",
]

TWO_PI = 2.0 * np.pi


def half_shape(shape: tuple[int, int, int]) -> tuple[int, int, int]:
    """Shape of the packed rfft half-spectrum for a real field of ``shape``."""
    nx, ny, nz = shape
    return (nx, ny, nz // 2 + 1)


def kvectors(shape, spacing, dtype=jnp.float32):
    """Angular wavenumber 1-D arrays ``(kx, ky, kz)`` for the half-spectrum.

    ``kx`` and ``ky`` follow full fft ordering (positive then negative
    frequencies); ``kz`` follows rfft ordering (non-negative only).
    """
    nx, ny, nz = shape
    kx = TWO_PI * np.fft.fftfreq(nx, d=spacing)
    ky = TWO_PI * np.fft.fftfreq(ny, d=spacing)
    kz = TWO_PI * np.fft.rfftfreq(nz, d=spacing)
    return (
        jnp.asarray(kx, dtype=dtype),
        jnp.asarray(ky, dtype=dtype),
        jnp.asarray(kz, dtype=dtype),
    )


def ksq(shape, spacing, dtype=jnp.float32):
    """|k|^2 on the packed half-spectrum, shape ``half_shape(shape)``."""
    kx, ky, kz = kvectors(shape, spacing, dtype)
    return (
        kx[:, None, None] * kx[:, None, None]
        + ky[None, :, None] * ky[None, :, None]
        + kz[None, None, :] * kz[None, None, :]
    )


def kmag(shape, spacing, dtype=jnp.float32):
    """|k| on the packed half-spectrum, shape ``half_shape(shape)``."""
    return jnp.sqrt(ksq(shape, spacing, dtype))


def fill_with_log10k(shape, spacing, dtype=jnp.float32, dc_value=None):
    """log10|k| per packed mode (ref: powertools.fill_with_log10k).

    The DC mode has |k| = 0; its log10 is replaced by ``dc_value``
    (default: log10 of the smallest positive |k| minus 20 decades, i.e. a
    finite sentinel far below any tabulated k so interpolation clamps to the
    table edge and downstream code can mask the DC mode explicitly).
    """
    k2 = ksq(shape, spacing, jnp.float64 if dtype == jnp.float64 else jnp.float32)
    kmin, _ = get_k_bounds(shape, spacing)
    if dc_value is None:
        dc_value = np.log10(kmin) - 20.0
    safe = jnp.where(k2 > 0, k2, 1.0)
    out = 0.5 * jnp.log10(safe)
    return jnp.where(k2 > 0, out, dtype(dc_value)).astype(dtype)


def get_k_bounds(shape, spacing) -> tuple[float, float]:
    """(kmin, kmax) over the non-DC modes (ref: powertools.get_k_bounds).

    kmin is the fundamental of the longest box side, ``2*pi / (n_max *
    spacing)``; kmax is the corner-mode magnitude ``sqrt(sum_i k_nyq_i^2)``
    computed exactly from the per-axis extreme frequencies.
    """
    nx, ny, nz = shape
    kmin = TWO_PI / (max(nx, ny, nz) * spacing)
    kmax2 = 0.0
    for n in (nx, ny):
        kmax2 += float(np.max(np.abs(TWO_PI * np.fft.fftfreq(n, d=spacing)))) ** 2
    kmax2 += float(np.max(TWO_PI * np.fft.rfftfreq(nz, d=spacing))) ** 2
    return float(kmin), float(np.sqrt(kmax2))


def conjugate_plane(z):
    """Map a (..., nx, ny) plane c(kx, ky) -> conj(c(-kx, -ky)).

    Operates on the last two axes (leading batch axes pass through).  The
    index map j -> (-j) mod n is flip followed by a one-step roll; both
    run on the REAL component lattices, and complex values are only ever
    formed from already-moved real parts.
    """
    import jax

    def negmap(a):
        a = jnp.roll(jnp.flip(a, axis=-2), 1, axis=-2)
        return jnp.roll(jnp.flip(a, axis=-1), 1, axis=-1)

    if jnp.iscomplexobj(z):
        return jax.lax.complex(negmap(z.real), -negmap(z.imag))
    return negmap(z)


@functools.lru_cache(maxsize=None)
def hermitian_plane_masks(nx: int, ny: int):
    """Static masks for a self-conjugate kz-plane.

    Returns ``(self_conj, canonical)`` numpy bool arrays of shape (nx, ny):

    * ``self_conj`` — modes that are their own Hermitian partner, i.e.
      (kx, ky) with kx in {0, nx/2} and ky in {0, ny/2} (even dims only);
      these must be real.
    * ``canonical`` — exactly one member of each conjugate pair
      {(i, j), ((-i) % nx, (-j) % ny)}, chosen lexicographically; the
      non-canonical member is overwritten with the conjugate of its partner.
    """
    i = np.arange(nx)[:, None]
    j = np.arange(ny)[None, :]
    ni = (-i) % nx
    nj = (-j) % ny
    self_conj = (i == ni) & (j == nj)
    canonical = (i < ni) | ((i == ni) & (j <= nj))
    return self_conj, canonical


def self_conjugate_kz_planes(nz: int) -> tuple[int, ...]:
    """Indices of kz planes that must be internally Hermitian.

    kz = 0 always; kz = Nyquist (last packed index) only when nz is even.
    """
    if nz % 2 == 0:
        return (0, nz // 2)
    return (0,)
