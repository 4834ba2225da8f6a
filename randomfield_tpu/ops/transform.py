"""Fourier transforms with physical normalization + Hermitian utilities.

Reference parity: ``randomfield/transform.py`` (``allocate``, ``Plan``,
``Plan.execute``, ``symmetrize``, ``is_hermitian``).  The reference wraps
pyfftw: byte-aligned in-place buffers, wisdom-planned packed c2r/r2c
transforms, explicit scaling of FFTW's unnormalized output.  Under XLA the
FFT library (cuFFT on the GPU) owns planning and XLA owns layout and buffer
reuse (donation), so this module is a thin, *convention-defining* layer:

Physical conventions
--------------------
A real field delta(x) on an (nx, ny, nz) grid with spacing ``a`` and box
volume ``V = nx*ny*nz * a**3`` has packed spectrum ``c_k`` with

    delta(x)  =  (1 / V) * sum_k c_k exp(+i k.x)        (synthesis)
    c_k       =  a^3 * sum_x delta(x) exp(-i k.x)       (analysis)

so ``c_k`` approximates the continuum Fourier transform
``integral d^3x delta(x) exp(-i k.x)`` and the power spectrum estimator is
``P(k) = <|c_k|^2> / V``.  These compose to the identity, and the Gaussian
random field recipe is: draw ``c_k`` with variance ``V * P(k)`` per mode.

The hot path in :mod:`randomfield_tpu.engine` folds ``1/V`` into the
precomputed sigma(k) grid so the render is a raw ``norm='forward'`` irfftn
with no extra scaling pass.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from randomfield_tpu.ops import grid as _grid

__all__ = [
    "spectrum_to_field",
    "field_to_spectrum",
    "irfftn",
    "rfftn",
    "symmetrize",
    "is_hermitian",
    "fft_backend",
    "ifft_minor",
    "irfft_minor",
    "rotate_last3",
]


@functools.lru_cache(maxsize=1)
def fft_backend() -> str:
    """The 3-D transform implementation: ``RF_FFT_BACKEND`` if set to
    'xla', 'safe' or 'ct', else 'xla'.

    'xla' (default) is ``jnp.fft`` — XLA's FFT op, cuFFT on the GPU.
    'safe' runs every 1-D transform on the minor axis with barrier-pinned
    transposes between them; 'ct' runs Cooley-Tukey einsum matmuls
    (ops/ctfft.py).  Both compute the same transform as 'xla' and are
    kept as alternatives for comparison.
    """
    env = os.environ.get("RF_FFT_BACKEND")
    if env in ("xla", "safe", "ct"):
        return env
    return "xla"


_B = jax.lax.optimization_barrier


def rotate_last3(x):
    """(..., A, B, C) -> (..., B, C, A), physically (barrier-pinned)."""
    perm = (*range(x.ndim - 3), x.ndim - 2, x.ndim - 1, x.ndim - 3)
    return _B(jnp.transpose(x, perm))


# XLA's GPU inverse FFT scales its output by 1/n through a cuBLAS call
# whose element count is a 32-bit int: from 2^31 output elements on the
# scaling is silently skipped (seen on an H100 as a 2048^2 variance
# excess in a 2048^3 render whose slab shards hold 2^31 cells).  Inverse
# FFTs that large run as a lax.map over leading-axis chunks below it.
MAX_FFT_ELEMENTS = 2**31 - 1


def _below_fft_limit(fn, x, out_elements):
    """``fn(x)``, mapped over chunks of x's leading axis when the output
    would have more than :data:`MAX_FFT_ELEMENTS` elements."""
    if out_elements <= MAX_FFT_ELEMENTS or x.ndim < 2:
        return fn(x)
    n0 = x.shape[0]
    chunks = next((c for c in range(2, n0 + 1)
                   if n0 % c == 0 and out_elements // c <= MAX_FFT_ELEMENTS),
                  n0)
    out = jax.lax.map(fn, x.reshape(chunks, n0 // chunks, *x.shape[1:]))
    return out.reshape(n0, *out.shape[2:])


def ifft_minor(x):
    """Unnormalized inverse complex FFT along the minor axis."""
    return _below_fft_limit(
        lambda t: jnp.fft.ifft(t, axis=-1, norm="forward"), x, x.size)


def irfft_minor(c, n, assume_hermitian=False):
    """c2r along the minor axis (last transform of an inverse chain).

    Valid when the pre-transform is complete in all other axes (i.e. this
    is the LAST transform), where Hermitianity of the original packed
    spectrum makes the result real.  The library c2r (``jnp.fft.irfft``,
    cuFFT on the GPU) runs; like numpy/FFTW it projects any
    non-Hermitian residue away.

    ``assume_hermitian=True`` (render paths, where the spectrum has been
    through ``symmetrize``) lets the 'ct' backend use the half-length
    complex pack (ops/ctfft.py:irfft_half_axis), which is ONLY exact for
    genuinely Hermitian input.  The library c2r is the default because
    it is faster on the H100: 21.2 ms against 27.7 ms for the whole
    1024^3 staged tail (PERF.md "Bring-up findings").
    """
    from randomfield_tpu.ops import ctfft

    if (assume_hermitian and fft_backend() == "ct" and n % 2 == 0
            and ctfft.can_ct(n // 2)):
        return ctfft.irfft_half_axis(c, n, axis=-1)
    return _below_fft_limit(
        lambda t: jnp.fft.irfft(t, n, axis=-1, norm="forward"), c,
        c.size // c.shape[-1] * n)


def _irfftn_safe(c, shape, assume_hermitian=False):
    nx, ny, nz = shape
    x = rotate_last3(c)          # (..., ky, kz, kx)
    x = ifft_minor(x)            # x done
    x = rotate_last3(x)          # (..., kz, x, ky)
    x = ifft_minor(x)            # y done
    x = rotate_last3(x)          # (..., x, y, kz)
    return irfft_minor(x, nz, assume_hermitian)  # z done -> real


def _rfftn_safe(x):
    nz = x.shape[-1]
    nzh = nz // 2 + 1
    c = jnp.fft.fft(x.astype(jnp.complex64 if x.dtype == jnp.float32
                             else jnp.complex128), axis=-1, norm="backward")
    c = _B(c[..., :nzh])         # z done, packed
    c = rotate_last3(c)          # (..., y, kz, x)... minor = x
    c = jnp.fft.fft(c, axis=-1, norm="backward")
    c = rotate_last3(c)          # minor = y
    c = jnp.fft.fft(c, axis=-1, norm="backward")
    return rotate_last3(c)       # back to (..., kx, ky, kz)


def _irfftn_ct(c, shape):
    from randomfield_tpu.ops import ctfft

    x = ctfft.ifft_ct(c, axis=-3)
    x = ctfft.ifft_ct(x, axis=-2)
    return ctfft.irfft_ct(x, shape[-1], axis=-1)


def _rfftn_ct(x):
    from randomfield_tpu.ops import ctfft

    nzh = x.shape[-1] // 2 + 1
    c = ctfft.fft_ct(x, axis=-1)[..., :nzh]
    c = ctfft.fft_ct(c, axis=-2)
    return ctfft.fft_ct(c, axis=-3)


def irfftn(c, shape, norm="forward", assume_hermitian=False):
    """Unnormalized-inverse packed c2r transform (sum over modes).

    ``norm='forward'`` means the inverse applies no 1/N scaling — the
    direct analog of FFTW's unnormalized c2r that the reference's
    ``Plan.execute`` runs (ref: transform.py:Plan).

    ``assume_hermitian=True`` lets the 'ct' backend use the half-pack
    c2r tail; only pass it for spectra that went through ``symmetrize``
    (see :func:`irfft_minor`).
    """
    backend = fft_backend()
    if backend == "ct":
        assert norm == "forward"
        return _irfftn_ct(c, shape)
    if backend == "safe" or (norm == "forward"
                             and c.size // c.shape[-1] * shape[-1]
                             > MAX_FFT_ELEMENTS):
        # the per-axis path, whose inverse FFTs stay below the limit
        assert norm == "forward"
        return _irfftn_safe(c, shape, assume_hermitian)
    return jnp.fft.irfftn(c, s=shape, axes=(-3, -2, -1), norm=norm)


def rfftn(x, norm="forward"):
    """Packed r2c transform matching :func:`irfftn`'s convention."""
    backend = fft_backend()
    if backend in ("safe", "ct"):
        c = _rfftn_ct(x) if backend == "ct" else _rfftn_safe(x)
        if norm == "forward":
            n = x.shape[-3] * x.shape[-2] * x.shape[-1]
            c = c / jnp.asarray(n, c.real.dtype)
        return c
    return jnp.fft.rfftn(x, axes=(-3, -2, -1), norm=norm)


def spectrum_to_field(c, spacing, shape):
    """Synthesis: delta(x) = (1/V) sum_k c_k exp(ik.x)."""
    nx, ny, nz = shape
    volume = nx * ny * nz * spacing**3
    return irfftn(c / jnp.asarray(volume, dtype=c.real.dtype), shape)


def field_to_spectrum(delta, spacing):
    """Analysis: c_k = a^3 sum_x delta(x) exp(-ik.x)."""
    c = rfftn(delta, norm="backward")
    return c * jnp.asarray(spacing**3, dtype=delta.dtype)


def _symmetrize_plane(z, scale_self_conjugate):
    nx, ny = z.shape[-2], z.shape[-1]
    self_conj, canonical = _grid.hermitian_plane_masks(nx, ny)
    partner = _grid.conjugate_plane(z)
    out = jnp.where(canonical, z, partner)
    scale = np.sqrt(2.0) if scale_self_conjugate else 1.0
    real_part = (scale * z.real).astype(z.dtype)  # imag -> 0 on cast
    return jnp.where(self_conj, real_part, out)


def symmetrize(c, scale_self_conjugate=True):
    """Enforce the Hermitian constraint on a packed half-spectrum.

    Interior kz planes (0 < kz < Nyquist) of an rfft-packed spectrum are
    unconstrained; only the kz = 0 plane and (for even nz) the kz = Nyquist
    plane must satisfy ``c(-kx, -ky) = conj(c(kx, ky))`` for the c2r output
    to be exactly real.  (Ref: transform.py:symmetrize.)

    For each conjugate pair on those planes the canonical member is kept
    and its partner overwritten with the conjugate.  Self-conjugate modes
    (kx in {0, Nx/2}, ky in {0, Ny/2}) keep only their real part; with
    ``scale_self_conjugate=True`` (the sampling convention) that real part
    is multiplied by sqrt(2) so a unit-variance complex draw keeps unit
    *total* variance after its imaginary half is dropped.  Pass ``False``
    for the pure idempotent projection (e.g. to test Hermitian-ness).

    ``c`` may have leading batch dimensions; the last three axes are the
    packed spectrum.
    """
    nzh = c.shape[-1]
    # nz even iff the packed length came from an even real length; both
    # nz = 2*(nzh-1) and nz = 2*nzh - 1 pack to nzh, so callers who care
    # about odd nz pass spectra where the last plane is NOT self-conjugate.
    # We follow the reference and treat the last plane as Nyquist (even nz)
    # unless told otherwise via keyword.
    return symmetrize_with_shape(c, nz=2 * (nzh - 1), scale_self_conjugate=scale_self_conjugate)


def symmetrize_with_shape(c, nz, scale_self_conjugate=True):
    """:func:`symmetrize` with the real-space nz given explicitly (odd-nz safe)."""
    planes = _grid.self_conjugate_kz_planes(nz)
    for p in planes:
        fixed = _symmetrize_plane(c[..., :, :, p], scale_self_conjugate)
        c = c.at[..., :, :, p].set(fixed)
    return c


def is_hermitian(c, nz=None, rtol=1e-5, atol=1e-6):
    """True if the packed spectrum corresponds to a real field.

    Checks that the self-conjugate kz planes are invariant under the pure
    Hermitian projection (ref: transform.py:is_hermitian).
    """
    if nz is None:
        nz = 2 * (c.shape[-1] - 1)
    proj = symmetrize_with_shape(c, nz=nz, scale_self_conjugate=False)
    return bool(jnp.allclose(c, proj, rtol=rtol, atol=atol))
