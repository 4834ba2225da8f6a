"""Cooley-Tukey FFTs as matmul pairs (einsum), any axis.

An alternative to the FFT library for backends whose 1-D FFT lowering
is a direct O(n)-per-element DFT:

* A two-stage Cooley-Tukey split n = A*B lowers the work to A+B MACs
  per element (32+32 vs 1024 at n=1024, a 16x FLOP cut) and expresses
  every step as einsum contractions — plain matmuls — plus one tiny
  twiddle multiply that XLA fuses.  No FFT custom-call at all.
* ``RF_FFT_BACKEND=ct`` routes the 3-D transforms here; the half-length
  c2r pack (:func:`irfft_half_axis`) serves the render tails (see
  ops/transform.py:irfft_minor).

Derivation (inverse transform, e^{+2 pi i jk/n}; forward = conjugate):
with n = A*B, j = a*B + b, k = c + A*d,

    X[c + A d] = sum_b W_n^{bc} W_B^{bd} ( sum_a x[aB+b] W_A^{ac} )

      S1[c,b]  = sum_a W_A[a,c] x[a,b]        (einsum over a)
      M [c,b]  = S1[c,b] * T[c,b],  T = W_n^{bc}   (fused elementwise)
      X [d,c]  = sum_b W_B[b,d] M[c,b]        (einsum over b)

and flattening (d, c) row-major is exactly k = c + A*d.

DFT/twiddle matrices are built in float64 and cast once; two-stage f32
accuracy is ~1e-6 relative (tested against numpy at many n).  Prime n
falls back to the native minor-axis FFT (which is correct everywhere).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["fft_ct", "ifft_ct", "irfft_ct", "can_ct"]


def _factor(n: int) -> tuple[int, int]:
    """Split n = A*B with A <= B, A as large as possible (A=1 if prime)."""
    for a in range(int(math.isqrt(n)), 1, -1):
        if n % a == 0:
            return a, n // a
    return 1, n


def can_ct(n: int) -> bool:
    return _factor(n)[0] > 1


@functools.lru_cache(maxsize=64)
def _matrices_np(n: int, sign: int):
    """Host float64 DFT/twiddle matrices (cached as numpy: caching device
    arrays would leak tracers when first built inside a jit trace)."""
    a_size, b_size = _factor(n)
    a = np.arange(a_size)
    b = np.arange(b_size)
    c = np.arange(a_size)
    d = np.arange(b_size)
    wa = np.exp(sign * 2j * np.pi * np.outer(a, c) / a_size)
    wb = np.exp(sign * 2j * np.pi * np.outer(b, d) / b_size)
    tw = np.exp(sign * 2j * np.pi * np.outer(c, b) / n)
    return wa, wb, tw, a_size, b_size


def _matrices(n: int, sign: int, dtype_name: str):
    wa, wb, tw, a_size, b_size = _matrices_np(n, sign)
    cdt = jnp.dtype(dtype_name)
    return (
        jnp.asarray(wa, cdt),
        jnp.asarray(wb, cdt),
        jnp.asarray(tw, cdt),
        a_size,
        b_size,
    )


def _apply(x, axis, sign):
    n = x.shape[axis]
    a_size, b_size = _factor(n)
    if a_size == 1:  # prime length: native minor-axis FFT is correct
        xm = jnp.moveaxis(x, axis, -1)
        if sign > 0:
            out = jnp.fft.ifft(xm, axis=-1, norm="forward")
        else:
            out = jnp.fft.fft(xm, axis=-1, norm="backward")
        return jnp.moveaxis(out, -1, axis)

    cdt = x.dtype if jnp.issubdtype(x.dtype, jnp.complexfloating) else (
        jnp.complex64 if x.dtype == jnp.float32 else jnp.complex128
    )
    wa, wb, tw, A, B = _matrices(n, sign, str(jnp.dtype(cdt)))
    xm = jnp.moveaxis(x.astype(cdt), axis, 0).reshape(A, B, -1)
    s1 = jnp.einsum("ac,abr->cbr", wa, xm,
                    preferred_element_type=cdt, precision=jax.lax.Precision.HIGHEST)
    s1 = s1 * tw[:, :, None]
    out = jnp.einsum("bd,cbr->dcr", wb, s1,
                     preferred_element_type=cdt, precision=jax.lax.Precision.HIGHEST)
    out = out.reshape((n,) + tuple(np.delete(x.shape, axis % x.ndim)))
    return jnp.moveaxis(out, 0, axis)


def ifft_ct(x, axis=-1):
    """Unnormalized inverse FFT (norm='forward' semantics), any axis."""
    return _apply(x, axis, +1)


def fft_ct(x, axis=-1):
    """Unnormalized forward FFT (norm='backward' semantics), any axis."""
    return _apply(x, axis, -1)


def irfft_ct(c, n, axis=-1):
    """c2r via Hermitian extension + CT inverse; valid as the LAST axis
    transformed (same contract as transform.irfft_minor)."""
    c = jnp.moveaxis(c, axis, -1)
    nh = c.shape[-1]
    cre, cim = c.real, c.imag
    tail_re = cre[..., 1:(n - n // 2)][..., ::-1]
    tail_im = cim[..., 1:(n - n // 2)][..., ::-1]
    re = jnp.zeros((*c.shape[:-1], n), cre.dtype)
    im = jnp.zeros((*c.shape[:-1], n), cre.dtype)
    re = re.at[..., :nh].set(cre).at[..., nh:].set(tail_re)
    im = im.at[..., :nh].set(cim).at[..., nh:].set(-tail_im)
    full = jax.lax.complex(re, im)
    out = ifft_ct(full, axis=-1).real
    return jnp.moveaxis(out, -1, axis)


# ---------------------------------------------------------------------------
# In-place-axis variants: no moveaxis, no physical transposes.
#
# ``_apply`` moves the transform axis to the front — a full physical
# transpose either side of the matmuls.  For the staged render pipeline
# that traffic is pure waste: a Cooley-Tukey stage only needs the axis
# *split* (a free reshape), and einsum can contract any dimension — XLA
# feeds the matmul directly from the strided layout, with no physical
# transpose either side.
# ---------------------------------------------------------------------------


def ifft_ct_axis(x, axis):
    """Unnormalized inverse FFT over ``axis`` with zero data movement.

    Requires the axis length to be composite (``can_ct``); prime lengths
    fall back to :func:`ifft_ct` (moveaxis + native minor-axis kernel).
    """
    return _apply_axis(x, axis, +1)


def fft_ct_axis(x, axis):
    """Unnormalized forward FFT over ``axis`` with zero data movement."""
    return _apply_axis(x, axis, -1)


def _apply_axis(x, axis, sign):
    axis = axis % x.ndim
    n = x.shape[axis]
    a_size, b_size = _factor(n)
    if a_size == 1:
        return ifft_ct(x, axis) if sign > 0 else fft_ct(x, axis)
    cdt = x.dtype if jnp.issubdtype(x.dtype, jnp.complexfloating) else (
        jnp.complex64 if x.dtype == jnp.float32 else jnp.complex128
    )
    wa, wb, tw, A, B = _matrices(n, sign, str(jnp.dtype(cdt)))
    pre = x.shape[:axis]
    post = x.shape[axis + 1:]
    xm = x.astype(cdt).reshape(*pre, A, B, *post)
    # build einsum specs around the split axis: p = pre dims, q = post
    p = "".join(chr(ord("i") + k) for k in range(len(pre)))
    q = "".join(chr(ord("t") + k) for k in range(len(post)))
    s1 = jnp.einsum(
        f"ac,{p}ab{q}->{p}cb{q}", wa, xm,
        preferred_element_type=cdt, precision=jax.lax.Precision.HIGHEST,
    )
    shape_tw = (1,) * len(pre) + (A, B) + (1,) * len(post)
    s1 = s1 * tw.reshape(shape_tw)
    out = jnp.einsum(
        f"bd,{p}cb{q}->{p}dc{q}", wb, s1,
        preferred_element_type=cdt, precision=jax.lax.Precision.HIGHEST,
    )
    # flattening (d, c) row-major is exactly k = c + A*d
    return out.reshape(*pre, n, *post)


def irfft_half_axis(c, n, axis):
    """c2r over ``axis`` via the half-length complex pack (n even).

    Valid when this is the LAST transform (the packed spectrum along the
    axis is Hermitian: C[n-k] = conj(C[k])).  Instead of materializing
    the full Hermitian extension and running a length-n complex inverse
    (4x the matmul work, 2x the buffer width), fold the real output's
    even/odd interleave into a length-M = n/2 complex inverse:

        x[2j] + i x[2j+1] = z[j],   z = ifft_M(G),
        G[m] = (C[m] + conj(C[M-m])) + i W_n^m (C[m] - conj(C[M-m]))

    (derived by splitting the unnormalized synthesis sum over k and
    k+M; W_n = exp(2 pi i / n)).  All reversals act on REAL lattices,
    and the interleave is a stack+reshape of real arrays.
    """
    return irfft_half_axis_reim(c.real, c.imag, n, axis % c.ndim)


def irfft_half_axis_reim(cre, cim, n, axis):
    """:func:`irfft_half_axis` from separate re/im lattices.

    The body already works on real lattices; taking re/im directly skips
    the complex formation/decomposition passes for callers that hold
    separate lattices.
    """
    assert n % 2 == 0, "half-pack c2r requires an even length"
    m_len = n // 2
    axis = axis % cre.ndim
    rdt = cre.dtype

    def ax(sl):
        return (slice(None),) * axis + (sl,)

    head_re = cre[ax(slice(0, m_len))]
    head_im = cim[ax(slice(0, m_len))]
    rev_re = cre[ax(slice(1, m_len + 1))][ax(slice(None, None, -1))]
    rev_im = cim[ax(slice(1, m_len + 1))][ax(slice(None, None, -1))]

    er = head_re + rev_re          # Re(C[m] + conj(C[M-m]))
    ei = head_im - rev_im
    orr = head_re - rev_re         # Re(C[m] - conj(C[M-m]))
    oi = head_im + rev_im

    theta = 2.0 * np.pi * np.arange(m_len) / n
    shape_w = [1] * cre.ndim
    shape_w[axis] = m_len
    wr = jnp.asarray(np.cos(theta), rdt).reshape(shape_w)
    wi = jnp.asarray(np.sin(theta), rdt).reshape(shape_w)

    # G = E + i W O  with W = wr + i wi, O = orr + i oi
    g_re = er - (wr * oi + wi * orr)
    g_im = ei + (wr * orr - wi * oi)
    z = ifft_ct_axis(jax.lax.complex(g_re, g_im), axis)

    # interleave: x[..., 2j, ...] = Re z[j], x[..., 2j+1, ...] = Im z[j]
    pair = jnp.stack([z.real, z.imag], axis=axis + 1)
    return pair.reshape(*cre.shape[:axis], n, *cre.shape[axis + 1:])
