"""Transform conventions + Hermitian utilities (ref: test_transform.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from randomfield_tpu.ops import transform


@pytest.mark.parametrize("shape", [(8, 8, 8), (4, 6, 10), (8, 8, 9)])
def test_roundtrip_identity(shape):
    rng = np.random.RandomState(1)
    delta = jnp.asarray(rng.normal(size=shape).astype(np.float32))
    spacing = 1.3
    c = transform.field_to_spectrum(delta, spacing)
    back = transform.spectrum_to_field(c, spacing, shape)
    np.testing.assert_allclose(np.asarray(back), np.asarray(delta), atol=2e-5)


def test_analysis_matches_continuum_convention():
    # a pure cosine delta = A cos(k0 x) has c(k0) = A*V/2
    n, spacing = 16, 2.0
    shape = (n, n, n)
    x = np.arange(n) * spacing
    k0 = 2 * np.pi / (n * spacing) * 3  # 3rd harmonic along x
    delta = np.broadcast_to(0.7 * np.cos(k0 * x)[:, None, None], shape)
    c = np.array(transform.field_to_spectrum(jnp.asarray(delta, jnp.float32), spacing))
    volume = n**3 * spacing**3
    assert np.isclose(c[3, 0, 0].real, 0.7 * volume / 2, rtol=1e-4)
    assert np.isclose(c[n - 3, 0, 0].real, 0.7 * volume / 2, rtol=1e-4)
    c[3, 0, 0] = c[n - 3, 0, 0] = 0
    assert np.max(np.abs(c)) < 1e-3 * volume


@pytest.mark.parametrize("shape", [(8, 8, 8), (4, 6, 10), (6, 4, 9), (5, 7, 9)])
def test_symmetrize_makes_hermitian(shape):
    nx, ny, nz = shape
    rng = np.random.RandomState(2)
    nzh = nz // 2 + 1
    c = jnp.asarray(
        (rng.normal(size=(nx, ny, nzh)) + 1j * rng.normal(size=(nx, ny, nzh))).astype(
            np.complex64
        )
    )
    assert not transform.is_hermitian(c, nz=nz)
    sym = transform.symmetrize_with_shape(c, nz=nz)
    assert transform.is_hermitian(sym, nz=nz)
    # the c2r transform of the symmetrized spectrum equals the full complex
    # inverse FFT of the unpacked spectrum => output was really real
    field = np.asarray(transform.irfftn(sym, shape))
    assert np.all(np.isfinite(field))


def test_symmetrize_projection_idempotent():
    shape = (8, 8, 8)
    rng = np.random.RandomState(3)
    c = jnp.asarray(
        (rng.normal(size=(8, 8, 5)) + 1j * rng.normal(size=(8, 8, 5))).astype(
            np.complex64
        )
    )
    p1 = transform.symmetrize_with_shape(c, nz=8, scale_self_conjugate=False)
    p2 = transform.symmetrize_with_shape(p1, nz=8, scale_self_conjugate=False)
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p2), atol=1e-6)


def test_symmetrize_preserves_interior_planes():
    shape = (8, 8, 8)
    rng = np.random.RandomState(4)
    c = jnp.asarray(
        (rng.normal(size=(8, 8, 5)) + 1j * rng.normal(size=(8, 8, 5))).astype(
            np.complex64
        )
    )
    sym = transform.symmetrize_with_shape(c, nz=8)
    np.testing.assert_array_equal(np.asarray(sym[:, :, 1:4]), np.asarray(c[:, :, 1:4]))


def test_symmetrized_spectrum_gives_real_full_ifft():
    # unpack the half spectrum into the full cube and check the plain ifftn
    # output is real — the ground truth for Hermitian-ness
    nx, ny, nz = 6, 8, 10
    rng = np.random.RandomState(5)
    nzh = nz // 2 + 1
    c = (rng.normal(size=(nx, ny, nzh)) + 1j * rng.normal(size=(nx, ny, nzh)))
    sym = np.asarray(
        transform.symmetrize_with_shape(jnp.asarray(c, jnp.complex64), nz=nz)
    ).astype(np.complex128)
    full = np.zeros((nx, ny, nz), np.complex128)
    full[:, :, :nzh] = sym
    for kz in range(nzh, nz):
        src = nz - kz
        full[:, :, kz] = np.conj(
            sym[(-np.arange(nx)) % nx][:, (-np.arange(ny)) % ny, src]
        )
    out = np.fft.ifftn(full, norm="forward")
    assert np.max(np.abs(out.imag)) < 1e-9 * max(1.0, np.max(np.abs(out.real)))


@pytest.mark.parametrize("shape", [(8, 8, 8), (4, 6, 10), (8, 6, 9)])
def test_safe_backend_matches_xla(shape):
    # the 'safe' minor-axis-only FFT path (an RF_FFT_BACKEND alternative)
    # must agree with the native XLA path exactly
    rng = np.random.RandomState(11)
    nzh = shape[2] // 2 + 1
    c = (rng.normal(size=(*shape[:2], nzh))
         + 1j * rng.normal(size=(*shape[:2], nzh))).astype(np.complex64)
    c = transform.symmetrize_with_shape(jnp.asarray(c), nz=shape[2])
    a = np.asarray(transform._irfftn_safe(c, shape))
    b = np.asarray(jnp.fft.irfftn(c, s=shape, axes=(0, 1, 2), norm="forward"))
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max())

    x = jnp.asarray(rng.normal(size=shape).astype(np.float32))
    f = np.asarray(transform._rfftn_safe(x))
    g = np.asarray(jnp.fft.rfftn(x, axes=(0, 1, 2), norm="backward"))
    np.testing.assert_allclose(f, g, rtol=1e-4, atol=1e-4 * np.abs(g).max())


def test_safe_backend_batched():
    rng = np.random.RandomState(12)
    shape = (6, 8, 10)
    nzh = 6
    c = (rng.normal(size=(3, 6, 8, nzh))
         + 1j * rng.normal(size=(3, 6, 8, nzh))).astype(np.complex64)
    c = transform.symmetrize_with_shape(jnp.asarray(c), nz=10)
    a = np.asarray(transform._irfftn_safe(c, shape))
    b = np.asarray(jnp.fft.irfftn(c, s=shape, axes=(1, 2, 3), norm="forward"))
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max())
