"""Resolution-nested sampling: zoom-matched realizations across grids.

Gates:
* per-mode draws are a pure function of (seed, signed mode indices) —
  grids of different size (including anisotropic) over the same box
  share every sub-Nyquist mode exactly;
* rendered fields nest physically: the coarse field's spectrum equals
  the fine field's on shared modes, so the coarse render IS the fine
  render low-pass filtered;
* statistics match the Threefry stream's (variance vs prediction);
* engine guards (mesh / staged pipeline / oversize grids reject).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from randomfield_tpu import Generator
from randomfield_tpu.ops import sample as rf_sample


def _shared_mode_index_pairs(n_coarse, n_fine):
    """[(coarse ix, fine ix, signed s)] for shared (sub-coarse-Nyquist)
    frequencies of one axis."""
    out = []
    for i in range(n_coarse):
        s = i if i < (n_coarse + 1) // 2 else i - n_coarse
        if n_coarse % 2 == 0 and s == -n_coarse // 2:
            continue  # the coarse Nyquist is self-conjugate there, new at 2x
        out.append((i, s % n_fine, s))
    return out


def test_nested_noise_matches_across_resolutions():
    key = jax.random.key(11)
    z1 = np.asarray(rf_sample.sample_unit_hermitian_nested(key, (16, 16, 16)))
    z2 = np.asarray(rf_sample.sample_unit_hermitian_nested(key, (32, 32, 32)))
    z3 = np.asarray(
        rf_sample.sample_unit_hermitian_nested(key, (64, 32, 16))
    )
    for ix1, ix2, sx in _shared_mode_index_pairs(16, 32):
        ix3 = sx % 64
        for iy1, iy2, sy in _shared_mode_index_pairs(16, 32):
            iy3 = sy % 32
            np.testing.assert_allclose(
                z1[ix1, iy1, :8], z2[ix2, iy2, :8], atol=1e-6
            )
            np.testing.assert_allclose(
                z1[ix1, iy1, :8], z3[ix3, iy3, :8], atol=1e-6
            )
    # different seeds give different noise
    zb = np.asarray(
        rf_sample.sample_unit_hermitian_nested(jax.random.key(12), (16,) * 3)
    )
    assert not np.allclose(z1, zb)


def test_nested_noise_is_unit_hermitian():
    key = jax.random.key(0)
    n = 32
    z = np.asarray(rf_sample.sample_unit_hermitian_nested(key, (n, n, n)))
    # unit variance over many modes
    np.testing.assert_allclose((np.abs(z) ** 2).mean(), 1.0, rtol=0.03)
    # gaussian fourth moment: <|z|^4> = 2 for complex normal (the
    # self-conjugate real modes are a negligible fraction)
    np.testing.assert_allclose((np.abs(z) ** 4).mean(), 2.0, rtol=0.08)
    # the inverse transform is real: spectrum is Hermitian
    from randomfield_tpu.ops import transform as rf_transform

    f = np.asarray(rf_transform.irfftn(jnp.asarray(z), (n, n, n)))
    assert np.isfinite(f).all()
    # round-trip: rfftn of the field reproduces the (Hermitian) spectrum
    c = np.fft.rfftn(f, norm="forward")
    np.testing.assert_allclose(c, z, atol=5e-5)


def test_nested_render_zoom_consistency():
    # same 128 Mpc/h box at 16^3 and 32^3: shared spectral coefficients
    # equal => the coarse field is the band-limited fine field
    box = 128.0
    g1 = Generator(16, 16, 16, grid_spacing=box / 16, sampler="nested")
    g2 = Generator(32, 32, 32, grid_spacing=box / 32, sampler="nested")
    d1 = np.asarray(g1.generate_delta_field(5, apply_lightcone=False),
                    np.float64)
    d2 = np.asarray(g2.generate_delta_field(5, apply_lightcone=False),
                    np.float64)
    c1 = np.fft.rfftn(d1, norm="forward")
    c2 = np.fft.rfftn(d2, norm="forward")
    scale = max(np.abs(c1).max(), 1e-12)
    for ix1, ix2, _ in _shared_mode_index_pairs(16, 32):
        for iy1, iy2, _ in _shared_mode_index_pairs(16, 32):
            np.testing.assert_allclose(
                c1[ix1, iy1, :8], c2[ix2, iy2, :8],
                atol=2e-4 * scale, rtol=2e-3,
            )


def test_nested_statistics_match_prediction():
    n, spacing, nseeds = 32, 8.0, 6
    g = Generator(n, n, n, grid_spacing=spacing, sampler="nested")
    var_pred = g.predicted_variance()
    fields = np.stack([
        np.asarray(g.generate_delta_field(s, apply_lightcone=False))
        for s in range(nseeds)
    ])
    np.testing.assert_allclose(fields.var(), var_pred, rtol=0.1)
    assert abs(fields.mean()) < 5 * np.sqrt(var_pred / fields.size)
    # batch equals per-seed renders
    batch = np.asarray(
        g.generate_delta_fields([0, 1], apply_lightcone=False)
    )
    np.testing.assert_allclose(batch[0], fields[0], atol=1e-6)
    np.testing.assert_allclose(batch[1], fields[1], atol=1e-6)
    # distinct stream from positional threefry (same seed)
    g_std = Generator(n, n, n, grid_spacing=spacing)
    d_std = np.asarray(g_std.generate_delta_field(0, apply_lightcone=False))
    assert not np.allclose(d_std, fields[0])


def test_nested_fixed_and_derived_and_sample_power():
    n, spacing = 16, 8.0
    g = Generator(n, n, n, grid_spacing=spacing, sampler="nested")
    # fixed fields flow through the nested stream and stay magnitude-pinned
    f = np.asarray(g.generate_fixed_field(3, apply_lightcone=False))
    ff = np.asarray(g.generate_fixed_field(3, apply_lightcone=False,
                                           flip=True))
    np.testing.assert_allclose(ff, -f, atol=1e-5)
    np.testing.assert_allclose(f.var(), g.predicted_variance(), rtol=2e-3)
    # seed-direct derived fields and spectrum-space P(k) work too
    psi = np.asarray(g.generate_displacement(seed=2))
    assert psi.shape == (3, n, n, n) and np.isfinite(psi).all()
    k, p, nm = g.sample_power(2, nbins=6)
    assert np.isfinite(p[nm > 0]).all()


def test_nested_rejects_unsupported_configs():
    # (mesh + nested is SUPPORTED since round 4 — the counter-based
    # stream shards; see test_nested_mesh_render_matches_single_device)
    with pytest.raises(ValueError, match="fused"):
        Generator(16, 16, 16, grid_spacing=8.0, sampler="nested",
                  pipeline="staged")
    with pytest.raises(ValueError, match="max dim"):
        rf_sample.sample_unit_hermitian_nested(
            jax.random.key(0), (2048, 8, 8)
        )


def test_noise_export_roundtrip():
    # generate_from_noise(generate_noise(s)) == generate_delta_field(s)
    # on both the threefry and nested streams; external numpy noise also
    # renders with the right statistics
    n, spacing = 16, 8.0
    for sampler in ("threefry", "nested"):
        g = Generator(n, n, n, grid_spacing=spacing, sampler=sampler)
        draws = g.generate_noise(4)
        assert draws.shape == (2, n, n, n // 2 + 1)
        d_round = np.asarray(
            g.generate_from_noise(draws, apply_lightcone=False)
        )
        d_direct = np.asarray(
            g.generate_delta_field(4, apply_lightcone=False)
        )
        np.testing.assert_allclose(d_round, d_direct, atol=2e-6)
    # external white noise: deterministic and statistically sane
    rng = np.random.RandomState(0)
    ext = rng.normal(size=(2, n, n, n // 2 + 1)).astype(np.float32)
    d1 = np.asarray(g.generate_from_noise(ext, apply_lightcone=False))
    d2 = np.asarray(g.generate_from_noise(ext, apply_lightcone=False))
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_allclose(d1.var(), g.predicted_variance(), rtol=0.35)
    with pytest.raises(ValueError, match="shape"):
        g.generate_from_noise(np.zeros((2, n, n, n), np.float32))


def test_noise_export_rejects_pallas_and_staged():
    with pytest.raises(ValueError, match="threefry"):
        Generator(16, 16, 16, grid_spacing=8.0, sampler="pallas")
    g = Generator(16, 16, 16, grid_spacing=8.0, pipeline="staged")
    with pytest.raises(ValueError, match="fused"):
        g.generate_noise(0)
    with pytest.raises(ValueError, match="fused"):
        g.generate_from_noise(np.zeros((2, 16, 16, 9), np.float32))


def test_nested_mesh_render_matches_single_device():
    """The zoom-matched nested stream is counter-based per signed mode
    index, so mesh renders equal single-device nested renders."""
    from randomfield_tpu import Generator
    from randomfield_tpu.parallel.mesh import make_mesh
    from randomfield_tpu.parallel.pencil import make_pencil_mesh

    shape, spacing = (16, 16, 16), 8.0
    g0 = Generator(*shape, grid_spacing=spacing, sampler="nested")
    ref = np.asarray(g0.generate_delta_field(seed=5))
    for mesh in (make_mesh(data=1, space=4),
                 make_pencil_mesh(data=1, spx=2, spy=2)):
        gm = Generator(*shape, grid_spacing=spacing, sampler="nested",
                       mesh=mesh)
        got = np.asarray(gm.generate_delta_field(seed=5))
        np.testing.assert_allclose(
            got, ref, rtol=2e-4, atol=2e-5 * np.abs(ref).std()
        )
        batch = np.asarray(gm.generate_delta_fields([5, 7]))
        np.testing.assert_allclose(
            batch[0], got, rtol=1e-5, atol=1e-6 * np.abs(ref).std()
        )
