"""Generator integration tests (ref: test_generate.py statistical gate)."""

import jax.numpy as jnp
import numpy as np
import pytest

from randomfield_tpu import Generator
from randomfield_tpu.validate import stats


@pytest.fixture(scope="module")
def small_gen():
    return Generator(16, 16, 16, grid_spacing=8.0)


def test_fixed_seed_deterministic(small_gen):
    a = np.asarray(small_gen.generate_delta_field(seed=42))
    b = np.asarray(small_gen.generate_delta_field(seed=42))
    c = np.asarray(small_gen.generate_delta_field(seed=43))
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a, c)


def test_output_shape_and_dtype(small_gen):
    f = small_gen.generate_delta_field(seed=0)
    assert f.shape == (16, 16, 16)
    assert f.dtype == jnp.float32


def test_mean_and_variance_match_prediction():
    g = Generator(24, 24, 24, grid_spacing=6.0)
    pred = g.predicted_variance()
    nseeds = 64
    fields = g.generate_delta_fields(np.arange(nseeds), apply_lightcone=False)
    fields = np.asarray(fields, np.float64)
    # DC mode is zeroed => every field has exactly zero mean
    means = fields.mean(axis=(1, 2, 3))
    np.testing.assert_allclose(means, 0.0, atol=1e-5 * np.sqrt(pred))
    var = fields.var()
    # variance of the variance estimate ~ 2 sum sigma_k^4; allow 5 sigma-ish
    assert abs(var - pred) < 0.1 * pred, (var, pred)


def test_realized_power_matches_input():
    g = Generator(32, 32, 32, grid_spacing=4.0)
    nseeds = 32
    fields = g.generate_delta_fields(np.arange(nseeds), apply_lightcone=False)
    k_of_bin = p_sum = n_sum = None
    p_all = []
    for i in range(nseeds):
        kb, pb, nb = stats.calculate_power(fields[i], g.grid_spacing, nbins=12)
        p_all.append(pb)
    p_hat = np.nanmean(p_all, axis=0)
    from randomfield_tpu.ops.power import interpolate_power

    table = g.power
    valid = np.isfinite(p_hat) & (nb > 0)
    p_true = np.asarray(interpolate_power(table, jnp.asarray(kb[valid], jnp.float32)))
    # per-bin relative sampling error ~ sqrt(2/(n_modes*nseeds))
    err = np.sqrt(2.0 / (nb[valid] * nseeds))
    resid = (p_hat[valid] - p_true) / p_true
    assert np.all(np.abs(resid) < 6 * err + 0.05), (resid, err)


def test_smoothing_reduces_variance():
    g = Generator(16, 16, 16, grid_spacing=4.0)
    f0 = np.asarray(g.generate_delta_field(0, apply_lightcone=False))
    f1 = np.asarray(
        g.generate_delta_field(0, smoothing_length=8.0, apply_lightcone=False)
    )
    assert f1.var() < 0.5 * f0.var()
    pred = g.predicted_variance(smoothing_length=8.0)
    # single realization: loose check against prediction
    assert 0.3 * pred < f1.var() < 3 * pred


def test_lightcone_weighting_scales_far_planes():
    g = Generator(8, 8, 32, grid_spacing=100.0)  # deep box: z up to ~1.2
    lc = np.asarray(g.generate_delta_field(5, apply_lightcone=True))
    raw = np.asarray(g.generate_delta_field(5, apply_lightcone=False))
    growth = np.asarray(g.growth_function)
    np.testing.assert_allclose(
        lc, raw * growth[None, None, :].astype(np.float32), rtol=2e-5, atol=1e-7
    )
    assert growth[-1] < 0.75  # far plane is genuinely suppressed


def test_ensemble_matches_single_seed():
    g = Generator(8, 8, 8, grid_spacing=10.0)
    batch = np.asarray(g.generate_delta_fields(np.array([3, 9])))
    single3 = np.asarray(g.generate_delta_field(3))
    single9 = np.asarray(g.generate_delta_field(9))
    np.testing.assert_allclose(batch[0], single3, atol=1e-6)
    np.testing.assert_allclose(batch[1], single9, atol=1e-6)


def test_custom_power_and_cosmology():
    k = np.logspace(-3, 1.5, 100)
    pk = 1e3 * (k / 0.1) ** -1.0
    from randomfield_tpu.models.cosmology import Cosmology

    c = Cosmology(H0=70.0, Om0=0.3, name="custom")
    g = Generator(8, 8, 8, grid_spacing=8.0, cosmology=c, power=(k, pk))
    f = g.generate_delta_field(0)
    assert np.all(np.isfinite(np.asarray(f)))
    assert g.cosmology.name == "custom"


def test_verbose_prints(capsys):
    g = Generator(8, 8, 8, grid_spacing=8.0, verbose=True)
    g.generate_delta_field(0)
    out = capsys.readouterr().out
    assert "scene setup" in out and "render" in out


def test_invalid_pipeline_rejected_even_with_mesh():
    from randomfield_tpu.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="unknown pipeline"):
        Generator(8, 8, 8, grid_spacing=8.0, pipeline="bogus")
    mesh = make_mesh(data=2, space=4)
    with pytest.raises(ValueError, match="unknown pipeline"):
        Generator(8, 8, 8, grid_spacing=8.0, mesh=mesh, pipeline="bogus")
    with pytest.raises(ValueError, match="incompatible with mesh"):
        Generator(8, 8, 8, grid_spacing=8.0, mesh=mesh, pipeline="staged")
    # explicit 'fused' and 'auto' remain fine in mesh mode
    assert Generator(8, 8, 8, grid_spacing=8.0, mesh=mesh,
                     pipeline="fused").pipeline == "fused"


def test_pallas_sampler_mesh_capability_gate():
    # the hardware-PRNG sampler is gone: every scene that asks for it,
    # on one device or on a slab or pencil mesh, gets a ValueError that
    # points at the Threefry default
    from randomfield_tpu.parallel.mesh import make_mesh
    from randomfield_tpu.parallel.pencil import make_pencil_mesh

    with pytest.raises(ValueError, match="threefry"):
        Generator(8, 8, 8, grid_spacing=8.0, sampler="pallas")
    mesh = make_mesh(data=2, space=4)
    with pytest.raises(ValueError, match="threefry"):
        Generator(8, 8, 8, grid_spacing=8.0, mesh=mesh, sampler="pallas")
    pmesh = make_pencil_mesh(data=2, spx=2, spy=2)
    with pytest.raises(ValueError, match="threefry"):
        Generator(16, 16, 16, grid_spacing=8.0, mesh=pmesh,
                  sampler="pallas")


def test_predicted_variance_matches_oracle():
    # the device reduction must agree with the float64 oracle sum
    from randomfield_tpu.validate import oracle

    for shape, pipeline in (((16, 16, 16), "fused"), ((16, 16, 16), "staged")):
        g = Generator(*shape, grid_spacing=8.0, pipeline=pipeline)
        table = g.power
        for s in (0.0, 12.0):
            ref = oracle.predicted_variance(
                shape, 8.0, (table.k, table.Pk), smoothing_length=s
            )
            got = g.predicted_variance(smoothing_length=s)
            assert abs(got - ref) < 2e-4 * ref, (pipeline, s, got, ref)


def test_predicted_variance_lightcone_matches_deep_box():
    # deep box: <D^2> is far from 1, so the lightcone prediction must
    # track the weighted render while the plain one tracks the
    # no-lightcone render
    from randomfield_tpu import Generator

    g = Generator(24, 24, 48, grid_spacing=40.0)
    w = np.asarray(g.growth_function, np.float64)
    growth_sq = float(np.mean(w * w))
    assert growth_sq < 0.9  # the geometry actually exercises the path
    plain = g.predicted_variance()
    lc = g.predicted_variance(apply_lightcone=True)
    assert lc == pytest.approx(plain * growth_sq, rel=1e-12)
    fields = np.stack([
        np.asarray(g.generate_delta_field(seed=s)) for s in range(6)
    ])
    var_lc = float(fields.var(axis=(1, 2, 3)).mean())
    assert var_lc == pytest.approx(lc, rel=0.2)
    assert var_lc < 0.85 * plain
