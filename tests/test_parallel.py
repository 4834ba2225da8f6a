"""Distributed execution tests on the 8-virtual-device CPU mesh.

The key invariant (SURVEY.md section 4, distributed tests): sharded
output equals single-device output for any mesh shape — JAX's
partitionable Threefry makes sampling layout-independent, and the slab
FFT is algebraically the same transform.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from randomfield_tpu import Generator
from randomfield_tpu.parallel import dfft
from randomfield_tpu.parallel import mesh as M


def _mesh(data, space):
    return M.make_mesh(data=data, space=space)


def test_device_count():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("space", [1, 2, 4, 8])
def test_irfftn_slab_matches_numpy(space):
    mesh = _mesh(1, space)
    shape = (16, 8, 12)
    rng = np.random.RandomState(0)
    c_np = (
        rng.normal(size=(16, 8, 7)) + 1j * rng.normal(size=(16, 8, 7))
    ).astype(np.complex64)
    c = jax.device_put(jnp.asarray(c_np), M.spectrum_sharding(mesh))
    out = jax.jit(lambda c: dfft.irfftn_slab(c, shape, mesh))(c)
    ref = np.fft.irfftn(c_np, s=shape, axes=(0, 1, 2), norm="forward")
    np.testing.assert_allclose(np.asarray(out), ref, rtol=2e-4, atol=1e-4)


def test_rfftn_irfftn_slab_roundtrip():
    mesh = _mesh(2, 4)
    shape = (16, 16, 16)
    rng = np.random.RandomState(1)
    x_np = rng.normal(size=shape).astype(np.float32)
    x = jax.device_put(jnp.asarray(x_np), M.field_sharding(mesh))

    @jax.jit
    def roundtrip(x):
        c = dfft.rfftn_slab(x, shape, mesh)
        return dfft.irfftn_slab(c, shape, mesh) / np.prod(shape)

    np.testing.assert_allclose(np.asarray(roundtrip(x)), x_np, atol=2e-5)


def test_rfftn_slab_matches_numpy_batched():
    mesh = _mesh(2, 2)
    shape = (8, 8, 8)
    rng = np.random.RandomState(2)
    x_np = rng.normal(size=(4,) + shape).astype(np.float32)
    x = jax.device_put(jnp.asarray(x_np), M.field_sharding(mesh, batched=True))
    c = jax.jit(lambda x: dfft.rfftn_slab(x, shape, mesh, batched=True))(x)
    ref = np.fft.rfftn(x_np, axes=(1, 2, 3), norm="backward")
    np.testing.assert_allclose(np.asarray(c), ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("data,space", [(1, 2), (1, 8), (2, 4), (8, 1)])
def test_sharded_render_equals_single_device(data, space):
    shape, spacing = (16, 16, 16), 8.0
    g0 = Generator(*shape, grid_spacing=spacing)
    g1 = Generator(*shape, grid_spacing=spacing, mesh=_mesh(data, space))
    for seed in (0, 7):
        a = np.asarray(g0.generate_delta_field(seed))
        b = np.asarray(g1.generate_delta_field(seed))
        scale = np.std(a)
        np.testing.assert_allclose(a, b, atol=1e-5 * scale, rtol=2e-4)


def test_sharded_render_mesh_shape_invariance():
    # same seed, different mesh decompositions -> same field
    shape, spacing = (16, 16, 16), 8.0
    fields = []
    for data, space in [(1, 4), (4, 2), (2, 2)]:
        g = Generator(*shape, grid_spacing=spacing, mesh=_mesh(data, space))
        fields.append(np.asarray(g.generate_delta_field(11)))
    scale = np.std(fields[0])
    for f in fields[1:]:
        np.testing.assert_allclose(fields[0], f, atol=1e-5 * scale, rtol=2e-4)


def test_sharded_ensemble_equals_single_device():
    shape, spacing = (16, 16, 16), 8.0
    seeds = np.arange(8)
    g0 = Generator(*shape, grid_spacing=spacing)
    g1 = Generator(*shape, grid_spacing=spacing, mesh=_mesh(4, 2))
    a = np.asarray(g0.generate_delta_fields(seeds, smoothing_length=4.0))
    b = np.asarray(g1.generate_delta_fields(seeds, smoothing_length=4.0))
    scale = np.std(a)
    np.testing.assert_allclose(a, b, atol=1e-5 * scale, rtol=2e-4)
    # batch results also match per-seed single renders
    one = np.asarray(g0.generate_delta_field(3, smoothing_length=4.0))
    np.testing.assert_allclose(a[3], one, atol=1e-6 * scale)


def test_sharded_output_sharding_layout():
    mesh = _mesh(1, 4)
    g = Generator(16, 16, 16, grid_spacing=8.0, mesh=mesh)
    out = g.generate_delta_field(0)
    assert out.sharding.spec == M.P("space", None, None)
    batch = g.generate_delta_fields(np.arange(4))
    assert batch.sharding.spec[0] == "data" or batch.sharding.spec[0] is None


def test_indivisible_slab_raises():
    mesh = _mesh(1, 8)
    with pytest.raises(ValueError, match="divisible"):
        g = Generator(12, 12, 12, grid_spacing=8.0, mesh=mesh)
        g.generate_delta_field(0)


def test_make_mesh_too_few_devices():
    with pytest.raises(ValueError, match="devices"):
        M.make_mesh(data=4, space=4)


@pytest.mark.parametrize("data,space", [(2, 4), (8, 1)])
def test_mesh_sample_power_matches_single_device(data, space):
    # distributed config-4: sharded sampling + shard-local binning must
    # reproduce the unsharded spectrum-space estimate (identical Threefry
    # draws); (8, 1) is the data-only mesh (ADVICE r02 regression case)
    shape, spacing = (16, 16, 16), 8.0
    g0 = Generator(*shape, grid_spacing=spacing)
    g1 = Generator(*shape, grid_spacing=spacing, mesh=_mesh(data, space))
    k0, p0, n0 = g0.sample_power(3, nbins=8)
    k1, p1, n1 = g1.sample_power(3, nbins=8)
    np.testing.assert_allclose(n1, n0, rtol=1e-6)
    m = n0 > 0
    np.testing.assert_allclose(k1[m], k0[m], rtol=1e-5)
    np.testing.assert_allclose(p1[m], p0[m], rtol=2e-4)
    # smoothing filter enters the sharded program identically
    _, ps0, _ = g0.sample_power(3, smoothing_length=12.0, nbins=8)
    _, ps1, _ = g1.sample_power(3, smoothing_length=12.0, nbins=8)
    np.testing.assert_allclose(ps1[m], ps0[m], rtol=2e-4)


def test_mesh_sigma_materializes_sharded_and_matches():
    # mesh scenes store no sigma grid; reading .sigmas materializes a
    # sharded grid equal to the single-device tabulation
    shape, spacing = (16, 16, 16), 8.0
    g0 = Generator(*shape, grid_spacing=spacing)
    g1 = Generator(*shape, grid_spacing=spacing, mesh=_mesh(2, 4))
    assert g1.state.sigmas is None
    s1 = g1.sigmas
    assert s1.sharding.spec == M.P(None, "space", None)
    np.testing.assert_allclose(
        np.asarray(s1), np.asarray(g0.sigmas), rtol=1e-6, atol=1e-9
    )


def test_sharded_power_estimator_matches_single_device():
    from randomfield_tpu.validate import stats

    shape, spacing = (16, 16, 16), 8.0
    mesh = _mesh(2, 4)
    g = Generator(*shape, grid_spacing=spacing, mesh=mesh)
    f = g.generate_delta_field(9, apply_lightcone=False)
    k0, p0, n0 = stats.calculate_power(jnp.asarray(np.asarray(f)), spacing, nbins=8)
    k1, p1, n1 = stats.calculate_power(f, spacing, nbins=8, mesh=mesh)
    np.testing.assert_allclose(n1, n0, rtol=1e-6)
    mask = n0 > 0
    np.testing.assert_allclose(k1[mask], k0[mask], rtol=1e-5)
    np.testing.assert_allclose(p1[mask], p0[mask], rtol=2e-4)


def test_mesh_cross_and_masked_power_match_single_device():
    import randomfield_tpu as rf
    from randomfield_tpu.parallel.pencil import make_pencil_mesh
    from randomfield_tpu.validate.stats import (
        calculate_cross_power, calculate_masked_power,
    )

    shape, spacing = (16, 16, 16), 4.0
    g = rf.Generator(*shape, grid_spacing=spacing)
    d1 = g.generate_delta_field(seed=1, apply_lightcone=False)
    d2 = g.generate_delta_field(seed=2, apply_lightcone=False)
    rng = np.random.RandomState(0)
    mask = (rng.uniform(size=shape) < 0.6).astype(np.float32)
    k0, p0, n0 = calculate_cross_power(d1, d2, spacing, nbins=8)
    km0, pm0, nm0 = calculate_masked_power(d1, mask, spacing, nbins=8)
    for mesh in (_mesh(1, 4), make_pencil_mesh(data=1, spx=2, spy=2)):
        k1, p1, n1 = calculate_cross_power(d1, d2, spacing, nbins=8,
                                           mesh=mesh)
        np.testing.assert_allclose(n1, n0, rtol=1e-6)
        m = n0 > 0
        np.testing.assert_allclose(
            p1[m], p0[m], rtol=1e-3, atol=1e-4 * np.nanmax(np.abs(p0))
        )
        km1, pm1, nm1 = calculate_masked_power(d1, mask, spacing, nbins=8,
                                               mesh=mesh)
        np.testing.assert_allclose(nm1, nm0, rtol=1e-6)
        mm = nm0 > 0
        np.testing.assert_allclose(
            pm1[mm], pm0[mm], rtol=1e-3, atol=1e-4 * np.nanmax(np.abs(pm0))
        )


@pytest.mark.slow
def test_mesh_render_production_shard_geometry():
    """One >= 256^3 render on the 8-virtual-device CPU mesh (VERDICT r4
    item 2): non-degenerate production-like shard tiles (64x256x129
    complex per shard at space=4) through the full sharded program —
    catches padding/tile-class defects the 32^3 dryrun cannot.
    Gated statistically (variance + P(k)) rather than bit-wise: a 256^3
    single-device reference render on CPU is the slow part."""
    import randomfield_tpu as rf

    n = 256
    mesh = _mesh(2, 4)
    g = rf.Generator(n, n, n, grid_spacing=8.0, mesh=mesh)
    d = g.generate_delta_field(seed=11, apply_lightcone=False)
    var = float(jnp.var(d))
    pred = g.predicted_variance()
    assert abs(var / pred - 1.0) < 0.05
    # distributed estimator vs the single-device estimator on the SAME
    # field: the sharded forward transform + shard-local binning must
    # reproduce the gathered-field result at production shard geometry
    import numpy as _np

    from randomfield_tpu.validate import stats as _stats

    k, p, nm = g.calculate_power(d, nbins=12)
    k0, p0, nm0 = _stats.calculate_power(_np.asarray(d), 8.0, nbins=12)
    _np.testing.assert_allclose(nm, nm0, rtol=1e-6)
    m = nm0 > 0
    _np.testing.assert_allclose(p[m], p0[m], rtol=2e-3)
    _np.testing.assert_allclose(k[m], k0[m], rtol=1e-5)
    # batched path at the same geometry
    e = g.generate_delta_fields([1, 2], apply_lightcone=False)
    assert e.shape == (2, n, n, n)
