"""Pencil (2-D) decomposition transforms on the 8-device CPU mesh."""

import jax
import numpy as np
import pytest

import jax.numpy as jnp

from randomfield_tpu.parallel import pencil as pc


def _random_packed(shape, seed=0):
    nx, ny, nz = shape
    rng = np.random.RandomState(seed)
    return (rng.normal(size=(nx, ny, nz // 2 + 1))
            + 1j * rng.normal(size=(nx, ny, nz // 2 + 1)))


@pytest.mark.parametrize("data,spx,spy", [(1, 2, 4), (1, 4, 2), (2, 2, 2)])
def test_irfftn_pencil_matches_numpy(data, spx, spy):
    shape = (16, 16, 16)
    c = _random_packed(shape)
    mesh = pc.make_pencil_mesh(data=data, spx=spx, spy=spy)
    cd = jnp.asarray(c, jnp.complex64)
    got = np.asarray(pc.irfftn_pencil(cd, shape, mesh))
    ref = np.fft.irfftn(c, s=shape, norm="forward")
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=2e-4 * scale, rtol=2e-4)


@pytest.mark.parametrize("shape", [(16, 16, 16), (8, 16, 12), (16, 8, 20)])
def test_rfftn_pencil_matches_numpy(shape):
    rng = np.random.RandomState(1)
    x = rng.normal(size=shape)
    mesh = pc.make_pencil_mesh(data=1, spx=2, spy=4)
    c = pc.rfftn_pencil(jnp.asarray(x, jnp.float32), shape, mesh)
    got = np.asarray(c.real) + 1j * np.asarray(c.imag)
    ref = np.fft.rfftn(x, norm="backward")
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=2e-4 * scale, rtol=2e-4)


def test_pencil_matches_slab():
    from randomfield_tpu.parallel import dfft
    from randomfield_tpu.parallel.mesh import make_mesh

    shape = (16, 16, 16)
    c = _random_packed(shape, seed=3)
    cd = jnp.asarray(c, jnp.complex64)
    pmesh = pc.make_pencil_mesh(data=1, spx=2, spy=4)
    smesh = make_mesh(data=2, space=4)
    a = np.asarray(pc.irfftn_pencil(cd, shape, pmesh))
    b = np.asarray(dfft.irfftn_slab(cd, shape, smesh))
    scale = np.abs(a).max()
    np.testing.assert_allclose(a, b, atol=2e-5 * scale, rtol=2e-4)


def test_pencil_batched():
    shape = (16, 16, 16)
    cs = np.stack([_random_packed(shape, seed=s) for s in (4, 5)])
    mesh = pc.make_pencil_mesh(data=2, spx=2, spy=2)
    got = np.asarray(pc.irfftn_pencil(
        jnp.asarray(cs, jnp.complex64), shape, mesh, batched=True
    ))
    for i in range(2):
        ref = np.fft.irfftn(cs[i], s=shape, norm="forward")
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got[i], ref, atol=2e-4 * scale, rtol=2e-4)


def test_pencil_shape_validation():
    mesh = pc.make_pencil_mesh(data=1, spx=2, spy=4)
    with pytest.raises(ValueError):
        pc.irfftn_pencil(
            jnp.zeros((15, 16, 9), jnp.complex64), (15, 16, 16), mesh
        )


def test_pencil_roundtrip():
    shape = (16, 16, 16)
    rng = np.random.RandomState(7)
    x = rng.normal(size=shape).astype(np.float32)
    mesh = pc.make_pencil_mesh(data=1, spx=2, spy=4)
    c = pc.rfftn_pencil(jnp.asarray(x), shape, mesh)
    back = np.asarray(pc.irfftn_pencil(c, shape, mesh)) / np.prod(shape)
    np.testing.assert_allclose(back, x, atol=2e-5 * np.abs(x).max(), rtol=2e-4)


def test_pencil_render_equals_single_device():
    from randomfield_tpu import Generator

    shape, spacing = (16, 16, 16), 8.0
    g0 = Generator(*shape, grid_spacing=spacing)
    g1 = Generator(*shape, grid_spacing=spacing,
                   mesh=pc.make_pencil_mesh(data=1, spx=2, spy=4))
    for seed in (0, 7):
        a = np.asarray(g0.generate_delta_field(seed))
        b = np.asarray(g1.generate_delta_field(seed))
        scale = np.std(a)
        np.testing.assert_allclose(a, b, atol=1e-5 * scale, rtol=2e-4)
    out = g1.generate_delta_field(0)
    assert out.sharding.spec == pc.pencil_field_sharding(g1.mesh).spec


def test_pencil_batch_and_power():
    from randomfield_tpu import Generator

    shape, spacing = (16, 16, 16), 8.0
    mesh = pc.make_pencil_mesh(data=2, spx=2, spy=2)
    g0 = Generator(*shape, grid_spacing=spacing)
    g1 = Generator(*shape, grid_spacing=spacing, mesh=mesh)
    seeds = np.arange(4)
    a = np.asarray(g0.generate_delta_fields(seeds, smoothing_length=4.0))
    b = np.asarray(g1.generate_delta_fields(seeds, smoothing_length=4.0))
    scale = np.std(a)
    np.testing.assert_allclose(a, b, atol=1e-5 * scale, rtol=2e-4)

    # pencil-sharded P(k) equals the single-device estimate
    d = g1.generate_delta_field(3)
    k1, p1, m1 = g1.calculate_power(d, nbins=8)
    d0 = g0.generate_delta_field(3)
    k0, p0, m0 = g0.calculate_power(d0, nbins=8)
    np.testing.assert_allclose(m1, m0)
    np.testing.assert_allclose(p1, p0, rtol=1e-3)
    np.testing.assert_allclose(k1, k0, rtol=1e-5)


@pytest.mark.parametrize("shape", [(16, 8, 12), (8, 8, 8)])
def test_irfftn_pencil_state0_matches_numpy(shape):
    # the render path's fully-sharded input layout (x over 'spy', ky
    # over 'spx', kz local) adds a third all-to-all and must still be
    # the exact same transform
    import jax
    from jax.sharding import NamedSharding

    mesh = pc.make_pencil_mesh(data=1, spx=2, spy=4)
    nx, ny, nz = shape
    nzh = nz // 2 + 1
    rng = np.random.RandomState(3)
    c_np = (
        rng.normal(size=(nx, ny, nzh)) + 1j * rng.normal(size=(nx, ny, nzh))
    ).astype(np.complex64)
    c = jax.device_put(jnp.asarray(c_np), pc.pencil_sigma_sharding(mesh))
    out = jax.jit(
        lambda c: pc.irfftn_pencil(c, shape, mesh, input_layout="state0")
    )(c)
    ref = np.fft.irfftn(c_np, s=shape, axes=(0, 1, 2), norm="forward")
    np.testing.assert_allclose(np.asarray(out), ref, rtol=2e-4, atol=1e-4)
    assert out.sharding.is_equivalent_to(
        pc.pencil_field_sharding(mesh), out.ndim
    )


def test_pencil_sample_power_matches_single_device():
    from randomfield_tpu import Generator

    shape, spacing = (16, 16, 16), 8.0
    g0 = Generator(*shape, grid_spacing=spacing)
    g1 = Generator(*shape, grid_spacing=spacing,
                   mesh=pc.make_pencil_mesh(data=2, spx=2, spy=2))
    k0, p0, n0 = g0.sample_power(3, nbins=8)
    k1, p1, n1 = g1.sample_power(3, nbins=8)
    np.testing.assert_allclose(n1, n0, rtol=1e-6)
    m = n0 > 0
    np.testing.assert_allclose(p1[m], p0[m], rtol=2e-4)


def test_pencil_sigma_fully_sharded():
    # the round-2 weak item: sigma must NOT replicate across 'spy'.
    # mesh scenes store nothing; on-demand materialization is sharded
    # over BOTH pencil axes (x over 'spy', ky over 'spx')
    from randomfield_tpu import Generator

    g = Generator(16, 16, 16, grid_spacing=8.0,
                  mesh=pc.make_pencil_mesh(data=2, spx=2, spy=2))
    assert g.state.sigmas is None  # render paths never materialize it
    s = g.sigmas
    assert s.sharding.spec == pc.P("spy", "spx", None)
    shard_bytes = max(
        sh.data.size * sh.data.dtype.itemsize for sh in s.addressable_shards
    )
    assert shard_bytes * 4 <= s.size * s.dtype.itemsize + 3
    g0 = Generator(16, 16, 16, grid_spacing=8.0)
    np.testing.assert_allclose(
        np.asarray(s), np.asarray(g0.sigmas), rtol=1e-6, atol=1e-9
    )


def test_pencil_shape_validation_generator():
    from randomfield_tpu import Generator

    with pytest.raises(ValueError):
        Generator(15, 16, 16, grid_spacing=8.0,
                  mesh=pc.make_pencil_mesh(data=1, spx=2, spy=4))


@pytest.mark.parametrize("los_axis", [0, 1, 2])
def test_pencil_power_multipoles_match_single_device(los_axis):
    # Kaiser-distorted render: P_0/P_2/P_4 from the pencil-distributed
    # estimator (shard-local mu^2 + Legendre binning, kz pad plane
    # masked) equal the single-device estimate, every LOS axis
    from randomfield_tpu import Generator
    from randomfield_tpu.validate import stats

    shape, spacing = (16, 16, 16), 8.0
    mesh = pc.make_pencil_mesh(data=2, spx=2, spy=2)
    g0 = Generator(*shape, grid_spacing=spacing)
    g1 = Generator(*shape, grid_spacing=spacing, mesh=mesh)
    d0 = g0.generate_kaiser_field(5, bias=1.3, f=0.7, los_axis=los_axis)
    d1 = g1.generate_kaiser_field(5, bias=1.3, f=0.7, los_axis=los_axis)
    k0, p0, c0 = stats.calculate_power_multipoles(
        d0, spacing, nbins=6, los_axis=los_axis
    )
    k1, p1, c1 = stats.calculate_power_multipoles(
        d1, spacing, nbins=6, los_axis=los_axis, mesh=mesh
    )
    np.testing.assert_allclose(c1, c0, rtol=1e-6)
    m = c0 > 0
    np.testing.assert_allclose(k1[m], k0[m], rtol=1e-5)
    np.testing.assert_allclose(
        p1[:, m], p0[:, m], rtol=5e-3, atol=2e-5 * np.nanmax(np.abs(p0))
    )


@pytest.mark.slow
def test_pencil_render_production_shard_geometry():
    """256^3 on a (2, 2, 2) pencil mesh: non-degenerate (x, y) block
    tiles through the full sharded program + estimator parity (the
    pencil counterpart of test_parallel's slow-tier geometry gate)."""
    import randomfield_tpu as rf
    from randomfield_tpu.validate import stats as _stats

    n = 256
    mesh = pc.make_pencil_mesh(data=2, spx=2, spy=2)
    g = rf.Generator(n, n, n, grid_spacing=8.0, mesh=mesh)
    d = g.generate_delta_field(seed=13, apply_lightcone=False)
    var = float(jnp.var(d))
    assert abs(var / g.predicted_variance() - 1.0) < 0.05
    k, p, nm = g.calculate_power(d, nbins=12)
    k0, p0, nm0 = _stats.calculate_power(np.asarray(d), 8.0, nbins=12)
    np.testing.assert_allclose(nm, nm0, rtol=1e-6)
    m = nm0 > 0
    np.testing.assert_allclose(p[m], p0[m], rtol=2e-3)
