"""Staged (HBM-lean) pipeline: exactness vs the float64 oracle.

The staged pipeline samples its unit normals in (x, kz, y) order (see
engine/staged.py), so it is validated the same way the fused path is —
feed the identical draws to the numpy float64 oracle and require
agreement to f32 rounding — plus cross-pipeline statistical checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from randomfield_tpu import Generator
from randomfield_tpu.engine.staged import pick_pipeline, staged_render
from randomfield_tpu.validate import oracle


@pytest.mark.parametrize("shape", [(16, 16, 16), (24, 16, 8)])
@pytest.mark.parametrize("smoothing", [0.0, 12.0])
def test_staged_matches_oracle(shape, smoothing):
    g = Generator(*shape, grid_spacing=8.0, pipeline="staged")
    nx, ny, nz = shape
    key = jax.random.key(3)
    got = np.asarray(
        staged_render(
            key, g.state.sigmas, g._weights(True),
            jnp.asarray(smoothing, jnp.float32), shape, 8.0,
        )
    )
    # reproduce the staged pipeline's per-slab draws and feed them to the
    # oracle in standard (x, y, kz) order
    from randomfield_tpu.engine.staged import _pick_chunks

    chunks = _pick_chunks(nx, 16)
    cx = nx // chunks
    draws = np.concatenate(
        [
            np.asarray(
                jax.random.normal(
                    jax.random.fold_in(key, i), (2, cx, nz // 2 + 1, ny), jnp.float32
                )
            )
            for i in range(chunks)
        ],
        axis=1,
    )
    table = g.power
    want = oracle.render_from_noise(
        draws[0].transpose(0, 2, 1).astype(np.float64),
        draws[1].transpose(0, 2, 1).astype(np.float64),
        shape, 8.0, (table.k, table.Pk),
        smoothing_length=smoothing,
        plane_weights=g.growth_function,
    )
    scale = max(np.std(want), 1e-12)
    np.testing.assert_allclose(got, want, atol=3e-5 * scale, rtol=3e-4)


def test_staged_deterministic_and_statistical():
    g = Generator(16, 16, 16, grid_spacing=8.0, pipeline="staged")
    a = np.asarray(g.generate_delta_field(7, apply_lightcone=False))
    b = np.asarray(g.generate_delta_field(7, apply_lightcone=False))
    np.testing.assert_array_equal(a, b)
    fields = np.asarray(
        g.generate_delta_fields(np.arange(32), apply_lightcone=False), np.float64
    )
    pred = g.predicted_variance()
    assert abs(fields.var() - pred) < 0.15 * pred


@pytest.mark.parametrize("shape", [(16, 16, 16), (24, 16, 8)])
def test_fused_and_staged_draw_one_canonical_stream(shape):
    """Round-4 item: same seed => same realization on every Threefry
    pipeline (ops/sample.py:unit_draws), so pipeline='auto' can never
    change family across the staged threshold.  Equality is to f32
    rounding: sigma scaling and symmetrization apply in different
    orders between the pipelines."""
    gf = Generator(*shape, grid_spacing=8.0, pipeline="fused")
    gs = Generator(*shape, grid_spacing=8.0, pipeline="staged")
    for seed in (0, 11):
        a = np.asarray(gf.generate_delta_field(seed, smoothing_length=4.0))
        b = np.asarray(gs.generate_delta_field(seed, smoothing_length=4.0))
        scale = max(np.std(a), 1e-12)
        np.testing.assert_allclose(a, b, atol=3e-5 * scale, rtol=3e-4)


def test_generate_noise_matches_canonical_stream():
    """generate_noise exports the canonical chunked draws in the fused
    (2, nx, ny, nzh) contract; reconstruct them by hand from the staged
    chunk definition."""
    from randomfield_tpu.ops.sample import canonical_chunks

    shape = (12, 8, 10)
    nx, ny, nz = shape
    g = Generator(*shape, grid_spacing=8.0, pipeline="fused")
    got = np.asarray(g.generate_noise(5))
    key = jax.random.key(5)
    chunks = canonical_chunks(nx)
    cx = nx // chunks
    want = np.concatenate(
        [
            np.asarray(
                jax.random.normal(
                    jax.random.fold_in(key, i),
                    (2, cx, nz // 2 + 1, ny), jnp.float32,
                )
            ).transpose(0, 1, 3, 2)
            for i in range(chunks)
        ],
        axis=1,
    )
    np.testing.assert_array_equal(got, want)


def test_pick_pipeline():
    assert pick_pipeline((64, 64, 64), "auto") == "fused"
    assert pick_pipeline((1024, 1024, 1024), "auto") == "staged"
    assert pick_pipeline((16, 16, 16), "staged") == "staged"
    with pytest.raises(ValueError):
        pick_pipeline((16, 16, 16), "bogus")


def test_staged_lightcone():
    g = Generator(8, 8, 32, grid_spacing=100.0, pipeline="staged")
    lc = np.asarray(g.generate_delta_field(5, apply_lightcone=True))
    raw = np.asarray(g.generate_delta_field(5, apply_lightcone=False))
    growth = np.asarray(g.growth_function)
    np.testing.assert_allclose(
        lc, raw * growth[None, None, :].astype(np.float32), rtol=2e-5, atol=1e-7
    )


def test_v2_pipeline_matches_v1_exactly():
    # same p1 stream, two different inverse-transform implementations
    import os

    from randomfield_tpu.engine import staged as st

    shape, spacing = (16, 16, 16), 4.0
    assert st._can_v2(shape)
    g = Generator(*shape, grid_spacing=spacing, pipeline="staged")
    os.environ["RF_STAGED_PIPELINE"] = "v1"
    try:
        a = np.asarray(g.generate_delta_field(9, smoothing_length=2.0))
        os.environ["RF_STAGED_PIPELINE"] = "v2"
        b = np.asarray(g.generate_delta_field(9, smoothing_length=2.0))
    finally:
        del os.environ["RF_STAGED_PIPELINE"]
    scale = np.std(a)
    np.testing.assert_allclose(a, b, atol=2e-5 * scale, rtol=2e-4)


def test_v2_requires_compatible_shape():
    from randomfield_tpu.engine import staged as st

    assert not st._can_v2((17, 16, 16))   # prime nx
    assert not st._can_v2((16, 16, 15))   # odd nz
    assert not st._can_v2((16, 16, 26))   # nz/2 = 13 prime
    assert st._can_v2((12, 20, 36))


def test_odd_grid_staged_falls_back_to_v1():
    # odd nz cannot use the half-pack; the render must still be correct
    g = Generator(12, 12, 15, grid_spacing=4.0, pipeline="staged")
    d = np.asarray(g.generate_delta_field(3))
    assert d.shape == (12, 12, 15)
    assert np.isfinite(d).all()
