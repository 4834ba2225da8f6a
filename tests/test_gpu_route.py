"""The GPU route: plain XLA and cuFFT where hand-written kernels were.

CPU tests of what the program runs on the GPU: plain XLA transforms and
``jax.random`` sampling, the memory rule that picks the pipeline, the
sigma evaluated inline on meshes, the compile-cache helper, and the
entry points that must refuse the removed hardware-PRNG sampler or a
machine without a GPU.
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import randomfield_tpu as rf
from randomfield_tpu.engine import generator as gen
from randomfield_tpu.engine import staged
from randomfield_tpu.ops import power as _power
from randomfield_tpu.parallel import dfft
from randomfield_tpu.parallel import pencil as pc
from randomfield_tpu.parallel.mesh import make_mesh
from randomfield_tpu.utils import cache as _cache
from randomfield_tpu.utils import device as _device

REPO = pathlib.Path(__file__).resolve().parent.parent

# what a JAX process may allocate on an 80 GB H100 (three quarters of
# the card, as jax.devices()[0].memory_stats()["bytes_limit"] reports)
# and on a 16 GB device
H100_LIMIT = int(59.38 * 2**30)
SMALL_LIMIT = 12 * 2**30


class _FakeDevice:
    platform = "gpu"

    def __init__(self, limit):
        self._limit = limit

    def memory_stats(self):
        return None if self._limit is None else {"bytes_limit": self._limit}


# ---- pipeline choice from device memory -----------------------------------

@pytest.mark.parametrize("limit,n,want", [
    (H100_LIMIT, 256, "fused"),
    (H100_LIMIT, 512, "fused"),
    (H100_LIMIT, 1024, "fused"),
    (H100_LIMIT, 2048, "staged"),
    (SMALL_LIMIT, 256, "fused"),
    (SMALL_LIMIT, 512, "fused"),
    (SMALL_LIMIT, 1024, "staged"),
    (SMALL_LIMIT, 2048, "staged"),
    (None, 256, "fused"),
    (None, 512, "fused"),
    (None, 1024, "staged"),
    (None, 2048, "staged"),
])
def test_pick_pipeline_from_memory_stats(limit, n, want, monkeypatch):
    monkeypatch.setattr(_device.jax, "local_devices",
                        lambda *a, **k: [_FakeDevice(limit)])
    assert staged.pick_pipeline((n, n, n), "auto") == want
    # explicit choices are never overridden by the memory rule
    assert staged.pick_pipeline((n, n, n), "fused") == "fused"
    assert staged.pick_pipeline((n, n, n), "staged") == "staged"


@pytest.mark.parametrize("limit,want", [
    (H100_LIMIT, 16), (SMALL_LIMIT, 64), (None, 64),
])
def test_tail_chunks_from_memory_stats(limit, want, monkeypatch):
    monkeypatch.setattr(_device.jax, "local_devices",
                        lambda *a, **k: [_FakeDevice(limit)])
    assert staged._tail_chunks((1024, 1024, 1024)) == want


# ---- nothing on the GPU route reaches Pallas ------------------------------

def _pallas_modules():
    return {m for m in sys.modules if "pallas" in m or "mosaic" in m}


@pytest.fixture
def as_gpu(monkeypatch):
    monkeypatch.setattr(_device, "platform", lambda: "gpu")
    monkeypatch.setattr(_device, "bytes_limit", lambda: H100_LIMIT)


@pytest.mark.parametrize("case", [
    "fused_1024", "staged", "slab", "pencil", "ensemble", "sample_power",
])
def test_gpu_route_reaches_no_pallas(case, as_gpu):
    before = _pallas_modules()
    if case == "fused_1024":
        n = 1024
        assert staged.pick_pipeline((n, n, n), "auto") == "fused"
        f32 = jnp.float32
        lowered = gen.render.lower(
            jax.eval_shape(lambda: jax.random.key(0)),
            jax.ShapeDtypeStruct((n, n, n // 2 + 1), f32),
            jax.ShapeDtypeStruct((n,), f32), jax.ShapeDtypeStruct((), f32),
            shape=(n, n, n), spacing=2.0,
        )
        # no hand-written kernel: every op is plain StableHLO
        assert "custom_call" not in lowered.as_text()
    else:
        mesh = {"slab": make_mesh(1, 4),
                "pencil": pc.make_pencil_mesh(1, 2, 2)}.get(case)
        pipeline = "staged" if case == "staged" else "auto"
        g = rf.Generator(16, 16, 16, grid_spacing=8.0, mesh=mesh,
                         pipeline=pipeline)
        if case == "ensemble":
            out = g.generate_delta_fields([1, 2])
        elif case == "sample_power":
            out = jnp.asarray(g.sample_power(3, nbins=6)[1])
        else:
            out = g.generate_delta_field(3)
        a = np.asarray(out)
        assert np.isfinite(a[~np.isnan(a)]).all()
    assert _pallas_modules() == before
    assert not [m for m in sys.modules
                if m.startswith("randomfield_tpu") and "pallas" in m]


# ---- inverse FFTs stay below the 32-bit element limit ---------------------

@pytest.mark.parametrize("op", ["ifft_minor", "irfft_minor", "irfftn",
                                "mesh_slab"])
def test_inverse_fft_chunks_above_element_limit(op, monkeypatch):
    # a small limit forces the chunked path; results must not change
    from randomfield_tpu.ops import transform as tr

    shape = (16, 8, 12)
    rng = np.random.RandomState(5)
    c = jnp.asarray(np.fft.rfftn(rng.normal(size=shape)), jnp.complex64)
    fns = {
        "ifft_minor": tr.ifft_minor,
        "irfft_minor": lambda a: tr.irfft_minor(a, shape[2],
                                                assume_hermitian=True),
        "irfftn": lambda a: tr.irfftn(a, shape),
        "mesh_slab": lambda a: dfft.irfftn_slab(
            a, shape, make_mesh(1, 4), assume_hermitian=True),
    }
    def run():
        # a fresh function each time, so jit traces under the current limit
        return np.asarray(jax.jit(lambda a: fns[op](a))(c)), str(
            jax.make_jaxpr(lambda a: fns[op](a))(c))

    want, plain = run()
    monkeypatch.setattr(tr, "MAX_FFT_ELEMENTS", 200)
    got, chunked = run()
    assert "scan" not in plain and "scan" in chunked
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-6 * scale, rtol=1e-5)


# ---- the removed sampler is refused --------------------------------------

@pytest.mark.parametrize("entry", ["api", "lognormal", "cli"])
def test_pallas_sampler_is_refused(entry, monkeypatch, tmp_path):
    if entry == "api":
        with pytest.raises(ValueError, match="threefry"):
            rf.Generator(8, 8, 8, grid_spacing=8.0, sampler="pallas")
    elif entry == "lognormal":
        from randomfield_tpu.models.lognormal import LognormalGenerator

        with pytest.raises(ValueError, match="threefry"):
            LognormalGenerator(8, 8, 8, grid_spacing=8.0, sampler="pallas")
    else:
        from randomfield_tpu.__main__ import main

        # with the variable set, the CLI's cache helper changes nothing
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        with pytest.raises(ValueError, match="threefry"):
            main(["--nx", "8", "--spacing", "8.0", "--sampler", "pallas",
                  "--quiet"])


# ---- sigma inline (mesh programs) equals the tabulated grid ---------------

@pytest.mark.parametrize("shape", [(8, 8, 8), (16, 8, 12), (12, 16, 10),
                                   (32, 32, 32)])
@pytest.mark.parametrize("smoothing", [0.0, 8.0])
@pytest.mark.parametrize("interpolation", ["log10k", "loglog"])
def test_sigma_inline_matches_tabulate(shape, smoothing, interpolation):
    spacing = 8.0
    table = _power.load_default_power()
    want = _power.filter_modes(
        _power.tabulate_sigmas(shape, spacing, table, interpolation),
        shape, spacing, jnp.float32(smoothing),
    )
    lk, val, log_values = _power.table_arrays_host(
        table, interpolation, jnp.float32)
    got = jax.jit(lambda lk, val, s: _power.filter_modes(
        _power.sigma_inline(shape, spacing, lk, val, log_values,
                            jnp.float32, layout="xyz"),
        shape, spacing, s,
    ))(lk, val, jnp.float32(smoothing))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-6, atol=0)


# ---- the native mesh transforms against numpy float64 ----------------------

def _mesh(kind):
    return make_mesh(2, 4) if kind == "slab" else pc.make_pencil_mesh(2, 2, 2)


@pytest.mark.parametrize("kind", ["slab", "pencil"])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("direction", ["inverse", "forward", "weighted"])
def test_mesh_native_route_matches_numpy(kind, batched, direction):
    shape = (16, 8, 12)
    mesh = _mesh(kind)
    rng = np.random.RandomState(7)
    lead = (2,) if batched else ()
    x = rng.normal(size=lead + shape)
    c = np.fft.rfftn(x, axes=(-3, -2, -1))
    w = rng.uniform(0.5, 1.5, size=shape[2])
    if direction == "forward":
        fn = dfft.rfftn_slab if kind == "slab" else pc.rfftn_pencil
        got = np.asarray(jax.jit(
            lambda a: fn(a, shape, mesh, batched=batched)
        )(jnp.asarray(x, jnp.float32)))
        want = c
    else:
        weights = jnp.asarray(w, jnp.float32) if direction == "weighted" else None
        if kind == "slab":
            fn = lambda a: dfft.irfftn_slab(  # noqa: E731
                a, shape, mesh, batched=batched, assume_hermitian=True,
                weights=weights)
        else:
            fn = lambda a: pc.irfftn_pencil(  # noqa: E731
                a, shape, mesh, batched=batched, assume_hermitian=True,
                weights=weights)
        got = np.asarray(jax.jit(fn)(jnp.asarray(c, jnp.complex64)))
        want = np.fft.irfftn(c, s=shape, axes=(-3, -2, -1), norm="forward")
        if weights is not None:
            want = want * w
    scale = np.abs(want).std()
    np.testing.assert_allclose(got, want, atol=2e-5 * scale, rtol=2e-4)


# ---- sample_power against the field-space estimate ------------------------

@pytest.mark.parametrize("shape", [(16, 16, 16), (24, 16, 8), (16, 8, 12),
                                   (32, 32, 32)])
@pytest.mark.parametrize("pipeline", ["fused", "staged"])
def test_sample_power_matches_field_estimate(shape, pipeline):
    g = rf.Generator(*shape, grid_spacing=8.0, pipeline=pipeline)
    k, p, n = g.sample_power(4, nbins=8)
    d = g.generate_delta_field(4, apply_lightcone=False)
    kf, pf, nf = g.calculate_power(d, nbins=8)
    np.testing.assert_array_equal(n, nf)
    m = n > 0
    np.testing.assert_allclose(k[m], kf[m], rtol=1e-6)
    np.testing.assert_allclose(p[m], pf[m], rtol=2e-4,
                               atol=1e-6 * np.abs(pf[m]).max())


# ---- the compile cache sits at one fixed place ---------------------------

@pytest.fixture
def cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_uses_env_and_sets_nothing(monkeypatch, tmp_path,
                                                 cache_config):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert _cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = _cache.enable_compile_cache()
    assert path == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert pathlib.Path(path).is_dir()


def test_compile_cache_path_is_stable():
    # no temporary name, pid or time: the path is the checkout's own
    assert _cache.DEFAULT_CACHE_DIR == REPO / ".jax_cache"
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()
    assert str(os.getpid()) not in str(_cache.DEFAULT_CACHE_DIR)


# ---- chip_smoke.py refuses to run without a GPU ---------------------------

@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    script = REPO / "chip_smoke.py"
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    else:
        cwd = REPO
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, env=env, cwd=cwd, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
