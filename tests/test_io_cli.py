"""IO, scene serialization and CLI tests."""

import json
import subprocess
import sys

import numpy as np

from randomfield_tpu import Generator
from randomfield_tpu.utils import io as rio


def test_save_load_field_roundtrip(tmp_path):
    g = Generator(8, 8, 8, grid_spacing=10.0)
    d = g.generate_delta_field(3)
    path = rio.save_field(tmp_path / "f.npz", d, generator=g, seed=3,
                          extra={"note": "test"})
    back, meta = rio.load_field(path)
    np.testing.assert_array_equal(back, np.asarray(d))
    assert meta["seed"] == 3
    assert meta["scene"]["nx"] == 8
    assert meta["extra"]["note"] == "test"
    np.testing.assert_allclose(meta["power_k"], g.power.k)
    # regenerate from metadata: same seed -> same field
    scene = rio.scene_from_json(json.dumps(meta["scene"]))
    g2 = Generator(
        scene.nx, scene.ny, scene.nz, grid_spacing=scene.grid_spacing,
        cosmology=scene.cosmology,
        power=(meta["power_k"], meta["power_pk"]),
    )
    d2 = g2.generate_delta_field(meta["seed"])
    np.testing.assert_array_equal(np.asarray(d2), back)


def test_scene_json_roundtrip():
    g = Generator(8, 8, 16, grid_spacing=5.0, z0=0.25)
    text = rio.scene_to_json(g.scene)
    scene = rio.scene_from_json(text)
    assert scene == g.scene


def test_cli_end_to_end(tmp_path):
    out = tmp_path / "field_{seed}.npz"
    cmd = [
        sys.executable, "-m", "randomfield_tpu",
        "--nx", "8", "--spacing", "10.0", "--seed", "1", "2",
        "--stats", "--out", str(out), "--quiet",
    ]
    import os, pathlib

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=repo, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "P^" in res.stdout
    for seed in (1, 2):
        delta, meta = rio.load_field(tmp_path / f"field_{seed}.npz")
        assert delta.shape == (8, 8, 8)
        assert meta["seed"] == seed


def test_cli_catalog_modes(tmp_path):
    import os
    import pathlib

    import numpy as np

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    base = [sys.executable, "-m", "randomfield_tpu",
            "--nx", "16", "--spacing", "16.0", "--seed", "3"]

    out = tmp_path / "halos_{seed}.npz"
    res = subprocess.run(
        base + ["--catalog", "halos", "--mass-bins", "2", "--stats",
                "--nbins", "4", "--out", str(out)],
        capture_output=True, text=True, env=env, cwd=repo, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "halos (expected" in res.stdout and "exp" in res.stdout
    with np.load(tmp_path / "halos_3.npz") as z:
        assert z["positions"].shape[1] == 3
        assert z["positions"].shape[0] == z["masses"].shape[0] > 0
        assert str(z["catalog"]) == "halos"

    out2 = tmp_path / "gals_{seed}.npz"
    res = subprocess.run(
        base + ["--catalog", "galaxies-rsd", "--mass-bins", "2",
                "--out", str(out2), "--quiet"],
        capture_output=True, text=True, env=env, cwd=repo, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    with np.load(tmp_path / "gals_3.npz") as z:
        assert z["positions"].shape[0] == z["is_central"].shape[0] > 0

    # catalog mode excludes field/mesh flags
    res = subprocess.run(
        base + ["--catalog", "halos", "--lognormal"],
        capture_output=True, text=True, env=env, cwd=repo, timeout=600)
    assert res.returncode != 0 and "--lognormal" in res.stderr


def test_cli_mesh_modes(tmp_path):
    # --mesh / --pencil drive configs 4-5 from the command line on the
    # 8-virtual-device CPU mesh (VERDICT r02 item 8)
    import os, pathlib

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    out = tmp_path / "slab_{seed}.npz"
    cmd = [sys.executable, "-m", "randomfield_tpu", "--nx", "16",
           "--spacing", "8.0", "--seed", "3", "--mesh", "2,4",
           "--stats", "--out", str(out), "--quiet"]
    res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=repo, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "P^" in res.stdout
    delta, meta = rio.load_field(tmp_path / "slab_3.npz")
    assert delta.shape == (16, 16, 16)

    cmd = [sys.executable, "-m", "randomfield_tpu", "--nx", "16",
           "--spacing", "8.0", "--seed", "1", "2", "--pencil", "1,2,4",
           "--sample-power", "--nbins", "8", "--quiet"]
    res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=repo, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "<P^>" in res.stdout

    # mutually exclusive flags
    cmd = [sys.executable, "-m", "randomfield_tpu", "--nx", "8",
           "--spacing", "8.0", "--mesh", "2,4", "--pencil", "1,2,4"]
    res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=repo, timeout=600)
    assert res.returncode != 0


def test_sharded_io_roundtrip_host_array(tmp_path):
    # plain host arrays write one chunk and round-trip exactly
    rng = np.random.RandomState(0)
    delta = rng.normal(size=(8, 8, 8)).astype(np.float32)
    d = tmp_path / "chunks"
    rio.save_field_sharded(d, delta, seed=42)
    back, meta = rio.load_field_sharded(d)
    np.testing.assert_array_equal(back, delta)
    assert meta["seed"] == 42


def test_sharded_io_roundtrip_mesh(tmp_path):
    # sharded render -> per-shard chunks -> host reassembly == gather,
    # and resharded load returns identical shards (verdict item 8)
    import jax
    from randomfield_tpu.parallel.mesh import field_sharding, make_mesh

    mesh = make_mesh(data=2, space=4)
    g = Generator(16, 16, 16, grid_spacing=8.0, mesh=mesh)
    delta = g.generate_delta_field(5)
    d = tmp_path / "chunks"
    rio.save_field_sharded(d, delta, generator=g, seed=5)
    # one chunk per unique 'space' slab: replicas collapse onto one file
    assert len(list(d.glob("chunk_*.npz"))) == 4

    full, meta = rio.load_field_sharded(d)
    np.testing.assert_allclose(full, np.asarray(delta), rtol=0, atol=0)
    assert meta["scene"]["nx"] == 16
    assert meta["dtype"] == "float32"

    resharded, _ = rio.load_field_sharded(d, sharding=field_sharding(mesh))
    assert resharded.sharding == field_sharding(mesh)
    np.testing.assert_array_equal(np.asarray(resharded), np.asarray(delta))


def test_cli_sample_power_ensemble(tmp_path):
    out = tmp_path / "cov.npz"
    ckpt = tmp_path / "ck.npz"
    cmd = [sys.executable, "-m", "randomfield_tpu", "--nx", "16",
           "--spacing", "8.0", "--seed", "1", "2", "3", "--sample-power",
           "--nbins", "8", "--checkpoint", str(ckpt),
           "--out", str(tmp_path / "{seed}.npz"), "--quiet"]
    import os, pathlib

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(cmd, capture_output=True, text=True,
                       env=env, cwd=repo, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "<P^>" in r.stdout and "scatter" in r.stdout
    assert ckpt.exists()
    with np.load(tmp_path / "ensemble.npz") as f:
        assert f["p_hat"].shape[0] == 3
        assert f["covariance"].shape == (8, 8)


def test_cli_named_power_and_cosmology_overrides(tmp_path):
    import os
    import pathlib

    out = tmp_path / "field_{seed}.npz"
    cmd = [
        sys.executable, "-m", "randomfield_tpu",
        "--nx", "8", "--spacing", "32.0", "--seed", "5",
        "--power", "bbks", "--w0", "-0.9", "--ok0", "0.02",
        "--stats", "--out", str(out), "--quiet",
    ]
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=repo, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    delta, meta = rio.load_field(tmp_path / "field_5.npz")
    assert delta.shape == (8, 8, 8)


def test_cli_lognormal(tmp_path):
    import os
    import pathlib

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    out = tmp_path / "ln_{seed}.npz"
    cmd = [sys.executable, "-m", "randomfield_tpu", "--nx", "16",
           "--spacing", "16.0", "--seed", "7", "--lognormal",
           "--stats", "--out", str(out), "--quiet"]
    res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=repo, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    delta, meta = rio.load_field(tmp_path / "ln_7.npz")
    assert delta.shape == (16, 16, 16)
    assert delta.min() > -1.0  # lognormal fields are bounded below
    assert meta["extra"]["model"] == "lognormal"
    # provenance carries the TARGET spectrum (here the default table),
    # not the Gaussianized one
    from randomfield_tpu.ops.power import load_default_power

    default = load_default_power()
    assert np.allclose(meta["power_k"], default.k)
    assert np.allclose(meta["power_pk"], default.Pk)

    # --lognormal + --sample-power is a usage error
    cmd = [sys.executable, "-m", "randomfield_tpu", "--nx", "8",
           "--spacing", "16.0", "--lognormal", "--sample-power"]
    res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=repo, timeout=600)
    assert res.returncode != 0


def test_cli_fixed(tmp_path):
    import os
    import pathlib

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    out = tmp_path / "fx_{seed}.npz"
    base = [sys.executable, "-m", "randomfield_tpu", "--nx", "16",
            "--spacing", "16.0", "--seed", "7", "--fixed", "--quiet"]
    res = subprocess.run(base + ["--out", str(out)], capture_output=True,
                         text=True, env=env, cwd=repo, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    delta, meta = rio.load_field(tmp_path / "fx_7.npz")
    assert meta["extra"]["fixed"] is True and meta["extra"]["flip"] is False
    out2 = tmp_path / "fx2_{seed}.npz"
    res = subprocess.run(base + ["--flip", "--out", str(out2)],
                         capture_output=True, text=True, env=env, cwd=repo,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    paired, meta2 = rio.load_field(tmp_path / "fx2_7.npz")
    assert meta2["extra"]["flip"] is True
    np.testing.assert_allclose(paired, -delta, atol=1e-6)  # Gaussian pair

    # usage errors are loud
    for bad in (["--flip"], ["--fixed", "--sample-power"]):
        cmd = [sys.executable, "-m", "randomfield_tpu", "--nx", "8",
               "--spacing", "16.0"] + bad
        res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                             cwd=repo, timeout=600)
        assert res.returncode != 0


def test_cli_biased_tracer_and_xi(tmp_path):
    import os
    import pathlib

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    out = tmp_path / "tr_{seed}.npz"
    cmd = [sys.executable, "-m", "randomfield_tpu", "--nx", "16",
           "--spacing", "16.0", "--seed", "3", "--lognormal",
           "--bias", "1.7", "--stats", "--xi", "--out", str(out)]
    res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=repo, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "xi =" in res.stdout  # --xi printed correlation bins
    delta, meta = rio.load_field(tmp_path / "tr_3.npz")
    assert delta.min() > -1.0
    assert meta["extra"]["model"] == "lognormal"
    assert meta["extra"]["bias"] == 1.7

    # usage errors: --bias without --lognormal, or with --fixed
    for bad in (["--nx", "8", "--spacing", "16.0", "--bias", "2.0"],
                ["--nx", "8", "--spacing", "16.0", "--lognormal",
                 "--bias", "2.0", "--fixed"]):
        res = subprocess.run(
            [sys.executable, "-m", "randomfield_tpu"] + bad,
            capture_output=True, text=True, env=env, cwd=repo, timeout=600)
        assert res.returncode != 0


def test_cli_morphology_flags(tmp_path):
    """--minkowski / --peaks print measured + predicted morphology for
    plain Gaussian renders, and refuse lightcone-weighted fields."""
    import os, pathlib

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    cmd = [sys.executable, "-m", "randomfield_tpu", "--nx", "24",
           "--spacing", "4.0", "--seed", "0", "--smoothing", "8.0",
           "--no-lightcone", "--minkowski", "--peaks", "--nbins", "7",
           "--quiet"]
    res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=repo, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "v3 =" in res.stdout and "[exp v3" in res.stdout
    assert "lattice maxima (BBKS expects" in res.stdout

    # lognormal: measured morphology prints, Gaussian predictions do not
    res = subprocess.run(
        cmd + ["--lognormal"], capture_output=True, text=True, env=env,
        cwd=repo, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "v3 =" in res.stdout and "[exp v3" not in res.stdout
    assert "BBKS expects" not in res.stdout

    # usage error without --no-lightcone
    res = subprocess.run(
        [sys.executable, "-m", "randomfield_tpu", "--nx", "8",
         "--spacing", "4.0", "--peaks"],
        capture_output=True, text=True, env=env, cwd=repo, timeout=600)
    assert res.returncode != 0


def test_cli_rsd(tmp_path):
    """--rsd renders Kaiser fields; --stats prints measured + expected
    multipoles; usage errors guard the snapshot/isotropy constraints."""
    import os
    import pathlib

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    out = tmp_path / "rsd_{seed}.npz"
    cmd = [sys.executable, "-m", "randomfield_tpu", "--nx", "16",
           "--spacing", "16.0", "--seed", "3", "--rsd", "0.6",
           "--bias", "1.5", "--no-lightcone", "--stats", "--nbins", "5",
           "--out", str(out)]
    res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=repo, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "P0 =" in res.stdout and "P4 =" in res.stdout
    delta, meta = rio.load_field(tmp_path / "rsd_3.npz")
    assert meta["extra"]["model"] == "kaiser"
    assert meta["extra"]["growth_rate_f"] == 0.6
    assert meta["extra"]["bias"] == 1.5

    # --rsd without a value uses the cosmology's growth rate
    res = subprocess.run(
        [sys.executable, "-m", "randomfield_tpu", "--nx", "16",
         "--spacing", "16.0", "--seed", "1", "--rsd", "--no-lightcone",
         "--quiet"],
        capture_output=True, text=True, env=env, cwd=repo, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]

    # usage errors: missing --no-lightcone; composing with --lognormal
    for bad in (["--nx", "8", "--spacing", "16.0", "--rsd"],
                ["--nx", "8", "--spacing", "16.0", "--rsd",
                 "--no-lightcone", "--lognormal"]):
        res = subprocess.run(
            [sys.executable, "-m", "randomfield_tpu"] + bad,
            capture_output=True, text=True, env=env, cwd=repo, timeout=600)
        assert res.returncode != 0


def test_cli_voids(tmp_path):
    """--voids prints a non-overlapping SO catalog summary + the void
    size function; works on mesh scenes too (mesh-native path)."""
    import os, pathlib

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    base = [sys.executable, "-m", "randomfield_tpu", "--nx", "32",
            "--spacing", "4.0", "--seed", "3", "--no-lightcone",
            "--voids", "6,9,12", "--void-threshold", "-0.2", "--quiet"]
    res = subprocess.run(base, capture_output=True, text=True, env=env,
                         cwd=repo, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "voids:" in res.stdout and "dn/dlnR" in res.stdout
    line = [ln for ln in res.stdout.splitlines() if "voids:" in ln][0]

    env2 = dict(env)
    env2["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    res2 = subprocess.run(base + ["--mesh", "2,4"], capture_output=True,
                          text=True, env=env2, cwd=repo, timeout=600)
    assert res2.returncode == 0, res2.stderr[-2000:]
    line2 = [ln for ln in res2.stdout.splitlines() if "voids:" in ln][0]
    assert line2 == line  # same catalog size, mesh or not
