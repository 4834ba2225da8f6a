"""Odd and anisotropic grid dimensions through every pipeline."""

import numpy as np
import pytest

from randomfield_tpu import Generator
from randomfield_tpu.validate import oracle, stats


@pytest.mark.parametrize("shape", [(12, 20, 28), (10, 14, 9), (8, 8, 18)])
@pytest.mark.parametrize("pipeline", ["fused", "staged"])
def test_anisotropic_and_odd_grids(shape, pipeline):
    g = Generator(*shape, grid_spacing=8.0, pipeline=pipeline)
    d = np.asarray(g.generate_delta_field(3, apply_lightcone=False), np.float64)
    assert d.shape == shape
    assert np.all(np.isfinite(d))
    pred = g.predicted_variance()
    # single realization: loose statistical check
    assert 0.4 * pred < d.var() < 2.5 * pred


def test_odd_nz_statistics_fused():
    # odd nz: no Nyquist plane; the kz=0 plane is the only self-conjugate
    shape = (16, 16, 15)
    g = Generator(*shape, grid_spacing=8.0)
    fields = np.asarray(
        g.generate_delta_fields(np.arange(48), apply_lightcone=False), np.float64
    )
    pred = g.predicted_variance()
    assert abs(fields.var() - pred) < 0.12 * pred


def test_sample_power_anisotropic():
    g = Generator(12, 20, 16, grid_spacing=6.0)
    k0, p0, n0 = g.sample_power(1, nbins=8)
    d = g.generate_delta_field(1, apply_lightcone=False)
    k1, p1, n1 = g.calculate_power(d, nbins=8)
    mask = n0 > 0
    np.testing.assert_allclose(p0[mask], p1[mask], rtol=1e-3)


def test_cli_rectangular(tmp_path):
    import os
    import pathlib
    import subprocess
    import sys

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-m", "randomfield_tpu", "--nx", "8", "--ny", "12",
         "--nz", "10", "--spacing", "10.0", "--quiet", "--stats"],
        capture_output=True, text=True, env=env, cwd=repo, timeout=600,
    )
    assert res.returncode == 0, res.stderr[-1500:]
