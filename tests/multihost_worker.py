"""Worker process for the multi-host integration test.

Run as: python multihost_worker.py <process_id> <num_processes> <port> <tmpdir>

Each worker provisions 4 virtual CPU devices and joins a Gloo-backed
global runtime — the stand-in for one host of a multi-host cluster.  Asserts the multi-process sharded render, power estimator,
moments, batch ensemble, and sharded IO all match a single-device ground
truth computed in-process.
"""

import os
import pathlib
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
tmpdir = pathlib.Path(sys.argv[4])

from randomfield_tpu.parallel import multihost  # noqa: E402

multihost.initialize(
    f"localhost:{port}", nproc, pid, cpu_devices_per_process=4
)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import randomfield_tpu as rf  # noqa: E402
from randomfield_tpu.parallel.mesh import make_mesh  # noqa: E402
from randomfield_tpu.utils.io import (  # noqa: E402
    load_field_sharded,
    save_field_sharded,
)
from randomfield_tpu.validate.stats import field_moments  # noqa: E402

assert multihost.is_multiprocess()
assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == 4 * nproc, jax.devices()
assert len(jax.local_devices()) == 4

shape, spacing = (16, 16, 16), 8.0
mesh = make_mesh(data=2, space=4)
g = rf.Generator(*shape, grid_spacing=spacing, mesh=mesh)

# ground truth: single-(local-)device render in this same process
g0 = rf.Generator(*shape, grid_spacing=spacing)
d0 = np.asarray(g0.generate_delta_field(3))
scale = float(np.std(d0))

# 1. sharded render matches the single-device field shard by shard
d = g.generate_delta_field(3)
assert not d.is_fully_addressable  # genuinely process-spanning
for s in d.addressable_shards:
    np.testing.assert_allclose(
        np.asarray(s.data), d0[s.index], atol=1e-5 * scale, rtol=2e-4
    )

# 2. distributed P(k) matches the single-device estimate
k1, p1, m1 = g.calculate_power(d)
k0, p0, m0 = g0.calculate_power(jnp.asarray(d0))
np.testing.assert_allclose(m1, m0)
np.testing.assert_allclose(p1, p0, rtol=1e-3)

# 3. accumulation-safe moments work on a process-spanning array
mean1, var1 = field_moments(d)
mean0, var0 = field_moments(jnp.asarray(d0))
assert abs(mean1 - mean0) < 1e-6 + 1e-3 * abs(mean0)
assert abs(var1 - var0) < 1e-3 * var0

# 4. batched ensemble over the 'data' axis matches per-seed renders
batch = g.generate_delta_fields([3, 5], smoothing_length=4.0)
ref3 = np.asarray(g0.generate_delta_field(3, smoothing_length=4.0))
ref5 = np.asarray(g0.generate_delta_field(5, smoothing_length=4.0))
for s in batch.addressable_shards:
    ref = np.stack([ref3, ref5])[s.index]
    np.testing.assert_allclose(
        np.asarray(s.data), ref, atol=1e-5 * scale, rtol=2e-4
    )

# 4b. pencil (2-D) decomposition across processes
from randomfield_tpu.parallel.pencil import make_pencil_mesh  # noqa: E402

pmesh = make_pencil_mesh(data=2, spx=2, spy=2)
gp = rf.Generator(*shape, grid_spacing=spacing, mesh=pmesh)
dp = gp.generate_delta_field(3)
assert not dp.is_fully_addressable
for s in dp.addressable_shards:
    np.testing.assert_allclose(
        np.asarray(s.data), d0[s.index], atol=1e-5 * scale, rtol=2e-4
    )
kp, pp, mp = gp.calculate_power(dp)
np.testing.assert_allclose(pp, p0, rtol=1e-3)

# 4b2. distributed xi(r) and P_ell(k) on the process-spanning field
from randomfield_tpu.validate import stats as _stats

rx1, xi1, nc1 = _stats.calculate_correlation(d, spacing, nbins=6, mesh=mesh)
rx0, xi0, nc0 = _stats.calculate_correlation(jnp.asarray(d0), spacing,
                                             nbins=6)
np.testing.assert_allclose(nc1, nc0, rtol=1e-6)
mc = nc0 > 0
np.testing.assert_allclose(xi1[mc], xi0[mc], rtol=5e-3,
                           atol=1e-5 * np.abs(xi0[mc]).max())
kl1, pl1, cl1 = _stats.calculate_power_multipoles(d, spacing, nbins=6,
                                                  mesh=mesh)
kl0, pl0, cl0 = _stats.calculate_power_multipoles(jnp.asarray(d0), spacing,
                                                  nbins=6)
np.testing.assert_allclose(cl1, cl0, rtol=1e-6)
mlm = cl0 > 0
np.testing.assert_allclose(pl1[:, mlm], pl0[:, mlm], rtol=5e-3,
                           atol=2e-5 * np.nanmax(np.abs(pl0)))

# 4c. distributed FFT-free sample_power across processes (the
# from_seed=True sharded sampling + shard-local binning program)
ks1, ps1, ns1 = g.sample_power(3, nbins=8)
ks0, ps0, ns0 = g0.sample_power(3, nbins=8)
np.testing.assert_allclose(ns1, ns0, rtol=1e-6)
msk = ns0 > 0
np.testing.assert_allclose(ps1[msk], ps0[msk], rtol=2e-4)

# 4d. mesh-native derived fields across processes (spectral kernel
# fused into the sharded render)
phi0 = np.asarray(g0.generate_potential(3))
phi = g.generate_potential(3)
assert not phi.is_fully_addressable
psc = float(np.abs(phi0).max())
for s in phi.addressable_shards:
    np.testing.assert_allclose(
        np.asarray(s.data), phi0[s.index], atol=1e-5 * psc, rtol=2e-4
    )

# 4e. predicted_variance via the inline-table path agrees
pv1, pv0 = g.predicted_variance(4.0), g0.predicted_variance(4.0)
assert abs(pv1 - pv0) < 1e-4 * pv0, (pv1, pv0)

# 5. per-process sharded IO round-trips without gathering
outdir = tmpdir / "field_chunks"
save_field_sharded(outdir, d, generator=g, seed=3)
from jax.experimental import multihost_utils  # noqa: E402

multihost_utils.sync_global_devices("io-written")
if pid == 0:
    full, meta = load_field_sharded(outdir)
    np.testing.assert_allclose(full, d0, atol=1e-5 * scale, rtol=2e-4)
    assert meta["seed"] == 3
    assert tuple(meta["global_shape"]) == shape
multihost_utils.sync_global_devices("io-checked")

print("MULTIHOST_OK", flush=True)
