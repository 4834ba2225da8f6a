"""Mesh-native beyond-P(k) statistics: voids, kNN-CDFs, profiles, pairs.

Round-5 closed the last single-device-only rows of the mesh-support
matrix (docs/parallelism.md): the SO void finder, kNN-CDFs, pair counts
and stacked profiles all run fully distributed — fields stay sharded
end to end, and only candidate lists / histograms reach the host.

Run on the hermetic 8-virtual-device CPU mesh (no GPU needed):

    JAX_PLATFORMS=cpu \
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python examples/pod_voids_knn.py

On GPUs, drop the env vars and size the mesh to the devices.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

try:
    # must run before ANY backend query (jax.default_backend would
    # initialize and freeze the device count)
    jax.config.update("jax_platforms", os.environ.get("RF_PLATFORM", "cpu"))
    jax.config.update("jax_num_cpu_devices", 8)
except RuntimeError:
    pass  # backend already up (e.g. a real pod): use what exists

import numpy as np

import randomfield_tpu as rf
from randomfield_tpu.parallel.mesh import make_mesh
from randomfield_tpu.validate.knn import random_knn_cdf
from randomfield_tpu.validate.paircount import pair_counts

N, SPACING = 64, 4.0
mesh = make_mesh(data=2, space=4)
g = rf.Generator(N, N, N, grid_spacing=SPACING, mesh=mesh)
delta = g.generate_delta_field(seed=11, apply_lightcone=False)
box = N * SPACING

# --- SO void catalog, fully distributed -----------------------------
radii = (8.0, 12.0, 16.0, 24.0)
pos, rv = g.find_voids(delta, radii, threshold=-0.3)
print(f"voids: {pos.shape[0]} non-overlapping; largest R_v = "
      f"{rv.max() if rv.size else 0:.1f} Mpc/h")

# --- kNN-CDFs of a Poisson tracer catalog ---------------------------
rng = np.random.RandomState(1)
counts = np.zeros((N, N, N), np.float32)
np.add.at(counts, tuple(rng.randint(0, N, size=(3, 2000))), 1.0)
r_knn = (6.0, 10.0, 16.0, 24.0)
cdf = g.calculate_knn_cdf(counts, r_knn, ks=(1, 2))
exact = random_knn_cdf(2000, (N, N, N), SPACING, r_knn, ks=(1, 2))
print("kNN CDF_1 (measured vs exact binomial):")
for j, r in enumerate(r_knn):
    print(f"  r = {r:5.1f}  {cdf[0, j]:.4f}  vs  {exact[0, j]:.4f}")

# --- stacked profile around deep troughs ----------------------------
d_host = np.asarray(delta)
w = (d_host < -1.5 * d_host.std()).astype(np.float32)
r_p, prof, _ = g.calculate_stacked_profile(delta, w, nbins=10)
print("trough profile (mean delta in shells):")
for i in range(0, len(r_p), 3):
    print(f"  r = {r_p[i]:6.1f}  <delta> = {prof[i]:+.3f}")

# --- pair counts of a catalog, row-sharded over all 8 devices -------
pos_t = rng.uniform(0, box, size=(3000, 3)).astype(np.float32)
edges = np.linspace(0, box / 4, 9)
dd = pair_counts(pos_t, box, edges, mesh=mesh)
print("pair counts (all-device row sharding):",
      np.array2string(dd["dd"].astype(int), max_line_width=70))
