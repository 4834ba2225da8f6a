"""Spatially sharded rendering (config 5 pattern).

On four GPUs this renders a 2048^3 field with slab decomposition
(chip_smoke.py --chips 4 checks it); here it runs the same program on
whatever devices exist (use JAX_PLATFORMS=cpu + jax_num_cpu_devices for a virtual
mesh).
"""

import sys
import pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import os

import jax

if os.environ.get("JAX_PLATFORMS", "") == "cpu":
    jax.config.update("jax_num_cpu_devices", 8)  # virtual mesh

import numpy as np

import randomfield_tpu as rf
from randomfield_tpu.parallel.mesh import make_mesh

n_dev = len(jax.devices())
space = max(d for d in (1, 2, 4, 8, 16) if n_dev % d == 0 and d <= n_dev)
mesh = make_mesh(data=n_dev // space, space=space)
print(f"mesh: {dict(mesh.shape)}")

# pick a grid that showcases sharding but fits anywhere
n = 128
gen = rf.Generator(n, n, n, grid_spacing=2.0, mesh=mesh)
field = gen.generate_delta_field(seed=0)
print(f"field {field.shape}, sharded as {field.sharding.spec}")
print(f"var = {float(field.var()):.4f} vs predicted "
      f"{gen.predicted_variance():.4f} x <D^2> = "
      f"{np.mean(gen.growth_function ** 2):.3f}")
