"""Quickstart: one seeded realization + validation (config 1 workload).

Run: PYTHONPATH=.. python quickstart.py   (from examples/), or from the
repo root with PYTHONPATH=. — on GPU or CPU alike.
"""

import sys
import pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

import randomfield_tpu as rf

gen = rf.Generator(64, 64, 64, grid_spacing=4.0, verbose=True)
delta = gen.generate_delta_field(seed=42)

from randomfield_tpu.validate.stats import field_moments

mean, var = field_moments(delta)  # accumulation-safe device reduction
print(f"field: {delta.shape} {delta.dtype}")
print(f"mean = {mean:.2e}  (exactly 0 in expectation)")
print(f"var  = {var:.4f}  vs predicted {gen.predicted_variance():.4f}"
      f" (x <D^2> = {np.mean(gen.growth_function**2):.3f} for the lightcone)")

k, p_hat, n_modes = gen.calculate_power(delta, nbins=10)
print("\nrealized P(k) vs input table:")
from randomfield_tpu.ops.power import interpolate_power
import jax.numpy as jnp

for i in range(len(k)):
    if n_modes[i] > 0:
        p_true = float(interpolate_power(gen.power, jnp.float32(k[i])))
        print(f"  k={k[i]:.4f}  P^={p_hat[i]:10.1f}  P={p_true:10.1f} "
              f" ({n_modes[i]:5.0f} modes)")
