"""Constrained realizations and data-conditioned field reconstruction.

Part A — Hoffman-Ribak constraints: pin a smoothed peak and a void at
chosen comoving positions.  Every realization satisfies the constraints
EXACTLY (not just on average) while keeping the correct conditional
ensemble statistics elsewhere — the workhorse for "simulate a local
-universe-like region" initial conditions.

Part B — noisy-data conditioning: observe one realization through white
noise, reconstruct it with the Wiener filter, and draw exact posterior
samples whose scatter quantifies the reconstruction uncertainty.

Run:  PYTHONPATH=. python examples/constrained_field.py
(CPU: prefix JAX_PLATFORMS=cpu)
"""

import numpy as np

from randomfield_tpu import Generator

N, SPACING = 32, 8.0  # 256 Mpc/h box

# --- Part A: Hoffman-Ribak constrained realizations ------------------------
g = Generator(N, N, N, grid_spacing=SPACING)
constraints = [
    ((128.0, 128.0, 128.0), +3.0, 16.0),  # 3-sigma-ish peak, R = 16 Mpc/h
    ((48.0, 208.0, 64.0), -1.5, 24.0),    # broad void
]

print("constraint Gram matrix (inspect conditioning):")
print(np.array_str(g.constraint_matrix(constraints), precision=4))

for seed in (0, 1, 2):
    d = g.generate_constrained_field(seed, constraints)
    got = g.measure_constraints(d, constraints)
    print(f"  seed {seed}: measured constraints = {np.round(got, 4)} "
          f"(targets +3.0 / -1.5), field var {float(np.var(np.asarray(d))):.3f}")

mean = g.constrained_mean_field(constraints)
print(f"conditional mean field: constraints {np.round(g.measure_constraints(mean, constraints), 4)}, "
      f"|mean| max {float(np.abs(np.asarray(mean)).max()):.3f}")

# conditional variance at a probe point, predicted by augmenting the Gram
probe = (192.0, 64.0, 192.0)
aug = constraints + [(probe, 0.0, 0.0)]
xi = g.constraint_matrix(aug)
cc, cf = xi[:2, :2], xi[2, :2]
cond_var = xi[2, 2] - cf @ np.linalg.solve(cc, cf)
print(f"probe-point variance: unconditional {xi[2, 2]:.3f} -> "
      f"conditional {cond_var:.3f} (exact Gaussian formula)")

# --- Part B: Wiener filtering / posterior sampling -------------------------
truth = np.asarray(g.generate_delta_field(42, apply_lightcone=False))
noise_std = 0.6 * truth.std()
data = truth + np.random.RandomState(0).normal(scale=noise_std,
                                               size=truth.shape)
noise_power = noise_std**2 * SPACING**3  # white noise, physical units

rec = np.asarray(g.wiener_filter(data, noise_power))
mse_data = float(np.mean((data - truth) ** 2))
mse_rec = float(np.mean((rec - truth) ** 2))
print(f"wiener: data MSE {mse_data:.4f} -> reconstruction MSE {mse_rec:.4f} "
      f"(exact expectation {g.predicted_posterior_mse(noise_power):.4f})")

post = np.stack([
    np.asarray(g.generate_posterior_field(s, data, noise_power))
    for s in range(8)
])
print(f"posterior samples: mean-field residual rms "
      f"{float(np.sqrt(np.mean((post.mean(0) - rec) ** 2))):.4f}, "
      f"per-sample scatter rms {float(post.std(0).mean()):.4f}")
