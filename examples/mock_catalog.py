"""Mock galaxy catalogs two ways: lognormal tracers and Zel'dovich RSD.

Part A — lognormal mock: render a positive-definite lognormal density
field with the default linear P(k), Poisson-sample galaxies per cell,
and verify the catalog's shot-noise-subtracted P(k) matches the target.

Part B — Zel'dovich redshift-space mock: displace a uniform particle
grid by the displacement field (clustering comes from the mapping, so
there is no double counting), boost the line-of-sight component by the
growth rate f, and compare the monopole against Kaiser x linear P(k).

Run:  PYTHONPATH=. python examples/mock_catalog.py
(CPU: prefix JAX_PLATFORMS=cpu)
"""

import numpy as np

from randomfield_tpu import Generator
from randomfield_tpu.models.lognormal import LognormalGenerator
from randomfield_tpu.models import zeldovich as zl
from randomfield_tpu.ops.power import PowerTable, interpolate_power

N, SPACING = 64, 8.0          # 512 Mpc/h box
NBAR = 2e-3                   # galaxies per (Mpc/h)^3
VOLUME = (N * SPACING) ** 3

# --- Part A: lognormal galaxy mock --------------------------------------
ln = LognormalGenerator(N, N, N, grid_spacing=SPACING, verbose=True)
delta = ln.generate_delta_field(seed=42, apply_lightcone=False)
counts = zl.poisson_sample(delta, NBAR, SPACING, seed=42)
print(f"galaxies: {float(np.asarray(counts).sum()):.0f} "
      f"(target {NBAR * VOLUME:.0f})")

# galaxies live at cell centers: NGP painting is exact
q = zl.lagrangian_positions((N, N, N), SPACING)
k, p, nm = zl.catalog_power(q, SPACING, weights=counts, nbins=14,
                            window="ngp")
print(f"shot noise subtracted: {zl.shot_noise(np.asarray(counts), VOLUME):.1f}"
      " (Mpc/h)^3")
print("lognormal tracer P(k) vs target:")
for i in range(len(k)):
    if nm[i] > 200:
        plin = float(interpolate_power(ln.power, np.float32(k[i])))
        print(f"  k = {k[i]:7.4f}  P^ = {p[i]:10.1f}  "
              f"target = {plin:10.1f}  ({nm[i]:7.0f} modes)")

# --- Part B: Zel'dovich redshift-space mock ------------------------------
# low-amplitude spectrum so the Zel'dovich mapping stays linear
base = ln.power
table = PowerTable(base.k, 0.05 * base.Pk)
g = Generator(N, N, N, grid_spacing=SPACING, power=table)
f = float(g.cosmology.growth_rate(0.5))
psi = g.generate_displacement(seed=7)
pos = zl.zeldovich_positions(psi, SPACING, f=f)          # redshift space
k, ps, nm = zl.catalog_power(pos, SPACING, nbins=14, window="cic")
kaiser = 1.0 + 2.0 * f / 3.0 + f * f / 5.0
print(f"\nZel'dovich RSD monopole vs Kaiser x linear (f = {f:.3f}, "
      f"boost = {kaiser:.3f}):")
for i in range(len(k)):
    if nm[i] > 200 and k[i] < 0.5 * np.pi / SPACING:
        plin = float(interpolate_power(table, np.float32(k[i])))
        print(f"  k = {k[i]:7.4f}  P^_s = {ps[i]:9.2f}  "
              f"Kaiser*P_lin = {kaiser * plin:9.2f}  ({nm[i]:7.0f} modes)")
