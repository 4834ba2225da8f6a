"""Morphology, peaks and abundance: beyond two-point statistics.

Part A — Minkowski functionals: V0..V3 of a rendered field vs the
exact Tomita Gaussian closed forms evaluated with the band-limited
spectral moments of THIS grid (no free parameters).

Part B — peak statistics: lattice maxima binned by height vs the exact
BBKS differential peak density, then the stacked peak PROFILE vs the
BBKS angle-averaged height+curvature conditional mean.

Part C — halo mass function: dn/dlnM from the same sigma(R) machinery
(Press-Schechter / Sheth-Tormen / Tinker08), with the PS branch's mass
conservation shown numerically.

Run:  PYTHONPATH=. python examples/morphology.py
(CPU: prefix JAX_PLATFORMS=cpu)
"""

import numpy as np

from randomfield_tpu import Generator
from randomfield_tpu.models import massfunction as mf
from randomfield_tpu.validate import peaks as pk

N, SPACING, SMOOTH = 64, 4.0, 12.0  # 256 Mpc/h box, 12 Mpc/h smoothing

g = Generator(N, N, N, grid_spacing=SPACING)
delta = np.asarray(
    g.generate_delta_field(1, smoothing_length=SMOOTH,
                           apply_lightcone=False)
)

# --- Part A: Minkowski functionals ---------------------------------------
s0 = np.sqrt(g.predicted_variance(smoothing_length=SMOOTH))
nu, v0, v1, v2, v3 = g.calculate_minkowski(delta, nbins=13, sigma0=s0)
t0, t1, t2, t3 = g.predicted_minkowski(nu, smoothing_length=SMOOTH)
print("Minkowski functionals (measured / exact Gaussian):")
for i in range(0, len(nu), 3):
    print(f"  nu = {nu[i]:+5.2f}  v1 = {v1[i]:.3e} / {t1[i]:.3e}"
          f"   v3 = {v3[i]:+.3e} / {t3[i]:+.3e}")

# --- Part B: peaks and stacked peak profiles ------------------------------
nu_c, counts, total = g.calculate_peaks(delta, sigma0=s0)
_, exp_counts, exp_total = g.predicted_peaks(smoothing_length=SMOOTH)
print(f"\npeaks: {total} lattice maxima; BBKS expects {exp_total:.1f}")

r, prof, n_pk, nu_bar, x_bar = g.calculate_peak_profile(
    delta, nu_min=1.0, smoothing_length=SMOOTH, nbins=12
)
_, pred = g.predicted_peak_profile(nu_bar, x_bar,
                                   smoothing_length=SMOOTH, nbins=12)
print(f"stacked profile of {n_pk} peaks with nu >= 1 "
      f"(nu_bar = {nu_bar:.2f}, curvature x_bar = {x_bar:.2f}):")
for i in range(0, 8):
    print(f"  r = {r[i]:6.1f}  <delta> = {prof[i]:+.4f}  "
          f"(BBKS {pred[i]:+.4f})")

# --- Part C: halo mass function -------------------------------------------
m = np.logspace(12, 15, 7)
print("\nhalo mass function dn/dlnM [(Mpc/h)^-3], z = 0:")
print(f"  {'M [Msun/h]':>12} {'sigma(M)':>9} {'PS':>10} {'ST':>10} "
      f"{'Tinker08':>10}")
s, dn_ps = mf.mass_function(g.power, m, fit="ps")
_, dn_st = mf.mass_function(g.power, m, fit="st")
_, dn_tk = mf.mass_function(g.power, m, fit="tinker08")
for i in range(len(m)):
    print(f"  {m[i]:12.2e} {s[i]:9.3f} {dn_ps[i]:10.2e} "
          f"{dn_st[i]:10.2e} {dn_tk[i]:10.2e}")

# PS mass conservation over the covered range (the factor of 2)
rho = mf._rho_m_comoving("Planck13")
lnm = np.linspace(np.log(1e9), np.log(3e15), 300)
_, dn = mf.mass_function(g.power, np.exp(lnm), fit="ps")
frac = np.trapezoid(np.exp(lnm) * dn / rho, lnm)
import math

s_ends = mf.sigma_m(g.power, np.exp(lnm[[0, -1]]))
exact = (math.erf(mf.DELTA_C / s_ends[1] / np.sqrt(2))
         - math.erf(mf.DELTA_C / s_ends[0] / np.sqrt(2)))
print(f"\nPS mass fraction in [1e9, 3e15] Msun/h: {frac:.4f} "
      f"(exact {exact:.4f})")
