"""The full galaxy-survey mock chain, end to end:

    linear P(k)  ->  lognormal matter field  ->  biased halo catalog
    (mass function + PBS bias)  ->  HOD galaxies (centrals + NFW
    satellites)  ->  redshift space (Kaiser + Fingers of God)
    ->  measured P_0/P_2 vs theory (Kaiser x linear, halo model)

plus the continuum theory tools: halo-model nonlinear P(k) and the
FFTLog xi(r).

Run:  PYTHONPATH=. python examples/galaxy_survey.py
(CPU: prefix JAX_PLATFORMS=cpu)
"""

import numpy as np

from randomfield_tpu.models import massfunction as mf
from randomfield_tpu.models import zeldovich as zl
from randomfield_tpu.models.halomodel import halo_model_power
from randomfield_tpu.models.halos import HaloGenerator
from randomfield_tpu.models.hod import HODGenerator
from randomfield_tpu.ops import fftlog
from randomfield_tpu.ops.power import load_default_power

N, SPACING = 64, 8.0          # 512 Mpc/h box
power = load_default_power()

# --- halo abundance & bias (theory) --------------------------------------
m = np.geomspace(1e13, 1e15, 5)
_, dn = mf.mass_function(power, m, fit="st")
_, b = mf.halo_bias(power, m, fit="st")
print("M [Msun/h]   dn/dlnM [(Mpc/h)^-3]   b(M)")
for mi, di, bi in zip(m, dn, b):
    print(f"  {mi:9.2e}  {di:18.3e}  {bi:6.2f}")

# --- halo mock: abundance check ------------------------------------------
halos = HaloGenerator(N, N, N, grid_spacing=SPACING, mmin=1e13, mmax=1e15,
                      nbins_mass=3, fit="st")
pos, mass = halos.generate_halo_catalog(seed=7)
print(f"\nhalos drawn: {pos.shape[0]} "
      f"(expected {halos.expected_counts().sum():.0f}); "
      f"bin biases {np.round(halos.bias, 2)}")

# --- HOD galaxies in redshift space ---------------------------------------
gals = HODGenerator(N, N, N, grid_spacing=SPACING,
                    hod=dict(logmmin=13.0, sigma_logm=0.25,
                             logm0=13.0, logm1=14.0, alpha=1.0))
p_s, is_cen = gals.generate_galaxy_catalog(seed=7, rsd=True)
print(f"galaxies: {p_s.shape[0]} ({int(is_cen.sum())} centrals, "
      f"{int((~is_cen).sum())} satellites); "
      f"n_g = {gals.galaxy_density:.2e} (Mpc/h)^-3, b_g = "
      f"{gals.galaxy_bias:.2f}")

k, p_ell, nm = zl.catalog_power_multipoles(
    np.asarray(p_s, np.float32).T, SPACING, shape=(N, N, N), nbins=10,
    ells=(0, 2))
f = float(gals.cosmology.growth_rate(0.0))
beta = f / gals.galaxy_bias
kaiser0 = 1 + 2 * beta / 3 + beta**2 / 5
plin = np.interp(np.log10(k), np.log10(np.asarray(power.k)),
                 np.asarray(power.Pk))
print("\n  k       P0^s meas   Kaiser b^2 P_lin + shot")
expect = kaiser0 * gals.galaxy_bias**2 * plin + 1.0 / gals.galaxy_density
for i in np.where(nm > 8)[0][:4]:
    print(f"  {k[i]:.4f}  {p_ell[0][i]:10.0f}  {expect[i]:10.0f}")

# --- BAO reconstruction on an evolved mock --------------------------------
from randomfield_tpu.models import reconstruction as rc
from randomfield_tpu import Generator
from randomfield_tpu.validate import stats
import jax.numpy as jnp

g = Generator(N, N, N, grid_spacing=SPACING)
seed = 11
delta_lin = np.asarray(g.generate_delta_field(seed, apply_lightcone=False))
psi = jnp.stack([g.generate_displacement(seed, component=c)
                 for c in range(3)])
q = zl.lagrangian_positions((N, N, N), SPACING)
evolved, _ = zl.paint(q + psi, (N, N, N), SPACING, window="cic")
rec, _ = rc.reconstruct_field(evolved, SPACING, smoothing=10.0)


def cross_r(a, b, nbins=8):
    kk, pab, cc = stats.calculate_cross_power(np.asarray(a, np.float32),
                                              np.asarray(b, np.float32),
                                              SPACING, nbins=nbins)
    _, paa, _ = stats.calculate_power(np.asarray(a, np.float32), SPACING,
                                      nbins=nbins)
    _, pbb, _ = stats.calculate_power(np.asarray(b, np.float32), SPACING,
                                      nbins=nbins)
    return kk, pab / np.sqrt(np.maximum(paa * pbb, 1e-30)), cc


kk, r_ev, cc = cross_r(evolved, delta_lin)
_, r_rec, _ = cross_r(rec, delta_lin)
print("\nBAO reconstruction (cross-correlation with the initial field):")
for i in np.where(cc > 20)[0][2:6]:
    print(f"  k = {kk[i]:.3f}  r_evolved = {r_ev[i]:+.3f}  "
          f"r_reconstructed = {r_rec[i]:+.3f}")

# --- theory: halo-model nonlinear P(k), FFTLog xi(r) ----------------------
kk, pt, p1h, p2h = halo_model_power(power, fit="st")
i = np.searchsorted(kk, 0.25)
print(f"\nhalo model at k=0.25 h/Mpc: P_tot/P_lin = "
      f"{pt[i] / np.interp(np.log10(0.25), np.log10(np.asarray(power.k)), np.asarray(power.Pk)):.2f} "
      f"(1h fraction {p1h[i] / pt[i]:.2f})")
r, xi = fftlog.xi_from_power(power)
print(f"FFTLog xi(r): xi(10) = {np.interp(10.0, r, xi):.3f}, "
      f"xi(50) = {np.interp(50.0, r, xi):.4f} "
      f"(BAO bump near r ~ 100: xi(105) = {np.interp(105.0, r, xi):.5f})")
