"""Halo mock catalogs: abundance-and-clustering-consistent tracers.

Completes the mock-making chain (SURVEY.md section 0 — the reference
stops at the Gaussian field; mass functions and bias live in
models/massfunction.py): draw a halo population whose

* ABUNDANCE follows the mass function dn/dlnM (Press-Schechter /
  Sheth-Tormen / Tinker08), and whose
* CLUSTERING follows the linear halo bias b(M) (peak-background split
  / Tinker10) on top of ONE shared density realization, so halo-halo
  and halo-matter spectra have exact lognormal expectations.

Construction (per mass bin i, all in one jitted program):

    g(x)        one Gaussian field, transformed spectrum (lognormal)
    lam_i(x) =  n_i V_cell * exp(b_i g - b_i^2 sigma_G^2 / 2)
    N_i(x)   ~  Poisson(lam_i(x))

`exp` keeps the intensity positive for ANY bias (a linear 1 + b delta
model would need clipping, which biases both the mean and the
spectrum), E[lam_i] = n_i V_cell exactly, and the count overdensity
has expectation spectrum  exp(b_i^2 xi_G) - 1  -> b_i^2 P(k) at linear
order, plus 1/n_i shot noise — all three gated in tests/test_halos.py.

Design: the "catalog" is grid-shaped — an (nm, nx, ny, nz)
integer count cube from one compiled program (`lax.scan` over mass
bins bounds memory to one float grid), matching models/zeldovich.py's
grid-shaped catalogs.  Host-side compaction to a ragged
(positions, masses) list is the LAST step, off-device
(`counts_to_catalog`), because ragged output shapes cannot live under
jit.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from randomfield_tpu.models import massfunction as _mf
from randomfield_tpu.models.lognormal import LognormalGenerator

__all__ = ["HaloGenerator", "counts_to_catalog"]


class HaloGenerator:
    """Generate Poisson halo-count cubes with consistent n(M) and b(M).

    Parameters: grid as :class:`Generator`; ``mmin``/``mmax`` [Msun/h]
    bound the halo masses, split into ``nbins_mass`` log-uniform bins;
    ``fit`` selects the mass function ('ps' / 'st' / 'tinker08') with
    its companion bias ('ps' / 'st' / 'tinker10'); ``z`` is the
    snapshot redshift (sigma(M) grown by D(z), spectrum scaled by
    D(z)^2).  Engine kwargs (sampler=, pipeline=, mesh=) pass through
    to the underlying Gaussian :class:`Generator`.

    Per-bin number densities ``n_i`` integrate dn/dlnM over each bin
    (host float64, 64-point sub-grid); per-bin biases ``b_i`` are the
    number-weighted bin means of b(M).
    """

    def __init__(self, nx, ny, nz, grid_spacing, cosmology=None, power=None,
                 mmin=1e13, mmax=1e15, nbins_mass=4, fit="st", z=0.0,
                 **kwargs):
        from randomfield_tpu.models.cosmology import create_cosmology
        from randomfield_tpu.models.powerspec import (power_at_redshift,
                                                      resolve_power)

        if not (0 < float(mmin) < float(mmax)):
            raise ValueError("need 0 < mmin < mmax")
        self.fit = str(fit)
        bias_fit = {"ps": "ps", "st": "st", "tinker08": "tinker10"}.get(
            self.fit
        )
        if bias_fit is None:
            raise ValueError(f"unknown fit {self.fit!r}; "
                             "use 'ps', 'st' or 'tinker08'")
        self.z = float(z)
        cosmology = create_cosmology(cosmology)
        power = resolve_power(power, cosmology)
        if self.z:
            power = power_at_redshift(power, cosmology, self.z)

        # --- mass binning: n_i and number-weighted b_i (host f64) ---
        self.mass_edges = np.geomspace(float(mmin), float(mmax),
                                       int(nbins_mass) + 1)
        nsub = 64
        n_i, b_i, m_c = [], [], []
        for lo, hi in zip(self.mass_edges[:-1], self.mass_edges[1:]):
            msub = np.geomspace(lo, hi, nsub)
            lnm = np.log(msub)
            # z entered through the table rescale; sigma at z=0 of it
            _, dn = _mf.mass_function(power, msub, cosmology, z=0.0,
                                      fit=self.fit)
            _, b = _mf.halo_bias(power, msub, cosmology, z=0.0,
                                 fit=bias_fit)
            ni = np.trapezoid(dn, lnm)
            if ni <= 0:
                raise ValueError(
                    f"mass bin [{lo:.3g}, {hi:.3g}] Msun/h has zero "
                    "abundance for this power spectrum"
                )
            n_i.append(ni)
            b_i.append(np.trapezoid(dn * b, lnm) / ni)
            m_c.append(np.trapezoid(dn * msub, lnm) / ni)
        #: comoving number density per bin [(Mpc/h)^-3]
        self.nbar = np.asarray(n_i)
        #: number-weighted linear bias per bin
        self.bias = np.asarray(b_i)
        #: number-weighted mean mass per bin [Msun/h]
        self.mass_centers = np.asarray(m_c)

        self.lognormal = LognormalGenerator(
            nx, ny, nz, grid_spacing, cosmology=cosmology, power=power,
            **kwargs,
        )
        self._power = power
        self._cell_volume = float(grid_spacing) ** 3
        self._counts_fn = None

    # -- introspection ------------------------------------------------
    @property
    def scene(self):
        return self.lognormal.scene

    @property
    def cosmology(self):
        return self.lognormal.cosmology

    def halo_abundance(self):
        """(mean mass, nbar) per bin — the exact Poisson intensity."""
        return self.mass_centers, self.nbar

    def expected_counts(self):
        """Expected TOTAL halo count per bin in the box."""
        shape = self.scene.shape
        ncells = shape[0] * shape[1] * shape[2]
        return self.nbar * self._cell_volume * ncells

    def shot_noise(self):
        """Poisson shot-noise power 1/nbar per bin [(Mpc/h)^3]."""
        return 1.0 / self.nbar

    # -- rendering ----------------------------------------------------
    def _build_counts(self):
        lam0 = jnp.asarray(self.nbar * self._cell_volume, jnp.float32)
        bias = jnp.asarray(self.bias, jnp.float32)
        sigma_g2 = jnp.float32(self.lognormal.sigma_g2)

        def body(carry, lam_b):
            g, key = carry
            lam, b = lam_b
            key, sub = jax.random.split(key)
            intensity = lam * jnp.exp(b * g - 0.5 * b * b * sigma_g2)
            counts = jax.random.poisson(sub, intensity, dtype=jnp.int32)
            return (g, key), counts

        @jax.jit
        def fn(g, seed):
            key = jax.random.key(jnp.uint32(seed))
            key = jax.random.fold_in(key, jnp.uint32(0x48414C4F))  # 'HALO'
            _, counts = jax.lax.scan(body, (g, key), (lam0, bias))
            return counts

        return fn

    def generate_halo_counts(self, seed=0, smoothing_length=0.0):
        """One catalog realization as an (nm, nx, ny, nz) int32 cube.

        The same ``seed`` drives both the density field and the Poisson
        draws (independent Threefry streams), so a seed is one
        reproducible universe; all mass bins trace the SAME realization
        with their own bias.  ``smoothing_length`` smooths the
        underlying Gaussian field (halo-exclusion-scale regularization).
        """
        g = self.lognormal.gaussian.generate_delta_field(
            seed, smoothing_length=smoothing_length, apply_lightcone=False,
        )
        if self._counts_fn is None:
            self._counts_fn = self._build_counts()
        return self._counts_fn(g, int(seed) & 0xFFFFFFFF)

    def generate_halo_catalog(self, seed=0, smoothing_length=0.0):
        """One realization compacted to ``(positions, masses)`` on host.

        ``positions`` is (N, 3) float64 comoving Mpc/h (cell centers
        jittered uniformly within the cell); ``masses`` is (N,) Msun/h
        drawn from dn/dlnM restricted to each halo's mass bin by
        inverse-CDF.  N varies per seed (E[N] = ``expected_counts().
        sum()``) — ragged, hence host-side.
        """
        counts = self.generate_halo_counts(
            seed, smoothing_length=smoothing_length
        )
        return counts_to_catalog(
            np.asarray(counts), self.mass_edges,
            self.scene.grid_spacing, seed=seed, power=self._power,
            cosmology=self.cosmology, fit=self.fit,
        )

    # -- expectations -------------------------------------------------
    def predicted_halo_power(self, bin_index=0, bin_index2=None, nbins=32,
                             smoothing_length=0.0, shot_noise=True):
        """Exact per-bin expectation of the halo count-overdensity
        spectrum: the lognormal biased-tracer expectation for
        ``b_i`` (cross: ``b_i b_j``) plus (auto only) the ``1/n_i``
        Poisson shot noise.  Compare with
        ``validate.stats.calculate_power(counts/mean - 1)`` or
        ``calculate_cross_power`` for two bins of the same seed.
        """
        i = int(bin_index)
        j = i if bin_index2 is None else int(bin_index2)
        k, p, c = self.lognormal.predicted_biased_power(
            bias=float(self.bias[i]), bias2=float(self.bias[j]),
            nbins=nbins, smoothing_length=smoothing_length,
        )
        if shot_noise and i == j:
            p = p + 1.0 / float(self.nbar[i])
        return k, p, c

    def predicted_combined_power(self, nbins=32, smoothing_length=0.0,
                                 shot_noise=True):
        """Exact expectation of the COMBINED (all mass bins pooled)
        halo catalog's spectrum: the number-weighted bin-pair mixture
        ``sum_ij w_i w_j (exp(b_i b_j xi_G) - 1)`` (convex in b, so it
        exceeds the effective-bias square at small scales) plus the
        pooled ``1/sum n_i`` shot noise.  Matches
        ``zeldovich.catalog_power`` on `generate_halo_catalog` output.
        """
        xi_g = self.lognormal._xi_gaussian_grid(smoothing_length)
        w = self.nbar / self.nbar.sum()
        xi_t = np.zeros_like(xi_g)
        for i in range(w.size):
            for j in range(w.size):
                xi_t += w[i] * w[j] * np.expm1(
                    self.bias[i] * self.bias[j] * xi_g)
        k, p, c = self.lognormal._xi_to_binned_power(xi_t, nbins)
        if shot_noise:
            p = p + 1.0 / float(self.nbar.sum())
        return k, p, c

    def calculate_power(self, delta, nbins=32):
        return self.lognormal.calculate_power(delta, nbins=nbins)


def counts_to_catalog(counts, mass_edges, spacing, seed=0, power=None,
                      cosmology="Planck13", fit="st"):
    """Compact an (nm, nx, ny, nz) count cube into (positions, masses).

    Positions jitter uniformly within each cell (the count cube is the
    NGP painting of the catalog in expectation); masses are inverse-CDF
    draws from dn/dlnM restricted to the halo's bin (given ``power``;
    without it, log-uniform within the bin).  Host numpy, seeded — the
    ragged output cannot live under jit.
    """
    counts = np.asarray(counts)
    if counts.ndim != 4 or counts.shape[0] != len(mass_edges) - 1:
        raise ValueError("counts must be (nbins_mass, nx, ny, nz)")
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, 0x48414C4F])
    spacing = float(spacing)
    pos_list, mass_list = [], []
    for i in range(counts.shape[0]):
        ci = counts[i]
        idx = np.argwhere(ci > 0)
        if idx.size == 0:
            continue
        reps = ci[ci > 0]
        cells = np.repeat(idx, reps, axis=0).astype(np.float64)
        n = cells.shape[0]
        pos_list.append((cells + rng.random((n, 3))) * spacing)
        lo, hi = mass_edges[i], mass_edges[i + 1]
        if power is not None:
            msub = np.geomspace(lo, hi, 64)
            _, dn = _mf.mass_function(power, msub, cosmology, fit=fit)
            cdf = np.concatenate([[0.0], np.cumsum(
                0.5 * (dn[1:] + dn[:-1]) * np.diff(np.log(msub)))])
            cdf /= cdf[-1]
            mass_list.append(np.interp(rng.random(n), cdf, msub))
        else:
            mass_list.append(lo * (hi / lo) ** rng.random(n))
    if not pos_list:
        return (np.zeros((0, 3)), np.zeros((0,)))
    return np.concatenate(pos_list), np.concatenate(mass_list)
