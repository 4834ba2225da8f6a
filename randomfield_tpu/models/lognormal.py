"""Lognormal random fields with a prescribed power spectrum.

The standard mock-catalog construction (Coles & Jones 1991): render a
Gaussian field g with a *transformed* spectrum P_G, then map

    delta_LN = exp(g - sigma_G^2 / 2) - 1,

which is mean-zero, bounded below by -1 (a physical density contrast),
and has the target two-point function.  The transformation runs in the
engine's own grid conventions (ops/transform.py):

    xi(r)   = (1/V) sum_k P(k) e^{ik.r}          (grid-exact target xi)
    xi_G    = ln(1 + xi)                          (Gaussianized)
    P_G(k)  = V * (1/N^3) sum_r xi_G(r) e^{-ik.r} (clipped at 0)

P_G is shell-averaged into a fine :class:`PowerTable` so the result
composes with the ENTIRE engine — every sampler (threefry / nested),
pipeline (fused / staged) and mesh (slab / pencil / multi-host) of
:class:`randomfield_tpu.engine.generator.Generator` works unchanged
underneath a :class:`LognormalGenerator`.  The shell-binned table is an
approximation to the (mildly anisotropic) grid P_G; the end-to-end
accuracy is gated statistically in tests/test_lognormal.py.

Reference parity note: the upstream package generates Gaussian fields
only; lognormal mocks are the canonical first consumer of such fields
and are included for workflow completeness (SURVEY.md section 0 scope,
"validation is statistical").

Lightcone: with ``apply_lightcone=True`` the Gaussian field arrives with
each z-plane scaled by D(z)/D(0) (engine convention), so the exp map
subtracts the per-plane variance D^2 sigma_G^2 / 2 — every plane is a
mean-zero lognormal field with local amplitude D(z) sigma_G.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from randomfield_tpu.ops import grid as _grid
from randomfield_tpu.ops import power as _power
from randomfield_tpu.ops import transform as _transform

__all__ = ["transformed_power", "gaussian_to_lognormal", "LognormalGenerator"]


def transformed_power(power, shape, spacing, nbins=256,
                      interpolation="log10k"):
    """Gaussianized power table P_G for a target ``power`` on this grid.

    Returns ``(table, info)``: a :class:`PowerTable` covering the grid's
    full [k_min, k_max] band (edge bins are clamp-extended so
    ``require_coverage`` passes), and an info dict with the Gaussian
    grid variance ``sigma_g2``, the target grid variance ``sigma2``, and
    ``clipped_fraction`` — the fraction of |P_G| mass removed by the
    non-negativity clip (0 for any spectrum whose xi_G transform is
    realizable; large values mean the target is not lognormal-
    representable on this grid).
    """
    shape = tuple(int(s) for s in shape)
    spacing = float(spacing)
    table = _power.validate_power(power)
    _power.require_coverage(table, shape, spacing)
    volume = shape[0] * shape[1] * shape[2] * spacing**3

    kmag = _grid.kmag(shape, spacing, jnp.float32)
    pgrid = _power.interpolate_power(table, kmag, interpolation)
    pgrid = jnp.where(kmag > 0, pgrid, 0.0)

    # complex values live INSIDE one jitted program
    @jax.jit
    def _xi_of(p):
        c = (p / jnp.asarray(volume, jnp.float32)).astype(jnp.complex64)
        return _transform.irfftn(c, shape)

    xi = np.asarray(_xi_of(pgrid), np.float64)
    if xi.min() <= -1.0:
        raise ValueError(
            f"target xi reaches {xi.min():.4f} <= -1 on this grid; the "
            "field has no lognormal representation (reduce the power "
            "amplitude or refine the grid)"
        )
    xi_g = np.log1p(xi)

    @jax.jit
    def _pg_of(x):  # keep the complex spectrum inside the program too
        return _transform.rfftn(x, norm="forward").real

    pg = np.asarray(
        _pg_of(jnp.asarray(xi_g, jnp.float32)), np.float64
    ) * volume
    neg = -pg[pg < 0].sum()
    total = np.abs(pg).sum()
    pg = np.maximum(pg, 0.0)

    # shell-average into a fine log-k table (mode-count weighted)
    km = np.asarray(kmag, np.float64)
    nz = shape[2]
    mult = np.full(shape[2] // 2 + 1, 2.0)
    mult[0] = 1.0
    if nz % 2 == 0:
        mult[-1] = 1.0
    w = np.broadcast_to(mult[None, None, :], km.shape)
    kmin, kmax = _grid.get_k_bounds(shape, spacing)
    edges = np.logspace(np.log10(kmin * 0.999), np.log10(kmax * 1.001),
                        int(nbins) + 1)
    idx = np.searchsorted(edges, km) - 1
    valid = (idx >= 0) & (idx < int(nbins)) & (km > 0)
    cnt = np.bincount(idx[valid], weights=w[valid], minlength=int(nbins))
    ksum = np.bincount(idx[valid], weights=(w * km)[valid], minlength=int(nbins))
    psum = np.bincount(idx[valid], weights=(w * pg)[valid], minlength=int(nbins))
    occ = cnt > 0
    k_tab = ksum[occ] / cnt[occ]
    p_tab = psum[occ] / cnt[occ]
    # clamp-extend so the table covers the exact grid band
    k_tab = np.concatenate([[kmin * 0.99], k_tab, [kmax * 1.01]])
    p_tab = np.concatenate([[p_tab[0]], p_tab, [p_tab[-1]]])
    info = {
        "sigma2": float((np.asarray(pgrid, np.float64) * w).sum() / volume),
        "sigma_g2": float(xi_g[0, 0, 0]),
        "clipped_fraction": float(neg / total) if total > 0 else 0.0,
    }
    return _power.PowerTable(k_tab, p_tab), info


@jax.jit
def _exp_map(g, plane_var, bias):
    b = jnp.asarray(bias, g.dtype)
    return jnp.expm1(b * g - 0.5 * plane_var[None, None, :].astype(g.dtype))


def gaussian_to_lognormal(g, sigma_g2, lightcone_weights=None, bias=1.0):
    """exp-map a Gaussian field: ``exp(b g - b^2 var/2) - 1`` (jitted).

    ``sigma_g2`` is the Gaussian field's variance; with
    ``lightcone_weights`` (the per-plane D(z)/D(0) already multiplied
    into ``g``) the subtracted variance is per-plane ``D^2 sigma_g2``.
    ``bias`` scales the Gaussian field before the map (deterministic
    lognormal bias model): the result stays exactly mean-zero and its
    two-point function is ``exp(b^2 xi_G) - 1``.
    """
    g = jnp.asarray(g)
    nz = g.shape[-1]
    w = np.ones(nz) if lightcone_weights is None else np.asarray(lightcone_weights, np.float64)
    b = float(bias)
    return _exp_map(g, jnp.asarray(b * b * w**2 * float(sigma_g2)), b)


class LognormalGenerator:
    """Generate lognormal density fields with a target P(k).

    A thin composition: a :class:`Generator` renders Gaussian fields
    with the transformed spectrum (so every engine feature — nested
    sampler, staged pipeline, slab/pencil meshes, batching — is
    available via ``**kwargs``), and the exp map runs as one fused
    elementwise device program on top.

    ``generate_delta_field(seed)`` returns a mean-zero field bounded
    below by -1 whose measured P(k) matches ``power``; one-point
    statistics are lognormal (``log1p(delta) + sigma_G^2/2`` per plane
    is Gaussian).
    """

    def __init__(self, nx, ny, nz, grid_spacing, cosmology=None, power=None,
                 table_bins=256, **kwargs):
        from randomfield_tpu.engine.generator import Generator
        from randomfield_tpu.models.cosmology import create_cosmology
        from randomfield_tpu.models.powerspec import resolve_power

        cosmology = create_cosmology(cosmology)
        self.power = _power.validate_power(resolve_power(power, cosmology))
        shape = (int(nx), int(ny), int(nz))
        self.interpolation = kwargs.get("interpolation", "log10k")
        self.gaussian_power, self.transform_info = transformed_power(
            self.power, shape, float(grid_spacing), nbins=table_bins,
            interpolation=self.interpolation,
        )
        self.gaussian = Generator(
            nx, ny, nz, grid_spacing, cosmology=cosmology,
            power=self.gaussian_power, **kwargs,
        )
        # the variance actually rendered (table-interpolated, grid-exact)
        self.sigma_g2 = float(self.gaussian.predicted_variance())

    @property
    def scene(self):
        return self.gaussian.scene

    @property
    def cosmology(self):
        return self.gaussian.cosmology

    @property
    def growth_function(self):
        return self.gaussian.growth_function

    @property
    def redshifts(self):
        return self.gaussian.redshifts

    @property
    def pipeline(self):
        return self.gaussian.pipeline

    @property
    def sampler(self):
        return self.gaussian.sampler

    def generate_delta_field(self, seed=0, smoothing_length=0.0,
                             apply_lightcone=True):
        """One lognormal realization (cf. Generator.generate_delta_field).

        ``smoothing_length`` smooths the underlying GAUSSIAN field (its
        variance correction follows exactly); the lognormal field's
        spectrum then deviates from the smoothed target at second order.
        """
        g = self.gaussian.generate_delta_field(
            seed, smoothing_length=smoothing_length,
            apply_lightcone=apply_lightcone,
        )
        var = float(
            self.gaussian.predicted_variance(smoothing_length=smoothing_length)
        )
        w = self.growth_function if apply_lightcone else None
        return gaussian_to_lognormal(g, var, lightcone_weights=w)

    def generate_fixed_field(self, seed=0, smoothing_length=0.0,
                             apply_lightcone=True, flip=False):
        """Variance-suppressed lognormal mock ('fixed & paired').

        The underlying Gaussian field has |c_k| pinned to sigma(k)
        (Generator.generate_fixed_field); pairing ``flip=True`` gives a
        realization whose nonlinear statistics anti-correlate with the
        unflipped one — averaging a (fixed, paired) pair cancels the
        leading-order sample variance of lognormal ensemble statistics.
        The one-point distribution is lognormal only to the CLT accuracy
        of the fixed Gaussian field (exact in the many-mode limit).
        """
        g = self.gaussian.generate_fixed_field(
            seed, smoothing_length=smoothing_length,
            apply_lightcone=apply_lightcone, flip=flip,
        )
        var = float(
            self.gaussian.predicted_variance(smoothing_length=smoothing_length)
        )
        w = self.growth_function if apply_lightcone else None
        return gaussian_to_lognormal(g, var, lightcone_weights=w)

    def generate_delta_fields(self, seeds, smoothing_length=0.0,
                              apply_lightcone=True):
        """Batch of lognormal realizations (leading axis = seeds)."""
        g = self.gaussian.generate_delta_fields(
            seeds, smoothing_length=smoothing_length,
            apply_lightcone=apply_lightcone,
        )
        var = float(
            self.gaussian.predicted_variance(smoothing_length=smoothing_length)
        )
        w = self.growth_function if apply_lightcone else None
        return gaussian_to_lognormal(g, var, lightcone_weights=w)

    def generate_biased_field(self, seed=0, bias=1.0, smoothing_length=0.0,
                              apply_lightcone=True):
        """A biased lognormal tracer field from the SAME realization.

        ``delta_b = exp(b g - b^2 sigma_G^2 / 2) - 1`` with the seed's
        Gaussian field g — the deterministic lognormal bias model
        (Coles & Jones 1991 sec. 5): two-point function
        ``xi_b = exp(b^2 xi_G) - 1 ~ b^2 xi`` at linear order, and the
        cross-correlation with any other bias of the same seed is
        ``xi_b1,b2 = exp(b1 b2 xi_G) - 1`` (matter is ``bias=1``).
        ``bias=1.0`` is exactly :meth:`generate_delta_field`.  Exact
        per-bin spectrum expectations: :meth:`predicted_biased_power` +
        :func:`randomfield_tpu.validate.stats.calculate_cross_power`.
        """
        g = self.gaussian.generate_delta_field(
            seed, smoothing_length=smoothing_length,
            apply_lightcone=apply_lightcone,
        )
        var = float(
            self.gaussian.predicted_variance(smoothing_length=smoothing_length)
        )
        w = self.growth_function if apply_lightcone else None
        return gaussian_to_lognormal(g, var, lightcone_weights=w, bias=bias)

    def _xi_gaussian_grid(self, smoothing_length=0.0):
        """Exact grid correlation of the rendered Gaussian field (f64)."""
        shape = self.scene.shape
        spacing = self.scene.grid_spacing
        volume = shape[0] * shape[1] * shape[2] * spacing**3
        kmag = np.asarray(_grid.kmag(shape, spacing, jnp.float32), np.float64)
        pgrid = np.asarray(
            _power.interpolate_power(self.gaussian_power,
                                     jnp.asarray(kmag, jnp.float32),
                                     self.interpolation),
            np.float64,
        )
        pgrid = np.where(kmag > 0, pgrid, 0.0)
        if smoothing_length:
            pgrid = pgrid * np.exp(-(kmag * float(smoothing_length)) ** 2)
        return np.fft.irfftn(pgrid, s=shape, norm="forward") / volume

    def predicted_biased_power(self, bias=1.0, bias2=None, nbins=32,
                               smoothing_length=0.0):
        """Exact per-bin expectation of the biased tracer spectrum.

        Auto-spectrum of :meth:`generate_biased_field(bias=b) <generate_
        biased_field>` by default; with ``bias2`` the CROSS-spectrum of
        two tracers of the same seed (``bias2=1.0`` = tracer x matter),
        as measured by :func:`validate.stats.calculate_cross_power`.
        Snapshot statistics (``apply_lightcone=False`` fields); computed
        on this grid's discrete modes and binned with the estimator's
        own bins, so residuals are pure sample noise.
        """
        shape = self.scene.shape
        spacing = self.scene.grid_spacing
        volume = shape[0] * shape[1] * shape[2] * spacing**3
        from randomfield_tpu.validate import stats as _stats

        xi_g = self._xi_gaussian_grid(smoothing_length)
        b2 = float(bias) if bias2 is None else float(bias2)
        return self._xi_to_binned_power(np.expm1(float(bias) * b2 * xi_g),
                                        nbins)

    def _xi_to_binned_power(self, xi_t, nbins):
        """Bin the exact spectrum of a target grid correlation xi_t
        with the estimator's own bins (shared tail of the predicted_*
        expectations)."""
        shape = self.scene.shape
        spacing = self.scene.grid_spacing
        volume = shape[0] * shape[1] * shape[2] * spacing**3
        from randomfield_tpu.validate import stats as _stats

        pt = np.fft.rfftn(xi_t, norm="forward").real * volume
        pt[0, 0, 0] = 0.0  # the estimator masks the DC mode
        return _stats.bin_power_grid(
            jnp.asarray(pt, jnp.float32), shape, spacing, nbins=nbins
        )

    def predicted_variance(self, smoothing_length=0.0, bias=1.0):
        """Expected variance of the (snapshot, possibly biased) field:
        ``exp(b^2 sigma_G^2) - 1``."""
        var = float(
            self.gaussian.predicted_variance(smoothing_length=smoothing_length)
        )
        return float(np.expm1(float(bias) ** 2 * var))

    def calculate_power(self, delta, nbins=32):
        return self.gaussian.calculate_power(delta, nbins=nbins)
