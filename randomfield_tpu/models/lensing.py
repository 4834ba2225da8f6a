"""Weak gravitational lensing on lightcone renders.

The engine's default render IS a lightcone (each z-plane carries
D(z)/D(0), engine/generator.py), so integrating the density along the
line of sight with the lensing efficiency kernel gives the Born-level
convergence map directly:

    kappa(x, y) = (3/2) Om0 (H0/c)^2
                  * sum_planes  dchi (1 + z) f_K(chi) f_K(chi_s - chi)
                                / f_K(chi_s) * delta(x, y, plane)

with f_K the transverse comoving distance (models/cosmology.py:
transverse_comoving_distance) — curvature-correct for open/closed
models.  Shear follows from kappa in the flat-sky Fourier plane via the
Kaiser-Squires relation gamma_hat = (kx + i ky)^2 / k^2 kappa_hat.

Reference parity note: the reference survey flags a possible
``lensing.py`` module as unverified (SURVEY.md section 8 item 1); this
implementation follows the standard Born-approximation plane-sum used
by lensing quick-simulators, built on the engine's own background
cosmology, and is validated algebraically (unit-density field => exact
weight sum) and statistically (sigma_kappa grows with source redshift)
rather than against unavailable reference source.

Everything here is O(N^3) reduction + O(N^2) FFT work expressed in jnp,
so it runs jitted on device; the per-plane weights are tiny host f64
tables computed once per (cosmology, geometry, z_source).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from randomfield_tpu.models.cosmology import C_KM_S, create_cosmology
from randomfield_tpu.ops import transform as _transform

__all__ = [
    "lensing_efficiency",
    "convergence_map",
    "tomographic_convergence",
    "convergence_to_shear",
    "shear_to_eb",
    "shear_power_eb",
    "add_shape_noise",
    "shape_noise_power",
    "convergence_power",
    "convergence_cross_power",
    "convergence_correlation",
    "masked_convergence_power",
    "masked_shear_power_eb",
    "predicted_convergence_power",
    "predicted_convergence_cross_power",
    "predicted_convergence_correlation",
    "predicted_masked_convergence_power",
    "predicted_masked_shear_power_eb",
]


def lensing_efficiency(cosmology, nz, spacing, z_source, z0=0.0,
                       scaled_by_h=True):
    """Per-plane convergence weights w_i (host float64, shape (nz,)).

    ``kappa = sum_i w_i delta_i`` for a lightcone box whose plane ``i``
    sits at comoving distance ``chi(z0) + i * spacing``.  ``spacing`` in
    Mpc/h when ``scaled_by_h`` (the engine's convention), else Mpc.
    Planes at or beyond the source redshift get zero weight; ``z_source``
    must lie inside the tabulated background (z <= 100).
    """
    cosmology = create_cosmology(cosmology)
    from randomfield_tpu.models.cosmology import get_redshifts

    z = get_redshifts(cosmology, nz, spacing, scaled_by_h=scaled_by_h, z0=z0)
    dchi = float(spacing) / (cosmology.h if scaled_by_h else 1.0)  # Mpc
    chi = cosmology.comoving_distance(z)
    chi_s = float(cosmology.comoving_distance(float(z_source)))
    if chi_s <= 0.0:
        raise ValueError(f"z_source={z_source} puts the source at the observer")
    fk = cosmology.transverse_comoving_distance(z)
    # f_K(chi_s - chi) under curvature, via the sinh/sin addition on the
    # tabulated chi difference
    dh = cosmology.hubble_distance
    dchi_s = chi_s - chi
    if cosmology.Ok0 == 0.0:
        fk_rel = dchi_s
        fk_s = chi_s
    else:
        sq = np.sqrt(abs(cosmology.Ok0))
        x = sq * dchi_s / dh
        xs = sq * chi_s / dh
        if cosmology.Ok0 > 0:
            fk_rel, fk_s = dh / sq * np.sinh(x), dh / sq * np.sinh(xs)
        else:
            fk_rel, fk_s = dh / sq * np.sin(x), dh / sq * np.sin(xs)
    pref = 1.5 * cosmology.Om0 * (cosmology.H0 / C_KM_S) ** 2  # 1/Mpc^2
    w = pref * dchi * (1.0 + z) * fk * fk_rel / fk_s
    return np.where(chi < chi_s, w, 0.0)


def convergence_map(delta, cosmology, spacing, z_source, z0=0.0,
                    scaled_by_h=True):
    """Born-approximation convergence kappa(x, y) from a lightcone render.

    ``delta``: a (nx, ny, nz) field whose axis 2 is the line of sight —
    exactly what ``Generator.generate_delta_field`` returns (generate
    with the default ``apply_lightcone=True`` so the growth evolution is
    already in the planes).  Returns an (nx, ny) jnp map; the reduction
    is one device dot over the z axis.
    """
    delta = jnp.asarray(delta)
    nz = delta.shape[-1]
    w = lensing_efficiency(
        cosmology, nz, spacing, z_source, z0=z0, scaled_by_h=scaled_by_h
    )
    return jnp.matmul(delta, jnp.asarray(w, delta.dtype),
                      precision=jax.lax.Precision.HIGHEST)


def tomographic_convergence(delta, cosmology, spacing, z_sources, z0=0.0,
                            scaled_by_h=True):
    """Convergence maps for a stack of source planes: (nsrc, nx, ny).

    One device matmul ``delta @ W`` with the (nz, nsrc) efficiency
    matrix — the tomographic survey analog (each source redshift bin
    sees the same lightcone through its own kernel).  Cross-spectra of
    the returned maps with :func:`convergence_cross_power` probe the
    shared structure; exact expectations via
    :func:`predicted_convergence_cross_power`.
    """
    delta = jnp.asarray(delta)
    nz = delta.shape[-1]
    w = np.stack([
        lensing_efficiency(cosmology, nz, spacing, zs, z0=z0,
                           scaled_by_h=scaled_by_h)
        for zs in z_sources
    ], axis=1)
    kappa = jnp.matmul(delta, jnp.asarray(w, delta.dtype),
                       precision=jax.lax.Precision.HIGHEST)
    return jnp.moveaxis(kappa, -1, 0)


def convergence_to_shear(kappa, spacing):
    """Kaiser-Squires: flat-sky shear (gamma1, gamma2) from kappa.

    gamma_hat(k) = ((kx^2 - ky^2) + 2 i kx ky) / k^2 * kappa_hat(k),
    DC mode zero (the mass-sheet degeneracy) and the Nyquist lines of
    even axes zeroed (the spin-2 kernel is odd under Nyquist aliasing —
    see :func:`_eb_factors`; :func:`shear_to_eb` inverts this map
    exactly on the surviving modes).  Runs through the repo's
    transform helpers (complex arrays stay inside one jitted program).
    Returns two real (nx, ny) maps.
    """
    kappa = jnp.asarray(kappa)
    nx, ny = kappa.shape

    # route the 2-D transform through the repo's 3-D safe helpers with a
    # trailing singleton axis: the packed axis has length 1 (kz = 0
    # only), so the x and y axes carry FULL complex transforms — the
    # Kaiser-Squires factors are even under k -> -k, so Hermitian
    # symmetry survives and the inverse stays real.  One jitted program.
    @jax.jit
    def _ks(kp):
        fac1, fac2, ksq = _eb_factors(nx, ny, kp.dtype)
        c = _transform.rfftn(kp[:, :, None], norm="forward")[:, :, 0]
        g1h = jnp.where(ksq > 0, fac1 * c, 0.0)
        g2h = jnp.where(ksq > 0, fac2 * c, 0.0)
        g1 = _transform.irfftn(g1h[:, :, None], (nx, ny, 1),
                               norm="forward")[:, :, 0]
        g2 = _transform.irfftn(g2h[:, :, None], (nx, ny, 1),
                               norm="forward")[:, :, 0]
        return g1, g2

    return _ks(kappa)


def _eb_factors(nx, ny, dtype):
    """The Kaiser-Squires spin-2 rotation t1 + i t2 = e^{2 i phi_k}:
    t1 = (kx^2 - ky^2)/k^2, t2 = 2 kx ky / k^2, zeroed on the Nyquist
    lines of even axes — t2 is ODD under the Nyquist aliasing
    k_Nyq == -k_Nyq, so a nonzero kernel there breaks Hermitian symmetry
    and the inverse transform would silently project it out anyway (the
    same convention as the off-diagonal tidal kernels,
    ops/derived.py).  Spin-2 maps are therefore band-limited below the
    axis Nyquist by construction, which is what makes
    :func:`shear_to_eb` an exact inverse of
    :func:`convergence_to_shear` mode by mode."""
    kx = jnp.fft.fftfreq(nx, d=1.0 / nx).astype(dtype)
    ky = jnp.fft.fftfreq(ny, d=1.0 / ny).astype(dtype)
    kx2 = (kx * kx)[:, None]
    ky2 = (ky * ky)[None, :]
    ksq = kx2 + ky2
    denom = jnp.where(ksq > 0, ksq, 1.0)
    ok = jnp.ones((nx, ny), dtype)
    if nx % 2 == 0:
        ok = ok * (jnp.abs(kx) != nx // 2).astype(dtype)[:, None]
    if ny % 2 == 0:
        ok = ok * (jnp.abs(ky) != ny // 2).astype(dtype)[None, :]
    t1 = (kx2 - ky2) / denom * ok
    t2 = 2.0 * kx[:, None] * ky[None, :] / denom * ok
    return t1, t2, ksq


def shear_to_eb(gamma1, gamma2, spacing):
    """E/B decomposition of a flat-sky shear field (inverse KS).

    ``E_hat = t1 g1_hat + t2 g2_hat``, ``B_hat = t1 g2_hat - t2 g1_hat``
    with ``t1 + i t2 = e^{2 i phi_k}`` — the exact inverse of
    :func:`convergence_to_shear` on the same grid: gravitational (pure
    KS) shear returns ``E = kappa - <kappa>`` to roundoff and ``B = 0``
    identically; any measured B is a systematics/noise channel (the
    standard lensing null test).  The DC mode of both outputs is zero
    (mass-sheet degeneracy).  Returns two real maps ``(e, b)``.
    """
    g1 = jnp.asarray(gamma1)
    g2 = jnp.asarray(gamma2)
    if g1.shape != g2.shape or g1.ndim != 2:
        raise ValueError("gamma1/gamma2 must be equal-shape 2-D maps")
    nx, ny = g1.shape

    @jax.jit
    def _inv(a, b):
        t1, t2, ksq = _eb_factors(nx, ny, a.dtype)
        c1 = _transform.rfftn(a[:, :, None], norm="forward")[:, :, 0]
        c2 = _transform.rfftn(b[:, :, None], norm="forward")[:, :, 0]
        eh = jnp.where(ksq > 0, t1 * c1 + t2 * c2, 0.0)
        bh = jnp.where(ksq > 0, t1 * c2 - t2 * c1, 0.0)
        e = _transform.irfftn(eh[:, :, None], (nx, ny, 1),
                              norm="forward")[:, :, 0]
        bb = _transform.irfftn(bh[:, :, None], (nx, ny, 1),
                               norm="forward")[:, :, 0]
        return e, bb

    return _inv(g1, g2)


def shear_power_eb(gamma1, gamma2, spacing, nbins=16):
    """E- and B-mode power spectra of a shear field.

    Binned exactly like :func:`convergence_power` (same modes, bins and
    conventions), so for noise-free KS shear ``P_E`` equals
    ``convergence_power(kappa)`` bin for bin and ``P_B`` vanishes; with
    white shape noise both acquire the flat :func:`shape_noise_power`
    floor (the per-component noise splits evenly between E and B).
    Returns ``(k_mean, p_e, p_b, n_modes)``.
    """
    g1 = jnp.asarray(gamma1)
    g2 = jnp.asarray(gamma2)
    if g1.shape != g2.shape or g1.ndim != 2:
        raise ValueError("gamma1/gamma2 must be equal-shape 2-D maps")
    nx, ny = g1.shape
    spacing = float(spacing)
    area = nx * ny * spacing**2

    @jax.jit
    def _mode_p(a, b):  # complex spectra stay inside the program
        t1, t2, ksq = _eb_factors(nx, ny, a.dtype)
        c1 = _transform.rfftn(a[:, :, None], norm="backward")[:, :, 0]
        c2 = _transform.rfftn(b[:, :, None], norm="backward")[:, :, 0]
        eh = jnp.where(ksq > 0, t1 * c1 + t2 * c2, 0.0)
        bh = jnp.where(ksq > 0, t1 * c2 - t2 * c1, 0.0)
        scale = (spacing**2) ** 2 / area
        return (
            (eh.real**2 + eh.imag**2) * scale,
            (bh.real**2 + bh.imag**2) * scale,
        )

    pe, pb = _mode_p(g1, g2)
    pe = np.asarray(pe, np.float64)
    pb = np.asarray(pb, np.float64)
    km, edges, mult = _kperp_setup((nx, ny), spacing, nbins)
    k_mean, p_e, counts = _bin2d(km, mult, pe, edges, int(nbins))
    _, p_b, _ = _bin2d(km, mult, pb, edges, int(nbins))
    return k_mean, p_e, p_b, counts


def add_shape_noise(gamma1, gamma2, sigma_e, seed=0):
    """Add white per-component shape noise to shear maps.

    ``sigma_e`` is the per-pixel, per-component intrinsic-ellipticity
    dispersion (for a survey with n_gal galaxies per pixel and
    per-galaxy dispersion sigma_gal per component, pass
    ``sigma_gal / sqrt(n_gal)``).  Deterministic in ``seed``; the two
    components get independent draws.  Expected E/B power contribution:
    :func:`shape_noise_power`.
    """
    g1 = jnp.asarray(gamma1)
    g2 = jnp.asarray(gamma2)
    key = jax.random.key(int(seed) ^ 0x5EAB0DE5)
    k1, k2 = jax.random.split(key)
    s = jnp.asarray(float(sigma_e), g1.dtype)
    return (
        g1 + s * jax.random.normal(k1, g1.shape, g1.dtype),
        g2 + s * jax.random.normal(k2, g2.shape, g2.dtype),
    )


def shape_noise_power(sigma_e, spacing):
    """Flat noise power of white per-pixel shape noise in the map
    conventions of :func:`shear_power_eb` / :func:`convergence_power`:
    ``P_N = sigma_e^2 spacing^2`` per component — each of E and B
    receives exactly this floor (the spin-2 rotation is unitary per
    mode)."""
    return float(sigma_e) ** 2 * float(spacing) ** 2


def _kperp_setup(shape2d, spacing, nbins):
    """2-D k geometry + log bins over the FULL (kx, ky) mode plane.

    The map transform routes through the 3-D packed helpers with a
    trailing singleton axis (kz = 0 only), so both transverse axes carry
    full complex transforms: every mode appears once with its conjugate
    partner also present — unit multiplicity, and mode counts match the
    3-D estimator's full-spectrum convention.
    """
    nx, ny = shape2d
    kx = 2.0 * np.pi * np.fft.fftfreq(nx, d=spacing)
    ky = 2.0 * np.pi * np.fft.fftfreq(ny, d=spacing)
    km = np.sqrt(kx[:, None] ** 2 + ky[None, :] ** 2)
    kmin = 2.0 * np.pi / (max(nx, ny) * spacing)
    edges = np.logspace(np.log10(kmin * 0.999), np.log10(km.max() * 1.001),
                        int(nbins) + 1)
    return km, edges, np.ones_like(km)


def _bin2d(km, w, p, edges, nbins):
    """Host-side binning of a small 2-D mode grid (validation scale)."""
    idx = np.searchsorted(edges, km) - 1
    valid = (idx >= 0) & (idx < nbins) & (km > 0)
    counts = np.bincount(idx[valid], weights=w[valid], minlength=nbins)
    psum = np.bincount(idx[valid], weights=(w * p)[valid], minlength=nbins)
    ksum = np.bincount(idx[valid], weights=(w * km)[valid], minlength=nbins)
    with np.errstate(invalid="ignore", divide="ignore"):
        return ksum / counts, psum / counts, counts


def convergence_power(kappa, spacing, nbins=16):
    """Transverse power spectrum P_kappa(k_perp) of a convergence map.

    Flat-sky 2-D analog of validate/stats.py ``calculate_power`` in the
    engine's comoving conventions: ``P = <|c(k_perp)|^2> / A`` with
    ``c = spacing^2 sum kappa e^{-i k.x}`` and k_perp in h/Mpc (convert
    to multipoles with ``ell = k_perp * f_K(chi)`` at a chosen
    distance).  Returns ``(k_mean, p_hat, n_modes)`` numpy arrays; the
    exact expectation on the same grid and bins is
    :func:`predicted_convergence_power`.
    """
    # analysis convention c = a^2 sum kappa e^{-ik.x} (norm='backward'
    # is the raw sum, matching ops/transform.py field_to_spectrum);
    # shares the jitted cross program so complex spectra never
    # materialize eagerly
    return convergence_cross_power(kappa, kappa, spacing, nbins=nbins)


def convergence_cross_power(kappa1, kappa2, spacing, nbins=16):
    """Cross power spectrum of two convergence maps (e.g. two
    tomographic bins of the same render): ``Re <c1 c2*> / A`` binned
    like :func:`convergence_power` (which is the ``kappa1 is kappa2``
    special case).  Exact expectation:
    :func:`predicted_convergence_cross_power`."""
    kappa1 = jnp.asarray(kappa1)
    kappa2 = jnp.asarray(kappa2)
    if kappa1.shape != kappa2.shape:
        raise ValueError("maps must share a shape")
    nx, ny = kappa1.shape
    spacing = float(spacing)
    area = nx * ny * spacing**2

    @jax.jit
    def _mode_p(a, b):  # complex spectra stay inside the program
        ca = _transform.rfftn(a[:, :, None], norm="backward")[:, :, 0]
        cb = _transform.rfftn(b[:, :, None], norm="backward")[:, :, 0]
        return (ca.real * cb.real + ca.imag * cb.imag) \
            * (spacing**2) ** 2 / area

    p = np.asarray(_mode_p(kappa1, kappa2), np.float64)
    km, edges, mult = _kperp_setup((nx, ny), spacing, nbins)
    return _bin2d(km, mult, p, edges, int(nbins))


def predicted_convergence_cross_power(power, shape, spacing, weights1,
                                      weights2, nbins=16,
                                      interpolation="log10k"):
    """Exact expectation of :func:`convergence_cross_power` for two
    plane sums over the SAME box: the window in
    :func:`predicted_convergence_power` generalizes to
    ``Re[W1(kz) W2*(kz)]``.  Pass each bin's
    ``lensing_efficiency * growth_function`` product."""
    from randomfield_tpu.ops import power as _power

    nx, ny, nz = (int(s) for s in shape)
    spacing = float(spacing)
    table = _power.validate_power(power)
    _power.require_coverage(table, (nx, ny, nz), spacing)
    w1 = np.asarray(weights1, np.float64)
    w2 = np.asarray(weights2, np.float64)
    if w1.shape != (nz,) or w2.shape != (nz,):
        raise ValueError(f"weights must have shape ({nz},)")
    km2, edges, mult = _kperp_setup((nx, ny), spacing, nbins)
    kz = 2.0 * np.pi * np.fft.fftfreq(nz, d=spacing)
    kmag3 = np.sqrt(km2[:, :, None] ** 2 + kz[None, None, :] ** 2)
    p3 = np.asarray(
        _power.interpolate_power(
            table, jnp.asarray(kmag3, jnp.float32), interpolation
        ),
        np.float64,
    )
    p3[kmag3 == 0] = 0.0
    win = np.real(np.fft.fft(w1) * np.conj(np.fft.fft(w2)))
    p_kappa = (p3 * win[None, None, :]).sum(axis=-1) / (nz * spacing)
    return _bin2d(km2, mult, p_kappa, edges, int(nbins))


def predicted_convergence_power(power, shape, spacing, weights, nbins=16,
                                interpolation="log10k"):
    """Exact expectation of :func:`convergence_power` for a plane sum.

    For ``kappa = sum_i w_i delta(x, y, plane_i)`` over a periodic
    Gaussian box with 3-D spectrum P, the discrete expectation is

        P_kappa(k_perp) = (1/L_z) sum_kz P(|(k_perp, kz)|) |W(kz)|^2,
        W(kz) = sum_i w_i e^{-i kz z_i},

    evaluated on THIS grid's modes and binned identically — no Limber
    approximation, so measured-vs-predicted residuals are pure sample
    noise.  ``weights`` must include everything multiplying the raw
    Gaussian planes: for the engine's lightcone renders pass
    ``lensing_efficiency(...) * generator.growth_function``.
    """
    from randomfield_tpu.ops import power as _power

    nx, ny, nz = (int(s) for s in shape)
    spacing = float(spacing)
    table = _power.validate_power(power)
    _power.require_coverage(table, (nx, ny, nz), spacing)
    w = np.asarray(weights, np.float64)
    if w.shape != (nz,):
        raise ValueError(f"weights must have shape ({nz},), got {w.shape}")
    km2, edges, mult = _kperp_setup((nx, ny), spacing, nbins)
    kz = 2.0 * np.pi * np.fft.fftfreq(nz, d=spacing)
    kmag3 = np.sqrt(km2[:, :, None] ** 2 + kz[None, None, :] ** 2)
    p3 = np.asarray(
        _power.interpolate_power(
            table, jnp.asarray(kmag3, jnp.float32), interpolation
        ),
        np.float64,
    )
    p3[kmag3 == 0] = 0.0
    win = np.abs(np.fft.fft(w)) ** 2  # |sum_i w_i e^{-i kz z_i}|^2
    p_kappa = (p3 * win[None, None, :]).sum(axis=-1) / (nz * spacing)
    return _bin2d(km2, mult, p_kappa, edges, int(nbins))


def masked_convergence_power(kappa, mask, spacing, nbins=16):
    """Binned pseudo-spectrum of a survey-masked convergence map.

    Flat-sky analog of ``validate.stats.calculate_masked_power``:
    the plain :func:`convergence_power` of ``mask * kappa`` normalized
    by ``<mask^2>`` — footprints, point-source holes, apodized edges.
    Its expectation is the mode-coupled
    :func:`predicted_masked_convergence_power` (same bins exactly);
    ``mask=1`` reduces to :func:`convergence_power` identically.
    Returns ``(k_mean, p_hat, n_modes)``.
    """
    kappa = jnp.asarray(kappa)
    w = np.asarray(mask, np.float64)
    if w.shape != tuple(kappa.shape):
        raise ValueError(f"mask shape {w.shape} != map shape "
                         f"{tuple(kappa.shape)}")
    w2 = float(np.mean(w**2))
    if w2 <= 0:
        raise ValueError("mask is identically zero")
    k, p, nm = convergence_power(
        kappa * jnp.asarray(w, kappa.dtype), spacing, nbins=nbins)
    return k, p / w2, nm


def predicted_masked_convergence_power(power, mask, shape, spacing,
                                       weights, nbins=16,
                                       interpolation="log10k"):
    """EXACT expectation of :func:`masked_convergence_power`.

    The masked map's per-mode power is the unmasked per-mode
    expectation ``P_kappa(l')`` (the plane-sum kz window of
    :func:`predicted_convergence_power`, transverse DC included — the
    mask couples it into l > 0) convolved with the mask's 2-D power:

        E[P_m(l)] = sum_{l'} |m_hat(l - l')|^2 P_kappa(l')
                    / (Npix^2 <mask^2>),

    evaluated exactly as one 2-D FFT cycle and binned with the
    estimator's own bins — measured-vs-predicted residuals are pure
    sample noise (flat-sky pseudo-C_ell with the exact lattice
    mode-coupling matrix).  Host float64, validation scale.
    """
    from randomfield_tpu.ops import power as _power

    nx, ny, nz = (int(s) for s in shape)
    spacing = float(spacing)
    w_mask = np.asarray(mask, np.float64)
    if w_mask.shape != (nx, ny):
        raise ValueError(f"mask must be ({nx}, {ny}), got {w_mask.shape}")
    w2 = float(np.mean(w_mask**2))
    if w2 <= 0:
        raise ValueError("mask is identically zero")
    table = _power.validate_power(power)
    _power.require_coverage(table, (nx, ny, nz), spacing)
    w = np.asarray(weights, np.float64)
    if w.shape != (nz,):
        raise ValueError(f"weights must have shape ({nz},)")
    km2, edges, mult = _kperp_setup((nx, ny), spacing, nbins)
    kz = 2.0 * np.pi * np.fft.fftfreq(nz, d=spacing)
    kmag3 = np.sqrt(km2[:, :, None] ** 2 + kz[None, None, :] ** 2)
    p3 = np.asarray(
        _power.interpolate_power(
            table, jnp.asarray(kmag3, jnp.float32), interpolation
        ),
        np.float64,
    )
    p3[kmag3 == 0] = 0.0  # only the 3-D DC: kappa's transverse DC stays
    win = np.abs(np.fft.fft(w)) ** 2
    p_kappa = (p3 * win[None, None, :]).sum(axis=-1) / (nz * spacing)
    m_hat2 = np.abs(np.fft.fft2(w_mask)) ** 2
    npix = nx * ny
    # circular convolution sum_{l'} m_hat2(l - l') p_kappa(l') via FFTs
    conv = np.real(np.fft.fft2(
        np.fft.ifft2(m_hat2) * np.fft.ifft2(p_kappa))) * npix
    p_masked = conv / (npix**2 * w2)
    return _bin2d(km2, mult, p_masked, edges, int(nbins))


def masked_shear_power_eb(gamma1, gamma2, mask, spacing, nbins=16):
    """E/B pseudo-spectra of survey-masked shear maps.

    :func:`shear_power_eb` of ``(mask gamma1, mask gamma2)`` normalized
    by ``<mask^2>`` — the flat-sky pseudo-C_ell shear estimator.  The
    mask mixes E into B (the classic leakage null-test contaminant);
    both expectations, leakage included, are exact in
    :func:`predicted_masked_shear_power_eb` (same bins).  ``mask=1``
    reduces to :func:`shear_power_eb` identically.  Returns
    ``(k_mean, p_e, p_b, n_modes)``.
    """
    g1 = jnp.asarray(gamma1)
    g2 = jnp.asarray(gamma2)
    w = np.asarray(mask, np.float64)
    if w.shape != tuple(g1.shape):
        raise ValueError(f"mask shape {w.shape} != map shape "
                         f"{tuple(g1.shape)}")
    w2 = float(np.mean(w**2))
    if w2 <= 0:
        raise ValueError("mask is identically zero")
    wj = jnp.asarray(w, g1.dtype)
    k, pe, pb, nm = shear_power_eb(g1 * wj, g2 * wj, spacing, nbins=nbins)
    return k, pe / w2, pb / w2, nm


def _p_kappa_grid(power, shape, spacing, weights, interpolation):
    """Per-mode E[|kappa_hat|^2]-convention grid (full 2-D fft layout),
    shared by the masked predictions; transverse DC included."""
    from randomfield_tpu.ops import power as _power

    nx, ny, nz = (int(s) for s in shape)
    table = _power.validate_power(power)
    _power.require_coverage(table, (nx, ny, nz), spacing)
    w = np.asarray(weights, np.float64)
    if w.shape != (nz,):
        raise ValueError(f"weights must have shape ({nz},)")
    kx = 2.0 * np.pi * np.fft.fftfreq(nx, d=spacing)
    ky = 2.0 * np.pi * np.fft.fftfreq(ny, d=spacing)
    km2 = np.sqrt(kx[:, None] ** 2 + ky[None, :] ** 2)
    kz = 2.0 * np.pi * np.fft.fftfreq(nz, d=spacing)
    kmag3 = np.sqrt(km2[:, :, None] ** 2 + kz[None, None, :] ** 2)
    p3 = np.asarray(
        _power.interpolate_power(
            table, jnp.asarray(kmag3, jnp.float32), interpolation
        ),
        np.float64,
    )
    p3[kmag3 == 0] = 0.0
    win = np.abs(np.fft.fft(w)) ** 2
    return (p3 * win[None, None, :]).sum(axis=-1) / (nz * spacing)


def _conv2d(m_hat2, grid):
    """Circular convolution sum_{l'} m_hat2(l - l') grid(l') via FFTs."""
    npix = grid.size
    return np.real(np.fft.fft2(
        np.fft.ifft2(m_hat2) * np.fft.ifft2(grid))) * npix


def _eb_factors_np(nx, ny):
    """float64 numpy twin of :func:`_eb_factors` (same zeroing)."""
    kx = np.fft.fftfreq(nx, d=1.0 / nx)
    ky = np.fft.fftfreq(ny, d=1.0 / ny)
    kx2 = (kx * kx)[:, None]
    ky2 = (ky * ky)[None, :]
    ksq = kx2 + ky2
    denom = np.where(ksq > 0, ksq, 1.0)
    ok = np.ones((nx, ny))
    if nx % 2 == 0:
        ok *= (np.abs(kx) != nx // 2)[:, None]
    if ny % 2 == 0:
        ok *= (np.abs(ky) != ny // 2)[None, :]
    t1 = (kx2 - ky2) / denom * ok
    t2 = 2.0 * kx[:, None] * ky[None, :] / denom * ok
    return t1, t2


def predicted_masked_shear_power_eb(power, mask, shape, spacing, weights,
                                    nbins=16, interpolation="log10k"):
    """EXACT expectation of :func:`masked_shear_power_eb` — leakage
    included.

    With ``gamma_hat(l') = e^{2 i phi_l'} kappa_hat(l')`` (Kaiser-
    Squires) the masked E/B modes pick up ``cos/sin(2 phi_l - 2
    phi_l')`` couplings, so

        E[P_E(l)] = [t1_l^2 A11 + t2_l^2 A22 + 2 t1_l t2_l A12](l)
                    / (Npix^2 <mask^2>),
        E[P_B(l)] = [t1_l^2 A22 + t2_l^2 A11 - 2 t1_l t2_l A12](l)
                    / (Npix^2 <mask^2>),

    with ``Aij = conv(|mask_hat|^2, ti' tj' P_kappa)`` — three 2-D FFT
    convolutions, evaluated on this lattice's exact modes (same
    t-factor Nyquist-line zeroing as the estimator) and binned
    identically.  Unit mask: P_B = 0 exactly and P_E reduces to the
    unmasked spectrum; any real footprint leaks E into B with the
    exact amplitude predicted here (the pseudo-C_ell null-test
    calibration).  Returns ``(k_mean, p_e, p_b, counts)``.
    """
    nx, ny, nz = (int(s) for s in shape)
    spacing = float(spacing)
    w_mask = np.asarray(mask, np.float64)
    if w_mask.shape != (nx, ny):
        raise ValueError(f"mask must be ({nx}, {ny}), got {w_mask.shape}")
    w2 = float(np.mean(w_mask**2))
    if w2 <= 0:
        raise ValueError("mask is identically zero")
    p_kappa = _p_kappa_grid(power, shape, spacing, weights, interpolation)
    t1, t2 = _eb_factors_np(nx, ny)
    m_hat2 = np.abs(np.fft.fft2(w_mask)) ** 2
    a11 = _conv2d(m_hat2, t1 * t1 * p_kappa)
    a22 = _conv2d(m_hat2, t2 * t2 * p_kappa)
    a12 = _conv2d(m_hat2, t1 * t2 * p_kappa)
    npix = nx * ny
    norm = 1.0 / (npix**2 * w2)
    pe = (t1 * t1 * a11 + t2 * t2 * a22 + 2.0 * t1 * t2 * a12) * norm
    pb = (t1 * t1 * a22 + t2 * t2 * a11 - 2.0 * t1 * t2 * a12) * norm
    km2, edges, mult = _kperp_setup((nx, ny), spacing, nbins)
    k_mean, p_e, counts = _bin2d(km2, mult, pe, edges, int(nbins))
    _, p_b, _ = _bin2d(km2, mult, pb, edges, int(nbins))
    return k_mean, p_e, p_b, counts


def _r2d_setup(shape2d, spacing, nbins):
    """Minimum-image transverse separation grid + log bins (the 2-D
    analog of validate/stats.py:_r_bin_setup)."""
    nx, ny = shape2d
    dx = np.minimum(np.arange(nx), nx - np.arange(nx)) * spacing
    dy = np.minimum(np.arange(ny), ny - np.arange(ny)) * spacing
    r = np.sqrt(dx[:, None] ** 2 + dy[None, :] ** 2)
    rmax = r.max()
    edges = np.logspace(
        np.log10(spacing * 0.999), np.log10(rmax * 1.001), int(nbins) + 1
    )
    return r, edges


def _bin_r2d(r, w, edges, nbins):
    idx = np.searchsorted(edges, r) - 1
    valid = (idx >= 0) & (idx < nbins) & (r > 0)
    counts = np.bincount(idx[valid], minlength=nbins).astype(np.float64)
    wsum = np.bincount(idx[valid], weights=w[valid], minlength=nbins)
    rsum = np.bincount(idx[valid], weights=r[valid], minlength=nbins)
    with np.errstate(invalid="ignore", divide="ignore"):
        return rsum / counts, wsum / counts, counts


def convergence_correlation(kappa, spacing, nbins=16):
    """Transverse two-point correlation w(R) of a convergence map.

    The configuration-space companion of :func:`convergence_power` (the
    flat-sky analog of the angular correlation function, with R the
    comoving transverse separation — convert to angle with
    ``theta = R / f_K(chi)`` at a chosen distance): one inverse
    transform of the per-mode 2-D power binned by periodic
    minimum-image separation, exactly the construction of
    ``validate/stats.py:calculate_correlation`` in two dimensions.
    Returns ``(r_mean, w, n_offsets)``; the exact expectation on the
    same modes and bins is :func:`predicted_convergence_correlation`,
    so residual gates see pure sample noise.
    """
    kappa = jnp.asarray(kappa)
    if kappa.ndim != 2:
        raise ValueError("kappa must be a 2-D map")
    nx, ny = kappa.shape
    spacing = float(spacing)

    @jax.jit
    def _xi(kp):
        # xi(d) = (1/Npix^2) sum_k |fft2 kappa|^2 e^{ik.d}, through the
        # packed singleton-axis helpers with the engine's unnormalized
        # norm='forward' inverse (the convention every FFT backend
        # supports); complex stays in-program
        c = _transform.rfftn(kp[:, :, None], norm="backward")[:, :, 0]
        p = c.real**2 + c.imag**2
        xi = _transform.irfftn(
            jax.lax.complex(p, jnp.zeros_like(p))[:, :, None],
            (nx, ny, 1), norm="forward",
        )[:, :, 0]
        return xi / (nx * ny) ** 2

    xi = np.asarray(_xi(kappa), np.float64)
    r, edges = _r2d_setup((nx, ny), spacing, nbins)
    return _bin_r2d(r, xi, edges, int(nbins))


def predicted_convergence_correlation(power, shape, spacing, weights,
                                      nbins=16, interpolation="log10k"):
    """Exact expectation of :func:`convergence_correlation` for a
    plane-sum convergence map: the per-mode expectation grid of
    :func:`predicted_convergence_power` inverse-transformed and binned
    with exactly the estimator's minimum-image shells —
    ``E[w(d)] = (1/A) sum_k P_kappa(k) e^{ik.d}``.  ``weights`` as in
    :func:`predicted_convergence_power`.
    """
    from randomfield_tpu.ops import power as _power

    nx, ny, nz = (int(s) for s in shape)
    spacing = float(spacing)
    table = _power.validate_power(power)
    _power.require_coverage(table, (nx, ny, nz), spacing)
    w = np.asarray(weights, np.float64)
    if w.shape != (nz,):
        raise ValueError(f"weights must have shape ({nz},), got {w.shape}")
    km2, _, _ = _kperp_setup((nx, ny), spacing, nbins)
    kz = 2.0 * np.pi * np.fft.fftfreq(nz, d=spacing)
    kmag3 = np.sqrt(km2[:, :, None] ** 2 + kz[None, None, :] ** 2)
    p3 = np.asarray(
        _power.interpolate_power(
            table, jnp.asarray(kmag3, jnp.float32), interpolation
        ),
        np.float64,
    )
    p3[kmag3 == 0] = 0.0
    win = np.abs(np.fft.fft(w)) ** 2
    p_kappa = (p3 * win[None, None, :]).sum(axis=-1) / (nz * spacing)
    area = nx * ny * spacing**2
    xi = np.fft.ifft2(p_kappa).real * (nx * ny) / area
    r, edges = _r2d_setup((nx, ny), spacing, nbins)
    return _bin_r2d(r, xi, edges, int(nbins))
