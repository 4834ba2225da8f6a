"""Pairwise-velocity statistics: measured and exactly predicted.

The mean pairwise (infall) velocity v12(r) — the kSZ / RSD companion of
xi(r) — is, to linear order in the fields,

    v12(r) = 2 <delta(x) v_r(x + r)> / (1 + xi(r)),

with v_r the velocity component along the separation.  Both the
numerator psi_r(r) = <delta v_r> and xi(r) are two-point functions this
framework can evaluate two ways, mirroring validate/stats.py's
measure-vs-exactly-predict pairing:

- MEASURE from a rendered (delta, velocity) pair: one forward transform
  each, the per-mode cross spectrum conj(delta_k) v_k, an inverse
  transform per component, projection onto the signed minimum-image
  separation direction, and |r|-shell binning (the same one-hot matmul
  binning core as every other estimator, validate/stats.py:_masked_bins).
- PREDICT exactly: the engine's velocity kernel is v_k = i a H f
  delta_k k / k^2 (ops/derived.py:delta_to_velocity), so the expected
  cross spectrum is i pref (k_j / k^2) P(k) per DISCRETE mode; pushing
  that grid through the identical projection + binning makes
  measured-vs-predicted residuals pure sample noise.  Feeding the
  REALIZED per-mode power |c_k|^2/V instead of P(k) reproduces the
  measurement exactly (no noise at all) — the deterministic parity gate
  in tests/test_velocity.py.

Continuum cross-check (also gated): psi_r(r) -> -(a H f / h) / (2 pi^2)
* Integral dk k P(k) j_1(kr) for r far from the grid scale and box side,
evaluated independently via FFTLog (ops/fftlog.py:fftlog_bessel, ell=1).

Sign convention: r points from x (the density point) to x + r (the
velocity point); infall makes psi_r and v12 negative.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from randomfield_tpu.ops import grid as _grid
from randomfield_tpu.ops import transform as _transform
from randomfield_tpu.validate.stats import (
    _binned_xi_from_power_grid,
    _masked_bins,
    _min_image_r2,
    _mode_power,
    _r_bin_setup,
)

__all__ = [
    "density_velocity_correlation",
    "predicted_density_velocity_correlation",
    "pairwise_velocity",
    "predicted_pairwise_velocity",
    "continuum_pairwise_velocity",
]


def _velocity_prefactor(cosmology, z):
    """a H f / h in km/s per Mpc/h (ops/derived.py:delta_to_velocity)."""
    from randomfield_tpu.models.cosmology import create_cosmology

    cosmology = create_cosmology(cosmology)
    z = float(z)
    a = 1.0 / (1.0 + z)
    H = cosmology.H0 * float(cosmology.efunc(z))
    return a * H * cosmology.growth_rate(z) / cosmology.h


def _signed_unit_r(shape, spacing, dtype):
    """(|r|, e_x, e_y, e_z) over the real grid with SIGNED minimum-image
    displacements (index i -> i for i <= n/2, i - n above; the ambiguous
    i = n/2 plane keeps the + sign — psi_r there is ~0 by parity)."""
    ax_signed = []
    for n in shape:
        i = np.arange(n)
        d = np.where(i <= n // 2, i, i - n).astype(np.float64) * spacing
        ax_signed.append(d)
    _, r2 = _min_image_r2(shape, spacing)
    r = np.sqrt(r2)
    with np.errstate(invalid="ignore", divide="ignore"):
        inv = np.where(r > 0, 1.0 / np.where(r > 0, r, 1.0), 0.0)
    e = [
        ax_signed[0][:, None, None] * inv,
        ax_signed[1][None, :, None] * inv,
        ax_signed[2][None, None, :] * inv,
    ]
    return (jnp.asarray(r, dtype),
            tuple(jnp.asarray(c, dtype) for c in e))


@functools.partial(jax.jit, static_argnames=("shape", "spacing", "nbins"))
def _binned_psi_from_cross(cross_re, cross_im, shape, spacing, nbins):
    """psi_r(r) bins from per-mode cross spectra G_j = conj(d_k) v_jk / V.

    ``cross_re``/``cross_im``: (3, half-grid) float32 — complex crosses
    arrive split because only real arrays cross the host/device boundary
    on this platform (see tests/conftest gotchas).  One irfftn per
    component, r-hat projection with signed minimum-image axes, then the
    shared binning core.
    """
    volume = shape[0] * shape[1] * shape[2] * spacing**3
    rmag, e = _signed_unit_r(shape, spacing, jnp.float32)
    psi_r = None
    for j in range(3):
        g = jax.lax.complex(cross_re[j], cross_im[j]) / jnp.asarray(
            volume, jnp.float32)
        psi_j = _transform.irfftn(g, shape)
        term = psi_j * e[j]
        psi_r = term if psi_r is None else psi_r + term
    edges = jnp.asarray(_r_bin_setup(shape, spacing, nbins), psi_r.dtype)
    return _masked_bins(rmag, 1.0, psi_r, edges, nbins, per_slab=True)


@functools.partial(jax.jit, static_argnames=("shape", "spacing"))
def _cross_spectra(delta, velocity, shape, spacing):
    """G_j = conj(delta_k) v_jk / V for j = x, y, z (split re/im)."""
    volume = shape[0] * shape[1] * shape[2] * spacing**3
    c_d = _transform.field_to_spectrum(delta, spacing)
    res, ims = [], []
    for j in range(3):
        c_v = _transform.field_to_spectrum(velocity[j], spacing)
        g = jnp.conj(c_d) * c_v / jnp.asarray(volume, c_d.dtype)
        res.append(g.real)
        ims.append(g.imag)
    return jnp.stack(res), jnp.stack(ims)


def _bins_to_host(counts, psum, ksum):
    counts = np.asarray(counts, np.float64)
    psum = np.asarray(psum, np.float64)
    ksum = np.asarray(ksum, np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        return ksum / counts, psum / counts, counts


def _signed_axis_vectors(shape, spacing):
    """Per-axis SIGNED minimum-image displacement vectors (numpy)."""
    out = []
    for n in shape:
        i = np.arange(n)
        out.append(
            (np.where(i <= n // 2, i, i - n) * float(spacing)).astype(
                np.float32
            )
        )
    return out


@functools.lru_cache(maxsize=16)
def _make_mesh_psi(mesh, shape, spacing, nbins):
    """Distributed psi_r(r): sharded forward transforms + per-mode
    crosses + sharded inverses, then shard-local r-hat projection and
    binning with one psum.  Slab and pencil meshes; nothing (fields,
    spectra, the projection grids) is ever gathered — the r-hat
    components are rebuilt per shard from sliced axis vectors.
    """
    from jax.sharding import PartitionSpec as P

    from randomfield_tpu.parallel import dfft
    from randomfield_tpu.parallel import pencil as _pencil
    from randomfield_tpu.parallel.mesh import SPACE_AXIS

    nx, ny, nz = shape
    volume = nx * ny * nz * spacing**3
    is_pencil = _pencil.is_pencil_mesh(mesh)
    sx, sy, sz = _signed_axis_vectors(shape, spacing)
    edges = _r_bin_setup(shape, spacing, nbins)
    if is_pencil:
        px = mesh.shape[_pencil.SPX_AXIS]
        py = mesh.shape[_pencil.SPY_AXIS]
        nx_loc, ny_loc = nx // px, ny // py
        in_spec = P(None, _pencil.SPX_AXIS, _pencil.SPY_AXIS, None)
        psum_axes = (_pencil.SPX_AXIS, _pencil.SPY_AXIS)
    else:
        n_space = mesh.shape[SPACE_AXIS]
        nx_loc, ny_loc = nx // n_space, ny
        in_spec = P(None, SPACE_AXIS, None, None)
        psum_axes = SPACE_AXIS

    def _local_bins(psil):
        # psil: (3, nx_loc, ny_loc, nz)
        jx = (jax.lax.axis_index(_pencil.SPX_AXIS) if is_pencil
              else jax.lax.axis_index(SPACE_AXIS))
        sx_l = jax.lax.dynamic_slice(
            jnp.asarray(sx), (jx * nx_loc,), (nx_loc,)
        )
        if is_pencil:
            jy = jax.lax.axis_index(_pencil.SPY_AXIS)
            sy_l = jax.lax.dynamic_slice(
                jnp.asarray(sy), (jy * ny_loc,), (ny_loc,)
            )
        else:
            sy_l = jnp.asarray(sy)
        sz_l = jnp.asarray(sz)
        r2 = (
            (sx_l * sx_l)[:, None, None]
            + (sy_l * sy_l)[None, :, None]
            + (sz_l * sz_l)[None, None, :]
        )
        rmag = jnp.sqrt(r2)
        inv = jnp.where(rmag > 0, 1.0 / jnp.where(rmag > 0, rmag, 1.0), 0.0)
        psi_r = (
            psil[0] * sx_l[:, None, None]
            + psil[1] * sy_l[None, :, None]
            + psil[2] * sz_l[None, None, :]
        ) * inv
        counts, psum_, rsum = _masked_bins(
            rmag, 1.0, psi_r, jnp.asarray(edges, psi_r.dtype), nbins,
            per_slab=True,
        )
        return jax.lax.psum(jnp.stack([counts, psum_, rsum]), psum_axes)

    def _forward(x):
        if is_pencil:
            return _pencil.rfftn_pencil(x, shape, mesh)
        return dfft.rfftn_slab(x, shape, mesh)

    def _inverse(c):
        if is_pencil:
            return _pencil.irfftn_pencil(
                c, shape, mesh, assume_hermitian=True,
                input_layout="state1",
            )
        return dfft.irfftn_slab(c, shape, mesh, assume_hermitian=True)

    @jax.jit
    def fn(delta, velocity):
        # rfftn here is the plain mode sum; the two field_to_spectrum
        # a^3 factors and the two 1/V synthesis factors of the
        # single-device path combine to sp^6 / V^2
        scale = jnp.asarray(spacing**6 / volume**2, jnp.complex64)
        c_d = _forward(delta)
        psi = []
        for j in range(3):
            g = jnp.conj(c_d) * _forward(velocity[j]) * scale
            psi.append(_inverse(g))
        bins = jax.shard_map(
            _local_bins, mesh=mesh, in_specs=in_spec, out_specs=P(),
            check_vma=False,
        )(jnp.stack(psi))
        return bins[0], bins[1], bins[2]

    return fn


def density_velocity_correlation(delta, velocity, spacing, nbins=24,
                                 mesh=None):
    """Measured psi_r(r) = <delta(x) v_r(x + r)> in |r| shells.

    ``velocity``: (3, nx, ny, nz) km/s (e.g.
    ``Generator.generate_velocity(seed)`` for the same seed as
    ``delta``, or ops.derived.delta_to_velocity).  Returns ``(r_mean,
    psi_r, counts)`` — psi_r in km/s, negative for infall.

    With ``mesh`` (slab or pencil; fields sharded accordingly) the
    transforms run distributed and the projection/binning is
    shard-local with one psum — parity vs the single-device estimator
    asserted in tests/test_velocity.py.
    """
    shape = tuple(int(s) for s in delta.shape[-3:])
    if velocity.shape != (3, *shape):
        raise ValueError(
            f"velocity must have shape (3, *{shape}), got {velocity.shape}")
    if mesh is not None:
        fn = _make_mesh_psi(mesh, shape, float(spacing), int(nbins))
        out = fn(jnp.asarray(delta), jnp.asarray(velocity))
        return _bins_to_host(*out)
    cr, ci = _cross_spectra(delta, velocity, shape, float(spacing))
    out = _binned_psi_from_cross(cr, ci, shape, float(spacing), int(nbins))
    return _bins_to_host(*out)


def _expected_cross_from_pgrid(pgrid, shape, spacing, pref):
    """i pref (k_j/k^2) pgrid as split re/im (3, half-grid) f32 arrays."""
    kv = _grid.kvectors(shape, float(spacing))
    k2 = np.asarray(_grid.ksq(shape, float(spacing), jnp.float32), np.float64)
    pg = np.asarray(pgrid, np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        base = np.where(k2 > 0, pg / np.where(k2 > 0, k2, 1.0), 0.0)
    bc = [
        np.asarray(kv[0], np.float64)[:, None, None],
        np.asarray(kv[1], np.float64)[None, :, None],
        np.asarray(kv[2], np.float64)[None, None, :],
    ]
    ims = [np.float32(pref) * (bc[j] * base).astype(np.float32)
           for j in range(3)]
    zeros = np.zeros(ims[0].shape, np.float32)
    return (jnp.asarray(np.stack([zeros] * 3)),
            jnp.asarray(np.stack(ims)))


def _pgrid_from_table(power, shape, spacing, interpolation,
                      smoothing_length):
    from randomfield_tpu.ops import power as _power

    table = _power.validate_power(power)
    _power.require_coverage(table, shape, spacing)
    km = _grid.kmag(shape, spacing, jnp.float32)
    pg = np.asarray(
        _power.interpolate_power(table, km, interpolation), np.float64)
    km = np.asarray(km, np.float64)
    if smoothing_length:
        pg = pg * np.exp(-((km * float(smoothing_length)) ** 2))
    pg[km == 0] = 0.0
    return pg


def predicted_density_velocity_correlation(power, shape, spacing,
                                           cosmology=None, z=0.0, nbins=24,
                                           interpolation="log10k",
                                           smoothing_length=0.0,
                                           pgrid=None):
    """EXACT binned expectation of :func:`density_velocity_correlation`.

    The expected per-mode cross spectrum i pref (k_j/k^2) P(k) pushed
    through the identical irfftn + projection + binning pipeline, with
    P interpolated like the render.  Smoothing damps the cross by
    exp(-(k L)^2) — the same factor as the power — because BOTH delta
    and the derived velocity carry the field-level exp(-(k L)^2 / 2)
    from the shared smoothed draw.  Pass ``pgrid`` (per-mode
    half-grid) to override the table — with the REALIZED |c_k|^2/V of a
    render this reproduces the measured psi_r exactly (parity gate).
    Returns ``(r_mean, psi_r, counts)``.
    """
    shape = tuple(int(s) for s in shape)
    spacing = float(spacing)
    if pgrid is None:
        pgrid = _pgrid_from_table(power, shape, spacing, interpolation,
                                  smoothing_length)
    pref = _velocity_prefactor(cosmology, z)
    cr, ci = _expected_cross_from_pgrid(pgrid, shape, spacing, pref)
    out = _binned_psi_from_cross(cr, ci, shape, spacing, int(nbins))
    return _bins_to_host(*out)


def pairwise_velocity(delta, velocity, spacing, nbins=24, mesh=None):
    """Measured linear-order mean pairwise velocity v12(r) [km/s].

    v12 = 2 psi_r / (1 + xi) with psi_r and xi measured from the same
    fields in the same |r| shells.  Returns ``(r_mean, v12, counts)``;
    negative = infall.  ``mesh``: run both two-point measurements
    distributed (slab or pencil for psi_r; xi(r) supports slab — see
    validate/stats.py:calculate_correlation).
    """
    shape = tuple(int(s) for s in delta.shape[-3:])
    r, psi, counts = density_velocity_correlation(delta, velocity, spacing,
                                                  nbins, mesh=mesh)
    if mesh is not None:
        from randomfield_tpu.validate.stats import calculate_correlation

        xi = calculate_correlation(delta, spacing, nbins, mesh=mesh)[1]
        with np.errstate(invalid="ignore", divide="ignore"):
            return r, 2.0 * psi / (1.0 + xi), counts
    p = _mode_power(delta, shape, float(spacing))
    p = p.at[0, 0, 0].set(0.0)
    cx, xs, _ = _binned_xi_from_power_grid(p, shape, float(spacing),
                                           int(nbins))
    xi = _bins_to_host(cx, xs, cx)[1]
    with np.errstate(invalid="ignore", divide="ignore"):
        return r, 2.0 * psi / (1.0 + xi), counts


def predicted_pairwise_velocity(power, shape, spacing, cosmology=None,
                                z=0.0, nbins=24, interpolation="log10k",
                                smoothing_length=0.0):
    """Exact binned expectation of :func:`pairwise_velocity` at leading
    order: 2 E[psi_r] / (1 + E[xi]) bin by bin (the ratio of
    expectations — the estimator's own ratio differs at O(1/N_modes)).
    Returns ``(r_mean, v12, counts)``.
    """
    shape = tuple(int(s) for s in shape)
    spacing = float(spacing)
    r, psi, counts = predicted_density_velocity_correlation(
        power, shape, spacing, cosmology, z, nbins, interpolation,
        smoothing_length)
    pgrid = _pgrid_from_table(power, shape, spacing, interpolation,
                              smoothing_length)
    cx, xs, _ = _binned_xi_from_power_grid(
        jnp.asarray(pgrid, jnp.float32), shape, spacing, int(nbins))
    xi = _bins_to_host(cx, xs, cx)[1]
    with np.errstate(invalid="ignore", divide="ignore"):
        return r, 2.0 * psi / (1.0 + xi), counts


def continuum_pairwise_velocity(power, r, cosmology=None, z=0.0, n=2048,
                                pad_decades=3.0):
    """Continuum linear-theory psi_r and v12 at separations ``r`` via
    FFTLog:

        psi_r(r) = -(pref / 2 pi^2) Integral dk k P(k) j_1(kr),
        v12(r)   = 2 psi_r / (1 + xi(r)),

    independent of any grid — the infinite-volume limit the discrete
    prediction approaches for r far from both the cell and the box
    scale.  Returns ``(psi_r, v12)`` at ``r``.
    """
    from randomfield_tpu.ops.fftlog import (
        _prep_power, fftlog_bessel, xi_from_power,
    )

    r = np.asarray(r, np.float64)
    pref = _velocity_prefactor(cosmology, z)
    kg, pg = _prep_power(power, n, pad_decades)
    rg, g = fftlog_bessel(kg, kg**2 * pg / (2.0 * np.pi**2), ell=1, q=1.0)
    psi = -pref * np.interp(r, rg, g)
    rx, xi = xi_from_power(power, ell=0, n=n, pad_decades=pad_decades,
                           rmin=rg[0], rmax=rg[-1])
    xi_r = np.interp(r, rx, xi)
    return psi, 2.0 * psi / (1.0 + xi_r)
