"""Power-spectrum tools: tables, interpolation, sigma(k) tabulation, filters.

Reference parity: ``randomfield/powertools.py`` (``load_default_power``,
``validate_power``, ``get_k_bounds``, ``fill_with_log10k``,
``tabulate_sigmas``, ``filter_modes``, sigma(R)/sigma8 helpers).  Key
reference behaviors kept (SURVEY.md sections 2-3):

* P(k) is interpolated against log10(k) (linear in P by default, optional
  log-log), exactly reproducing table knots;
* per-mode Gaussian sigmas are tabulated over the packed half-spectrum
  once per scene and reused across seeds;
* Gaussian mode filtering multiplies by exp(-k^2 s^2 / 2);
* the table must cover the grid's [k_min, k_max] (validated up front).

Differences from the reference: sigmas live in an immutable device array produced
by one fused XLA program (no in-place buffer mutation); the variance
normalization folds the box volume in so the render path is a raw
``norm='forward'`` irfftn (see ops/transform.py docstring):

    sigma(k) = sqrt(P(|k|) / V),   sigma(0) = 0.

A complex mode drawn as ``sigma * (x + i y) / sqrt(2)`` with unit normals
x, y then has ``<|c|^2> = P/V``, which is the physical ``<|c|^2> = V P``
convention after the folded 1/V.
"""

from __future__ import annotations

import functools
import pathlib
import typing

import jax
import jax.numpy as jnp
import numpy as np

from randomfield_tpu.ops import grid as _grid

__all__ = [
    "PowerTable",
    "as_power_table",
    "load_default_power",
    "validate_power",
    "get_k_bounds",
    "fill_with_log10k",
    "tabulate_sigmas",
    "filter_modes",
    "sigma_r",
    "sigma8",
    "normalize_power",
    "power_to_correlation",
]

get_k_bounds = _grid.get_k_bounds
fill_with_log10k = _grid.fill_with_log10k

_DATA_DIR = pathlib.Path(__file__).resolve().parent.parent / "data"


class PowerTable(typing.NamedTuple):
    """Tabulated isotropic power spectrum: k [h/Mpc], Pk [(Mpc/h)^3]."""

    k: np.ndarray
    Pk: np.ndarray


def as_power_table(power) -> PowerTable:
    """Coerce (N,2) arrays, (k, Pk) pairs, dicts or structured arrays."""
    if isinstance(power, PowerTable):
        return power
    if isinstance(power, dict):
        return PowerTable(
            np.asarray(power["k"], np.float64), np.asarray(power["Pk"], np.float64)
        )
    arr = np.asarray(power)
    if arr.dtype.names:  # structured array with k/Pk fields
        return PowerTable(
            np.asarray(arr["k"], np.float64), np.asarray(arr["Pk"], np.float64)
        )
    if isinstance(power, (tuple, list)) and len(power) == 2:
        return PowerTable(
            np.asarray(power[0], np.float64), np.asarray(power[1], np.float64)
        )
    arr = np.asarray(arr, np.float64)
    if arr.ndim == 2 and arr.shape[1] == 2:
        return PowerTable(arr[:, 0].copy(), arr[:, 1].copy())
    raise ValueError(
        "power must be a PowerTable, (k, Pk) pair, {'k':..,'Pk':..} dict, "
        "structured array with k/Pk fields, or (N, 2) array"
    )


def validate_power(power) -> PowerTable:
    """Validate a tabulated P(k) (ref: powertools.validate_power).

    Requires 1-D equal-length arrays, strictly increasing k > 0, finite
    P(k) >= 0.  Returns the coerced :class:`PowerTable`.
    """
    table = as_power_table(power)
    k, pk = table
    if k.ndim != 1 or pk.ndim != 1 or k.shape != pk.shape or k.size < 2:
        raise ValueError("power table must be two 1-D arrays of equal length >= 2")
    if not np.all(np.isfinite(k)) or not np.all(np.isfinite(pk)):
        raise ValueError("power table contains non-finite values")
    if k[0] <= 0 or np.any(np.diff(k) <= 0):
        raise ValueError("power table k values must be positive and strictly increasing")
    if np.any(pk < 0):
        raise ValueError("power table P(k) values must be non-negative")
    return table


def load_default_power() -> PowerTable:
    """Default linear P(k) table (ref: powertools.load_default_power).

    Loaded from ``randomfield_tpu/data/default_power.dat`` (generated by
    ``scripts/make_default_power.py`` from the EH98 model at Planck13,
    standing in for the reference's CAMB table); regenerated on the fly if
    the data file is missing.
    """
    path = _DATA_DIR / "default_power.dat"
    if path.exists():
        arr = np.loadtxt(path)
        return PowerTable(arr[:, 0], arr[:, 1])
    from randomfield_tpu.models.powerspec import make_power_table

    return PowerTable(*make_power_table())


def require_coverage(power: PowerTable, shape, spacing):
    """Raise unless the table covers the grid's [k_min, k_max]."""
    kmin, kmax = get_k_bounds(shape, spacing)
    if power.k[0] > kmin or power.k[-1] < kmax:
        raise ValueError(
            f"power table covers k in [{power.k[0]:.3g}, {power.k[-1]:.3g}] h/Mpc "
            f"but the grid needs [{kmin:.3g}, {kmax:.3g}]"
        )


def interpolate_power(power: PowerTable, k, interpolation="log10k", dtype=jnp.float32):
    """P at arbitrary |k| by interpolation against log10(k).

    ``interpolation='log10k'`` — P linear in log10(k) (the reference's
    scipy interp1d behavior, SURVEY.md section 3.3); ``'loglog'`` —
    log10(P) linear in log10(k) (exact for power laws; requires P > 0).
    Out-of-range k clamp to the table edges (coverage is validated
    separately, so clamping only ever applies to the DC sentinel).
    """
    lk_tab = jnp.asarray(np.log10(power.k), dtype=dtype)
    lk = jnp.log10(jnp.maximum(k, jnp.asarray(10.0 ** (np.log10(power.k[0]) - 40), dtype)))
    if interpolation == "log10k":
        pk_tab = jnp.asarray(power.Pk, dtype=dtype)
        return jnp.interp(lk, lk_tab, pk_tab)
    if interpolation == "loglog":
        if np.any(power.Pk <= 0):
            raise ValueError("loglog interpolation requires strictly positive P(k)")
        lpk_tab = jnp.asarray(np.log10(power.Pk), dtype=dtype)
        return 10.0 ** jnp.interp(lk, lk_tab, lpk_tab)
    raise ValueError(f"unknown interpolation {interpolation!r}")


def _interp_traced(k, lk_tab, val_tab, log_values):
    """P(|k|) from traced table arrays: val_tab is P or log10(P)."""
    lk = jnp.log10(jnp.maximum(k, jnp.asarray(1e-30, k.dtype)))
    out = jnp.interp(lk, lk_tab, val_tab)
    if log_values:
        out = 10.0**out
    return out


def _sigma_chunk(kx_sq, kmid, klast, lk_tab, val_tab, log_values, dtype, volume):
    """sigma(k) for an x-slab: kx_sq (cx,), broadcast over the last axes."""
    k2 = (
        kx_sq[:, None, None]
        + (kmid * kmid)[None, :, None]
        + (klast * klast)[None, None, :]
    )
    pk = _interp_traced(jnp.sqrt(k2), lk_tab, val_tab, log_values)
    sig = jnp.sqrt(pk / jnp.asarray(volume, dtype))
    return jnp.where(k2 > 0, sig, jnp.zeros((), dtype))


@functools.partial(
    jax.jit,
    static_argnames=("out_shape", "chunks", "log_values", "volume", "dtype_name"),
)
def _tabulate_jit(kx, kmid, klast, lk_tab, val_tab, out_shape, chunks,
                  log_values, volume, dtype_name):
    dtype = jnp.dtype(dtype_name)
    nx = kx.shape[0]
    kx_sq = (kx * kx).reshape(chunks, nx // chunks)
    sig = jax.lax.map(
        lambda kxs: _sigma_chunk(
            kxs, kmid, klast, lk_tab, val_tab, log_values, dtype, volume
        ),
        kx_sq,
    )
    return sig.reshape(out_shape)


def tabulate_sigmas(shape, spacing, power, interpolation="log10k",
                    dtype=jnp.float32, layout="xyz"):
    """Per-mode Gaussian sigma(k) = sqrt(P(|k|)/V) over the half-spectrum.

    (Ref: powertools.tabulate_sigmas, which writes sigma into the packed
    buffer in place; here it is a pure jnp function returning an immutable
    device array.)  The DC mode gets sigma = 0 so every field has exactly
    zero mean.

    Evaluated in x-slab chunks under ``lax.map`` so the interpolation
    gathers' temporaries stay bounded — at 1024^3 the one-shot version
    needs > 16 GB of HLO temps, the chunked one a few hundred MB beyond
    the output grid.

    ``layout='xyz'`` returns (nx, ny, nzh) — the packed rfft order;
    ``layout='xzy'`` returns (nx, nzh, ny) — the staged pipeline's
    internal order, which is the canonical Threefry draw order (see
    engine/staged.py).
    """
    power = validate_power(power)
    require_coverage(power, shape, spacing)
    nx, ny, nz = shape
    volume = nx * ny * nz * float(spacing) ** 3
    kx, ky, kz = _grid.kvectors(shape, spacing, dtype)
    if layout == "xyz":
        kmid, klast, out_shape = ky, kz, (nx, ny, nz // 2 + 1)
    elif layout == "xzy":
        kmid, klast, out_shape = kz, ky, (nx, nz // 2 + 1, ny)
    else:
        raise ValueError(f"unknown layout {layout!r}")

    chunks = 1
    for c in range(min(16, nx), 0, -1):
        if nx % c == 0:
            chunks = c
            break

    lk_tab, val_tab, log_values = _table_arrays(power, interpolation, dtype)
    return _tabulate_jit(
        kx, kmid, klast, lk_tab, val_tab, out_shape, chunks, log_values,
        volume, str(jnp.dtype(dtype)),
    )


def sigma_inline(shape, spacing, lk_tab, val_tab, log_values, dtype,
                 layout="xyz"):
    """sigma(k) grid built INSIDE a traced computation (no stored array).

    Same math as :func:`tabulate_sigmas` (identical per-element float32
    expression: sqrt(interp(P)/V), DC -> 0), but returned as one traced
    expression built from 1-D frequency vectors — under a sharded program
    XLA propagates the consumer's sharding into the broadcasts, so each
    device materializes only its shard and the full sigma grid never
    exists anywhere.  This is how mesh renders evaluate sigma: at 2048^3
    a stored sigma grid is 17 GB (or a replicated pencil placement, the
    round-2 weak item), inline evaluation is zero resident bytes.

    ``lk_tab``/``val_tab``/``log_values`` come from ``_table_arrays``.
    """
    nx, ny, nz = shape
    volume = nx * ny * nz * float(spacing) ** 3
    kx, ky, kz = _grid.kvectors(shape, spacing, dtype)
    kmid, klast = (ky, kz) if layout == "xyz" else (kz, ky)
    return _sigma_chunk(
        kx * kx, kmid, klast, lk_tab, val_tab, log_values, jnp.dtype(dtype),
        volume,
    )


def table_arrays_host(power, interpolation, dtype):
    """(log10 k, P or log10 P, log_values flag) as HOST numpy arrays.

    The replicated-input form of ``_table_arrays`` for multi-process
    programs (parallel/multihost.py: small per-call inputs must be
    process-replicated host values).
    """
    np_dtype = np.dtype(str(jnp.dtype(dtype)))
    if interpolation == "log10k":
        return (
            np.log10(power.k).astype(np_dtype),
            np.asarray(power.Pk, np_dtype),
            False,
        )
    if interpolation == "loglog":
        if np.any(power.Pk <= 0):
            raise ValueError("loglog interpolation requires strictly positive P(k)")
        return (
            np.log10(power.k).astype(np_dtype),
            np.log10(power.Pk).astype(np_dtype),
            True,
        )
    raise ValueError(f"unknown interpolation {interpolation!r}")


def _table_arrays(power, interpolation, dtype):
    """(log10 k, P or log10 P, log_values flag) as device arrays."""
    if interpolation == "log10k":
        return (
            jnp.asarray(np.log10(power.k), dtype),
            jnp.asarray(power.Pk, dtype),
            False,
        )
    if interpolation == "loglog":
        if np.any(power.Pk <= 0):
            raise ValueError("loglog interpolation requires strictly positive P(k)")
        return (
            jnp.asarray(np.log10(power.k), dtype),
            jnp.asarray(np.log10(power.Pk), dtype),
            True,
        )
    raise ValueError(f"unknown interpolation {interpolation!r}")


def filter_modes(c, shape, spacing, smoothing_length):
    """Gaussian smoothing in k-space: multiply by exp(-k^2 s^2 / 2).

    (Ref: powertools.filter_modes.)  Works on a spectrum or on a sigma
    grid — the filter is symmetric in k so it commutes with sampling and
    symmetrization.  ``smoothing_length`` may be a traced scalar; 0 is the
    identity, so branchless rendering uses it as the "no smoothing" value.
    """
    k2 = _grid.ksq(shape, spacing, c.real.dtype if jnp.iscomplexobj(c) else c.dtype)
    s = jnp.asarray(smoothing_length, k2.dtype)
    return c * jnp.exp(-0.5 * k2 * s * s).astype(c.dtype)


def sigma_r(power, r, z_weight=1.0):
    """Top-hat rms fluctuation sigma(R) from the table (float64, host).

    sigma^2(R) = 1/(2 pi^2) * integral k^3 P(k) W(kR)^2 dln k,
    W(x) = 3 (sin x - x cos x) / x^3.  (Ref: powertools sigma(R)
    tabulation used for sigma8 normalization.)
    """
    table = validate_power(power)
    k, pk = table.k, table.Pk
    x = k * r
    w = np.where(x > 1e-4, 3.0 * (np.sin(x) - x * np.cos(x)) / x**3, 1.0 - x**2 / 10.0)
    integrand = k**3 * pk * w**2 / (2.0 * np.pi**2)
    return float(z_weight) * float(np.sqrt(np.trapezoid(integrand, np.log(k))))


def sigma8(power):
    """sigma(R = 8 Mpc/h) of a tabulated power spectrum."""
    return sigma_r(power, 8.0)


def _filon_sincos(k, f, r):
    """Exact ``(Int f sin(kr) dk, Int f cos(kr) dk)`` for the
    piecewise-LINEAR interpolant of ``f`` over nodes ``k`` (scalar
    ``r > 0``).  This is Filon-type quadrature: the smooth prefactor is
    interpolated, the oscillation is integrated analytically — accurate
    no matter how many periods fit between nodes (a plain trapezoid
    needs several nodes PER period and silently loses accuracy once
    k r outruns the sampling; that failure mode is gated in
    tests/test_correlation.py against a 4e6-point arbiter).
    """
    s = np.sin(k * r)
    c = np.cos(k * r)
    b = np.diff(f) / np.diff(k)          # interval slopes
    # sum_i b_i (g_{i+1} - g_i) = -sum_j g_j (b_j - b_{j-1}) with the
    # boundary slopes zero-extended
    w = np.empty_like(f)
    w[0] = -b[0]
    w[-1] = b[-1]
    w[1:-1] = b[:-1] - b[1:]
    i_sin = (f[0] * c[0] - f[-1] * c[-1]) / r + (s @ w) / (r * r)
    i_cos = (f[-1] * s[-1] - f[0] * s[0]) / r + (c @ w) / (r * r)
    return i_sin, i_cos


#: k*r boundary between the smooth (trapezoid, series-guarded Bessel)
#: and oscillatory (Filon) quadrature regimes.
_FILON_SPLIT = 1.0


def _k_grid(power, n, kmax):
    table = validate_power(power)
    k_lo = float(table.k[0])
    k_hi = float(table.k[-1]) if kmax is None else min(float(kmax),
                                                       float(table.k[-1]))
    if k_hi <= k_lo:
        raise ValueError(f"kmax={kmax} is at or below the table floor {k_lo}")
    k = np.logspace(np.log10(k_lo), np.log10(k_hi), int(n))
    pk = np.interp(np.log10(k), np.log10(table.k), table.Pk)
    return k, pk


def power_to_correlation(power, r, n=8192, kmax=None):
    """Theory two-point correlation xi(r) from the table (float64, host).

    xi(r) = 1/(2 pi^2) * integral k^2 P(k) j0(kr) dk with j0 = sin(x)/x,
    over a dense log resampling of the table (``n`` points; P
    interpolated linearly against log10 k like the engine).  The
    quadrature is hybrid: trapezoid where k r < 1 (smooth), Filon-type
    (:func:`_filon_sincos` — oscillation integrated analytically
    against the piecewise-linear k P(k)) beyond, so BAO-scale and
    larger r are exact to the resampling; gated against a fine arbiter
    and the independent FFTLog path (ops/fftlog.py) in tests.  ``r`` is
    a scalar or array in Mpc/h; ``kmax`` (default: the table's top)
    hard-truncates the band — for grid comparisons pass the grid's
    Nyquist so theory and realization share a band limit.

    Companion of :func:`sigma_r` (the same integral with the top-hat
    window squared in place of j0); the measured counterpart is
    :func:`randomfield_tpu.validate.stats.calculate_correlation`.
    """
    k, pk = _k_grid(power, n, kmax)
    lnk = np.log(k)
    r_arr = np.atleast_1d(np.asarray(r, np.float64))
    xi = np.empty(r_arr.shape, np.float64)
    for j, rj in enumerate(r_arr.ravel()):
        i0 = int(np.searchsorted(k, _FILON_SPLIT / max(rj, 1e-300)))
        i0 = min(i0, k.size - 1)
        acc = 0.0
        if i0 > 0:
            x = k[: i0 + 1] * rj
            j0 = np.where(x > 1e-6,
                          np.sin(x) / np.where(x > 0, x, 1.0),
                          1.0 - x**2 / 6.0)
            acc += np.trapezoid(k[: i0 + 1] ** 3 * pk[: i0 + 1] * j0,
                                lnk[: i0 + 1])
        if i0 < k.size - 1:
            i_sin, _ = _filon_sincos(k[i0:], k[i0:] * pk[i0:], rj)
            acc += i_sin / rj
        xi.ravel()[j] = acc / (2.0 * np.pi**2)
    return xi if np.ndim(r) else float(xi[0])


def _j2(x):
    """Spherical Bessel j2 with a series guard against cancellation."""
    xs = np.where(x > 0.1, x, 1.0)
    direct = (3.0 / xs**2 - 1.0) * np.sin(xs) / xs - 3.0 * np.cos(xs) / xs**2
    series = x**2 / 15.0 * (1.0 - x**2 / 14.0 + x**4 / 504.0)
    return np.where(x > 0.1, direct, series)


def _j4(x):
    """Spherical Bessel j4 with a series guard against cancellation."""
    xs = np.where(x > 0.5, x, 1.0)
    direct = (
        (105.0 / xs**4 - 45.0 / xs**2 + 1.0) * np.sin(xs) / xs
        + (10.0 / xs**2 - 105.0 / xs**4) * np.cos(xs)
    )
    series = x**4 / 945.0 * (1.0 - x**2 / 22.0 + x**4 / 1144.0)
    return np.where(x > 0.5, direct, series)


_KAISER_COEFFS = {
    0: lambda f: 1.0 + 2.0 * f / 3.0 + f * f / 5.0,
    2: lambda f: 4.0 * f / 3.0 + 4.0 * f * f / 7.0,
    4: lambda f: 8.0 * f * f / 35.0,
}


def power_to_correlation_multipoles(power, r, f=0.0, ells=(0, 2, 4),
                                    n=8192, kmax=None):
    """Theory xi_ell(s) from the table under linear Kaiser distortion.

    ``xi_ell(s) = (-1)^(ell/2) / (2 pi^2) * integral k^2 P_ell(k)
    j_ell(ks) dk`` with the Kaiser multipoles ``P_0 = (1 + 2f/3 +
    f^2/5) P``, ``P_2 = (4f/3 + 4f^2/7) P``, ``P_4 = (8f^2/35) P``
    (``f=0``: the quadrupole/hexadecapole vanish and the monopole is
    :func:`power_to_correlation`).  Same hybrid trapezoid + Filon
    scheme and ``kmax`` band-limit convention as that function (the
    j_ell sin/cos decompositions, e.g. ``k^2 P j2(kr) =
    3 (P/k) sin / r^3 - k P sin / r - 3 P cos / r^2``, reduce each
    multipole to Filon integrals of smooth prefactors); returns an
    array shaped ``(len(ells),) + shape(r)``.  The grid-exact
    counterpart (discrete modes, estimator bins) is
    :func:`randomfield_tpu.validate.stats.predicted_correlation_multipoles`.
    """
    for e in ells:
        if int(e) not in _KAISER_COEFFS:
            raise ValueError(f"ell={e} unsupported: even 0/2/4 only")
    k, pk = _k_grid(power, n, kmax)
    lnk = np.log(k)
    r_arr = np.atleast_1d(np.asarray(r, np.float64))
    bessels = {
        0: lambda x: np.where(x > 1e-6, np.sin(x) / np.where(x > 0, x, 1.0),
                              1.0 - x**2 / 6.0),
        2: _j2,
        4: _j4,
    }
    f = float(f)

    def tail(e, i0, rj):
        """Filon piece of Int k^2 P j_e(k rj) dk over k[i0:]."""
        ks, ps = k[i0:], pk[i0:]
        if e == 0:
            i_sin, _ = _filon_sincos(ks, ks * ps, rj)
            return i_sin / rj
        if e == 2:
            s_pok, c_pok = _filon_sincos(ks, ps / ks, rj)
            s_kp, _ = _filon_sincos(ks, ks * ps, rj)
            _, c_p = _filon_sincos(ks, ps, rj)
            return 3.0 * s_pok / rj**3 - s_kp / rj - 3.0 * c_p / rj**2
        s_pok3, _ = _filon_sincos(ks, ps / ks**3, rj)
        s_pok, _ = _filon_sincos(ks, ps / ks, rj)
        s_kp, _ = _filon_sincos(ks, ks * ps, rj)
        _, c_p = _filon_sincos(ks, ps, rj)
        _, c_pok2 = _filon_sincos(ks, ps / ks**2, rj)
        return (105.0 * s_pok3 / rj**5 - 45.0 * s_pok / rj**3
                + s_kp / rj + 10.0 * c_p / rj**2
                - 105.0 * c_pok2 / rj**4)

    raw = {int(e): np.empty(r_arr.size, np.float64) for e in set(ells)}
    for j, rj in enumerate(r_arr.ravel()):
        i0 = int(np.searchsorted(k, _FILON_SPLIT / max(rj, 1e-300)))
        i0 = min(i0, k.size - 1)
        for e in raw:
            acc = 0.0
            if i0 > 0:
                x = k[: i0 + 1] * rj
                acc += np.trapezoid(
                    k[: i0 + 1] ** 3 * pk[: i0 + 1] * bessels[e](x),
                    lnk[: i0 + 1])
            if i0 < k.size - 1:
                acc += tail(e, i0, rj)
            raw[e][j] = acc / (2.0 * np.pi**2)
    out = []
    for e in ells:
        e = int(e)
        sign = (-1.0) ** (e // 2)
        out.append(sign * _KAISER_COEFFS[e](f)
                   * raw[e].reshape(r_arr.shape))
    out = np.stack(out)
    return out if np.ndim(r) else out[:, 0]


_LEGENDRE_EVEN_MU = {
    0: lambda mu: np.ones_like(mu),
    2: lambda mu: 0.5 * (3.0 * mu**2 - 1.0),
    4: lambda mu: 0.125 * (35.0 * mu**4 - 30.0 * mu**2 + 3.0),
}


def power_to_projected_correlation(power, rp, pi_max, f=0.0, ells=(0, 2, 4),
                                   n=8192, kmax=None, npi=257):
    """Theory projected correlation w_p(r_p) from the table (float64, host).

    ``w_p(r_p) = 2 * integral_0^{pi_max} xi(s, mu) dpi`` with
    ``s = sqrt(r_p^2 + pi^2)``, ``mu = pi / s``, and — under linear
    Kaiser distortion with growth rate ``f`` — ``xi(s, mu) =
    sum_ell xi_ell(s) L_ell(mu)`` built from
    :func:`power_to_correlation_multipoles` (``f=0`` reduces to the
    isotropic :func:`power_to_correlation`).  The pi integral is a
    trapezoid over ``npi`` uniform points; ``pi_max`` is the survey's
    line-of-sight truncation depth in Mpc/h (w_p depends on it — match
    it to the estimator's).  Same ``n``/``kmax`` band conventions as
    the other theory transforms.  The grid-exact counterpart (discrete
    modes, estimator bins, periodic minimum image) is
    :func:`randomfield_tpu.validate.stats.predicted_projected_correlation`.
    """
    rp_arr = np.atleast_1d(np.asarray(rp, np.float64))
    pi_grid = np.linspace(0.0, float(pi_max), int(npi))
    s = np.sqrt(rp_arr.reshape(-1, 1) ** 2 + pi_grid[None, :] ** 2)
    f = float(f)
    if f:
        xil = power_to_correlation_multipoles(
            power, s.ravel(), f=f, ells=ells, n=n, kmax=kmax
        )
        mu = np.where(s > 0, pi_grid[None, :] / np.where(s > 0, s, 1.0), 0.0)
        xi_smu = np.zeros_like(s)
        for i, e in enumerate(ells):
            xi_smu += (xil[i].reshape(s.shape)
                       * _LEGENDRE_EVEN_MU[int(e)](mu))
    else:
        xi_smu = power_to_correlation(
            power, s.ravel(), n=n, kmax=kmax
        ).reshape(s.shape)
    wp = 2.0 * np.trapezoid(xi_smu, pi_grid, axis=1)
    wp = wp.reshape(rp_arr.shape)
    return wp if np.ndim(rp) else float(wp[0])


def normalize_power(power, sigma8_target):
    """Rescale a table so its sigma8 equals ``sigma8_target``."""
    table = validate_power(power)
    s8 = sigma8(table)
    if s8 == 0:
        raise ValueError("cannot normalize a zero power spectrum")
    return PowerTable(table.k, table.Pk * (float(sigma8_target) / s8) ** 2)
