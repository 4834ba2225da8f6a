"""Constrained Gaussian realizations (Hoffman-Ribak) and Wiener filtering.

Capability extension beyond the reference package (which renders only
unconstrained fields — SURVEY.md section 0): conditional sampling of the
same Gaussian ensembles the engine renders, given

* **point constraints** — Gaussian-smoothed field values pinned at chosen
  comoving positions (Hoffman & Ribak 1991: local peaks/voids with the
  correct conditional statistics everywhere else), and
* **full-grid noisy data** — Wiener-filtered reconstruction and exact
  posterior sampling for ``data = field + white noise``.

Conventions (ops/transform.py): the engine's packed spectrum ``c_k``
satisfies ``delta(x) = sum_k c_k exp(ik.x)`` with independent packed modes
of variance ``<|c_k|^2> = sigma(k)^2`` and Hermitian multiplicity ``m_k``
(2 for interior kz, 1 on the self-conjugate kz planes, whose pairs are
both stored).  A linear functional with Hermitian kernel ``K_i(k)`` then
has, summed over packed modes::

    Gamma_i[c]  = sum m_k Re(c_k K_i(k))
    xi_ij       = <Gamma_i Gamma_j> = sum m_k sigma_k^2 Re(K_i K_j*)
    <delta(x) Gamma_i> -> correction spectrum  sigma_k^2 K_i(k)*

and the Hoffman-Ribak constrained realization of seed ``s`` is::

    c_c = c_s + sigma_eff^2 * sum_i alpha_i K_i*,
    alpha = xi^{-1} (values - Gamma[c_s])

which satisfies every constraint EXACTLY per realization while preserving
the conditional ensemble statistics.  The smoothed-value kernel is
``K_i(k) = exp(-k^2 R_i^2 / 2) exp(+i k.x_i)`` — the same Gaussian window
convention as ``ops.power.filter_modes`` — with the imaginary part zeroed
at true self-conjugate modes (the symmetric band-limited interpolation
choice; exact for positions on grid points, where that phase is +-1).

Design: kernels are never materialized globally — Gamma, the
Gram matrix xi, and the correction are accumulated per x-slab chunk under
``lax.map``, with the Gram contraction expressed as real matmuls.
Everything from sampling through the constrained inverse transform is one
jitted program; constraint positions/scales/values are traced, so moving
or re-valuing constraints never recompiles.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from randomfield_tpu.ops import grid as _grid
from randomfield_tpu.ops import power as _power
from randomfield_tpu.ops import sample as _sample
from randomfield_tpu.ops import transform as _transform

__all__ = [
    "pack_constraints",
    "constraint_gram",
    "constrained_render",
    "constrained_mean",
    "measure_constraints",
    "wiener_filter",
    "posterior_render",
    "predicted_posterior_mse",
    "make_sharded_constrained",
    "make_sharded_constraint_gram",
    "make_sharded_measure",
    "make_sharded_wiener",
    "make_sharded_posterior",
    "make_sharded_posterior_mse",
]


# --------------------------------------------------------------------------
# constraint packing + chunk geometry
# --------------------------------------------------------------------------

def pack_constraints(constraints, shape, spacing, dtype=jnp.float32):
    """Normalize a constraint list to (positions, scales, values) arrays.

    Each constraint is a mapping or tuple ``(position, value, scale)``:
    ``position`` — 3 comoving coordinates in length units (grid points sit
    at ``spacing * integer``); ``value`` — the target smoothed overdensity;
    ``scale`` — Gaussian smoothing radius R (``filter_modes`` convention,
    ``W(k) = exp(-k^2 R^2 / 2)``; 0 pins the raw band-limited field value).
    """
    pos, val, scl = [], [], []
    for c in constraints:
        if isinstance(c, dict):
            p = c["position"]
            v = c["value"]
            s = c.get("scale", 0.0)
        else:
            p, v, s = (*c, 0.0)[:3] if len(c) == 2 else c
        p = np.asarray(p, np.float64)
        if p.shape != (3,):
            raise ValueError(f"constraint position must be 3 coords, got {p.shape}")
        pos.append(p)
        val.append(float(v))
        scl.append(float(s))
    if not pos:
        raise ValueError("need at least one constraint")
    dt = jnp.dtype(dtype)
    return (
        jnp.asarray(np.stack(pos), dt),
        jnp.asarray(np.asarray(scl), dt),
        jnp.asarray(np.asarray(val), dt),
    )


def _pick_chunks(shape, n_constraints, budget_bytes=128 * 2**20):
    """Divisor of nx keeping the per-chunk (M, cx, ny, nzh) complex kernel
    stack under ``budget_bytes`` (falls back to nx = fully chunked)."""
    nx, ny, nz = shape
    nzh = nz // 2 + 1
    per_x = max(n_constraints, 1) * ny * nzh * 8
    for chunks in range(1, nx + 1):
        if nx % chunks == 0 and (nx // chunks) * per_x <= budget_bytes:
            return chunks
    return nx


def _axis_geometry(shape, spacing, dtype):
    """Host-built per-axis arrays: k vectors, self-conjugate masks, kz
    multiplicity.  Self-conjugate = own Hermitian partner per axis
    (index 0, and n/2 for even n; kz masks over the packed axis)."""
    nx, ny, nz = shape
    nzh = nz // 2 + 1
    kx = 2.0 * np.pi * np.fft.fftfreq(nx, d=spacing)
    ky = 2.0 * np.pi * np.fft.fftfreq(ny, d=spacing)
    kz = 2.0 * np.pi * np.fft.rfftfreq(nz, d=spacing)

    def own_partner(n):
        m = np.zeros(n, bool)
        m[0] = True
        if n % 2 == 0:
            m[n // 2] = True
        return m

    sz = np.zeros(nzh, bool)
    sz[0] = True
    mult = np.full(nzh, 2.0)
    mult[0] = 1.0
    if nz % 2 == 0:
        sz[-1] = True
        mult[-1] = 1.0
    dt = jnp.dtype(dtype)
    return (
        jnp.asarray(kx, dt), jnp.asarray(ky, dt), jnp.asarray(kz, dt),
        jnp.asarray(own_partner(nx)), jnp.asarray(own_partner(ny)),
        jnp.asarray(sz), jnp.asarray(mult, dt),
    )


def _kernel_chunk(kxs, sxs, ky, kz, sy, sz, pos, scales):
    """Constraint kernels over one x-slab: (Kr, Ki), each (M, cx, ny, nzh).

    K_m = exp(-k^2 R_m^2 / 2) * exp(+i k.x_m); Im K is zeroed at true
    self-conjugate modes (kx, ky, kz all their own partner) so the
    functional is real-valued and the correction spectrum stays exactly
    Hermitian (module docstring).
    """
    k2 = (
        (kxs * kxs)[:, None, None]
        + (ky * ky)[None, :, None]
        + (kz * kz)[None, None, :]
    )
    phase = (
        kxs[None, :, None, None] * pos[:, 0, None, None, None]
        + ky[None, None, :, None] * pos[:, 1, None, None, None]
        + kz[None, None, None, :] * pos[:, 2, None, None, None]
    )
    win = jnp.exp(-0.5 * k2[None] * (scales * scales)[:, None, None, None])
    self_conj = (
        sxs[:, None, None] & sy[None, :, None] & sz[None, None, :]
    )
    kr = win * jnp.cos(phase)
    ki = jnp.where(self_conj[None], 0.0, win * jnp.sin(phase))
    return kr, ki


def _sigma_eff2_chunk(sig_chunk, kxs, ky, kz, sm):
    """(sigma * gaussian_filter)^2 for one x-slab (sm traced)."""
    k2 = (
        (kxs * kxs)[:, None, None]
        + (ky * ky)[None, :, None]
        + (kz * kz)[None, None, :]
    )
    f = jnp.exp(-0.5 * k2 * sm * sm)
    se = sig_chunk * f
    return se * se


# --------------------------------------------------------------------------
# jitted programs
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("shape", "spacing", "chunks"))
def _gram_jit(sigmas, pos, scales, sm, shape, spacing, chunks):
    """xi_ij = sum m_k sigma_eff^2 Re(K_i K_j*): (M, M), chunked matmuls."""
    nx = shape[0]
    cx = nx // chunks
    kx, ky, kz, sx, sy, sz, mult = _axis_geometry(shape, spacing, sigmas.dtype)
    sig_ch = sigmas.reshape(chunks, cx, *sigmas.shape[1:])

    def one(args):
        kxs, sxs, sig = args
        kr, ki = _kernel_chunk(kxs, sxs, ky, kz, sy, sz, pos, scales)
        w = mult[None, None, :] * _sigma_eff2_chunk(sig, kxs, ky, kz, sm)
        m = pos.shape[0]
        a_r = (kr * w[None]).reshape(m, -1)
        a_i = (ki * w[None]).reshape(m, -1)
        hi = jax.lax.Precision.HIGHEST
        return (
            jnp.matmul(a_r, kr.reshape(m, -1).T, precision=hi)
            + jnp.matmul(a_i, ki.reshape(m, -1).T, precision=hi)
        )

    parts = jax.lax.map(
        one, (kx.reshape(chunks, cx), sx.reshape(chunks, cx), sig_ch)
    )
    return jnp.sum(parts, axis=0)


def _measure_chunked(c, pos, scales, shape, spacing, chunks):
    """Gamma_i = sum m_k Re(c_k K_i) over the packed spectrum (traced)."""
    nx = shape[0]
    cx = nx // chunks
    kx, ky, kz, sx, sy, sz, mult = _axis_geometry(
        shape, spacing, c.real.dtype
    )
    cr = c.real.reshape(chunks, cx, *c.shape[1:])
    ci = c.imag.reshape(chunks, cx, *c.shape[1:])

    def one(args):
        kxs, sxs, re, im = args
        kr, ki = _kernel_chunk(kxs, sxs, ky, kz, sy, sz, pos, scales)
        w = mult[None, None, :]
        m = pos.shape[0]
        hi = jax.lax.Precision.HIGHEST
        return (
            jnp.matmul(kr.reshape(m, -1), (w * re).reshape(-1), precision=hi)
            - jnp.matmul(ki.reshape(m, -1), (w * im).reshape(-1), precision=hi)
        )

    parts = jax.lax.map(
        one, (kx.reshape(chunks, cx), sx.reshape(chunks, cx), cr, ci)
    )
    return jnp.sum(parts, axis=0)


def _correction_chunked(sigmas, alpha, pos, scales, sm, shape, spacing,
                        chunks):
    """Correction spectrum sigma_eff^2 * sum_i alpha_i K_i* (traced)."""
    nx = shape[0]
    cx = nx // chunks
    kx, ky, kz, sx, sy, sz, _ = _axis_geometry(shape, spacing, sigmas.dtype)
    sig_ch = sigmas.reshape(chunks, cx, *sigmas.shape[1:])

    def one(args):
        kxs, sxs, sig = args
        kr, ki = _kernel_chunk(kxs, sxs, ky, kz, sy, sz, pos, scales)
        se2 = _sigma_eff2_chunk(sig, kxs, ky, kz, sm)
        hi = jax.lax.Precision.HIGHEST
        dr = se2 * jnp.tensordot(alpha, kr, axes=1, precision=hi)
        di = -se2 * jnp.tensordot(alpha, ki, axes=1, precision=hi)
        return jax.lax.complex(dr, di)

    parts = jax.lax.map(
        one, (kx.reshape(chunks, cx), sx.reshape(chunks, cx), sig_ch)
    )
    return parts.reshape(nx, *sigmas.shape[1:])


@functools.partial(
    jax.jit, static_argnames=("shape", "spacing", "chunks", "nested")
)
def _constrained_render_jit(key, sigmas, weights, gram, pos, scales, values,
                            sm, shape, spacing, chunks, nested):
    """One fused program: sample -> measure -> solve -> correct -> irfftn."""
    sampler = (
        _sample.sample_spectrum_nested if nested else _sample.sample_spectrum
    )
    c = sampler(key, sigmas, shape)
    c = _power.filter_modes(c, shape, spacing, sm)
    gamma = _measure_chunked(c, pos, scales, shape, spacing, chunks)
    alpha = jnp.linalg.solve(gram, values - gamma)
    c = c + _correction_chunked(
        sigmas, alpha, pos, scales, sm, shape, spacing, chunks
    )
    delta = _transform.irfftn(c, shape, norm="forward", assume_hermitian=True)
    return delta * weights[None, None, :]


@functools.partial(jax.jit, static_argnames=("shape", "spacing", "chunks"))
def _mean_field_jit(sigmas, weights, gram, pos, scales, values, sm, shape,
                    spacing, chunks):
    """Conditional mean field: the correction alone (zero random draw)."""
    alpha = jnp.linalg.solve(gram, values)
    c = _correction_chunked(
        sigmas, alpha, pos, scales, sm, shape, spacing, chunks
    )
    delta = _transform.irfftn(c, shape, norm="forward", assume_hermitian=True)
    return delta * weights[None, None, :]


@functools.partial(jax.jit, static_argnames=("shape", "spacing", "chunks"))
def _measure_field_jit(delta, pos, scales, shape, spacing, chunks):
    """Gamma[field]: forward transform then the packed-spectrum sum."""
    c = _transform.rfftn(delta, norm="forward")
    return _measure_chunked(c, pos, scales, shape, spacing, chunks)


# --------------------------------------------------------------------------
# public entry points (Generator methods delegate here)
# --------------------------------------------------------------------------

def constraint_gram(sigmas, pos, scales, smoothing_length, shape, spacing):
    """The M x M constraint covariance matrix xi (device array).

    Inspect its conditioning before trusting a large constraint set:
    coincident or window-degenerate constraints make it singular.
    """
    chunks = _pick_chunks(shape, int(pos.shape[0]))
    sm = jnp.asarray(smoothing_length, sigmas.dtype)
    return _gram_jit(sigmas, pos, scales, sm, shape, spacing, chunks)


def constrained_render(key, sigmas, weights, gram, pos, scales, values,
                       smoothing_length, shape, spacing, nested=False):
    """Hoffman-Ribak constrained realization for one seed (module core)."""
    chunks = _pick_chunks(shape, int(pos.shape[0]))
    sm = jnp.asarray(smoothing_length, sigmas.dtype)
    return _constrained_render_jit(
        key, sigmas, weights, gram, pos, scales, values, sm, shape, spacing,
        chunks, nested,
    )


def constrained_mean(sigmas, weights, gram, pos, scales, values,
                     smoothing_length, shape, spacing):
    """The conditional mean field given the constraints (no randomness)."""
    chunks = _pick_chunks(shape, int(pos.shape[0]))
    sm = jnp.asarray(smoothing_length, sigmas.dtype)
    return _mean_field_jit(
        sigmas, weights, gram, pos, scales, values, sm, shape, spacing,
        chunks,
    )


def measure_constraints(delta, pos, scales, shape, spacing):
    """Evaluate the constraint functionals on a real-space field.

    Independent validation path: forward transform + packed-mode sum, so
    exact-satisfaction tests do not reuse the render's internal Gamma.
    """
    chunks = _pick_chunks(shape, int(pos.shape[0]))
    return _measure_field_jit(delta, pos, scales, shape, spacing, chunks)


# --------------------------------------------------------------------------
# mesh-native constrained programs
#
# Sharding strategy (parallel/render.py module docstring): kernels,
# sigma and the correction are GLOBAL jit-level expressions built from
# broadcast 1-D axis vectors, so each device materializes only its shard
# and the Gamma / Gram reductions lower to XLA psums over the spatial
# mesh axes — no shard_map outside the FFT.  The M x M solve is tiny and
# replicated.  Identical Threefry draws make the sharded constrained
# field equal the single-device one.
# --------------------------------------------------------------------------

def _kernel_m(m, pos, scales, axis_geom):
    """(Kr, Ki) of constraint ``m`` as one global broadcast expression."""
    kx, ky, kz, sx, sy, sz, _ = axis_geom
    k2 = (
        (kx * kx)[:, None, None]
        + (ky * ky)[None, :, None]
        + (kz * kz)[None, None, :]
    )
    phase = (
        kx[:, None, None] * pos[m, 0]
        + ky[None, :, None] * pos[m, 1]
        + kz[None, None, :] * pos[m, 2]
    )
    win = jnp.exp(-0.5 * k2 * scales[m] * scales[m])
    self_conj = sx[:, None, None] & sy[None, :, None] & sz[None, None, :]
    return win * jnp.cos(phase), jnp.where(self_conj, 0.0, win * jnp.sin(phase))


def _sigma_eff2_global(shape, spacing, lk_tab, val_tab, log_values, dtype,
                       sm, sigmas=None):
    # sigmas: the materialized sharded grid (Generator._mesh_sigmas),
    # faster to read than the inline interpolation's gathers
    # (parallel/render.py:_sampled_spectrum); None evaluates it inline
    if sigmas is None:
        sig = _power.sigma_inline(
            shape, spacing, lk_tab, val_tab, log_values, dtype, layout="xyz"
        )
    else:
        sig = sigmas
    k2 = _grid.ksq(shape, spacing, dtype)
    se = sig * jnp.exp(-0.5 * k2 * sm * sm)
    return se * se


def _gamma_global(c, pos, scales, axis_geom, n_constraints):
    """Gamma_i = sum m_kz Re(c K_i): M global reductions (XLA psums)."""
    mult = axis_geom[-1][None, None, :]
    rows = []
    for m in range(n_constraints):
        kr, ki = _kernel_m(m, pos, scales, axis_geom)
        rows.append(jnp.sum(mult * (c.real * kr - c.imag * ki)))
    return jnp.stack(rows)


def _correction_global(se2, alpha, pos, scales, axis_geom, n_constraints):
    """sigma_eff^2 * sum_m alpha_m K_m* as one fused expression."""
    acc_r = acc_i = None
    for m in range(n_constraints):
        kr, ki = _kernel_m(m, pos, scales, axis_geom)
        tr, ti = alpha[m] * kr, -alpha[m] * ki
        acc_r = tr if acc_r is None else acc_r + tr
        acc_i = ti if acc_i is None else acc_i + ti
    return jax.lax.complex(se2 * acc_r, se2 * acc_i)


@functools.lru_cache(maxsize=32)
def make_sharded_constrained(mesh, shape, spacing, n_constraints,
                             from_seed=False, log_values=False,
                             dtype_name="float32", mean_only=False):
    """Compile a mesh-native constrained render (or conditional mean).

    fn(key, lk_tab, val_tab, gram, pos, scales, values, weights, sm) ->
    the constrained field, sharded like the plain mesh render.  With
    ``mean_only`` the random draw is skipped (key ignored) and the
    correction alone is returned — the conditional mean field.
    """
    from randomfield_tpu.parallel.render import (
        _inverse, _mesh_specs, _sampled_spectrum,
    )

    dtype = jnp.dtype(dtype_name)
    _, spec_sharding, out = _mesh_specs(mesh, batched=False)

    def fn(key, lk_tab, val_tab, sig_grid, gram, pos, scales, values,
           weights, sm):
        if from_seed:
            key = jax.random.key(key)
        axis_geom = _axis_geometry(shape, spacing, dtype)
        se2 = _sigma_eff2_global(
            shape, spacing, lk_tab, val_tab, log_values, dtype, sm,
            sigmas=sig_grid,
        )
        if mean_only:
            alpha = jnp.linalg.solve(gram, values)
            c = _correction_global(
                se2, alpha, pos, scales, axis_geom, n_constraints
            )
        else:
            c = _sampled_spectrum(
                key, lk_tab, val_tab, sm, shape, spacing, mesh, False,
                log_values, dtype, sigmas=sig_grid,
            )
            gamma = _gamma_global(c, pos, scales, axis_geom, n_constraints)
            alpha = jnp.linalg.solve(gram, values - gamma)
            c = c + _correction_global(
                se2, alpha, pos, scales, axis_geom, n_constraints
            )
        c = jax.lax.with_sharding_constraint(c, spec_sharding)
        delta = _inverse(c, shape, mesh, False)
        return delta * weights[None, None, :]

    return jax.jit(fn, out_shardings=out)


@functools.lru_cache(maxsize=32)
def make_sharded_constraint_gram(mesh, shape, spacing, n_constraints,
                                 log_values=False, dtype_name="float32"):
    """Compile the mesh-native Gram matrix: M(M+1)/2 sharded reductions."""
    dtype = jnp.dtype(dtype_name)

    def fn(lk_tab, val_tab, sig_grid, pos, scales, sm):
        axis_geom = _axis_geometry(shape, spacing, dtype)
        mult = axis_geom[-1][None, None, :]
        w = mult * _sigma_eff2_global(
            shape, spacing, lk_tab, val_tab, log_values, dtype, sm,
            sigmas=sig_grid,
        )
        rows = [[None] * n_constraints for _ in range(n_constraints)]
        for i in range(n_constraints):
            kri, kii = _kernel_m(i, pos, scales, axis_geom)
            for j in range(i, n_constraints):
                krj, kij = _kernel_m(j, pos, scales, axis_geom)
                v = jnp.sum(w * (kri * krj + kii * kij))
                rows[i][j] = rows[j][i] = v
        return jnp.stack([jnp.stack(r) for r in rows])

    return jax.jit(fn)


def _forward_mesh(delta, shape, mesh, dtype):
    """Distributed forward transform in engine (norm='forward') units."""
    from randomfield_tpu.parallel import dfft
    from randomfield_tpu.parallel import pencil as _pencil

    if _pencil.is_pencil_mesh(mesh):
        c = _pencil.rfftn_pencil(delta, shape, mesh)
    else:
        c = dfft.rfftn_slab(delta, shape, mesh)
    n_cells = shape[0] * shape[1] * shape[2]
    return c / jnp.asarray(n_cells, dtype)


@functools.lru_cache(maxsize=32)
def make_sharded_measure(mesh, shape, spacing, n_constraints,
                         dtype_name="float32"):
    """Compile Gamma[field] on a mesh: distributed forward + reductions."""
    dtype = jnp.dtype(dtype_name)

    def fn(delta, pos, scales):
        c = _forward_mesh(delta, shape, mesh, dtype)
        axis_geom = _axis_geometry(shape, spacing, dtype)
        return _gamma_global(c, pos, scales, axis_geom, n_constraints)

    return jax.jit(fn)


def _noise_nvar_global(noise_a, noise_b, tabulated, shape, spacing, dtype):
    """Per-packed-mode noise variance P_n(|k|)/V as a global expression.

    Scalar white noise: ``noise_a`` is the already-volume-normalized
    variance P_n/V (``noise_b`` ignored).  Tabulated: ``(noise_a,
    noise_b) = (log10 k, P_n)`` interpolated in log10(k) exactly like
    :func:`_noise_var_grid`'s single-device path — built from broadcast
    1-D vectors so each device materializes only its shard.
    """
    if not tabulated:
        return jnp.asarray(noise_a, dtype)
    nx, ny, nz = shape
    volume = nx * ny * nz * float(spacing) ** 3
    kmag = jnp.sqrt(_grid.ksq(shape, spacing, dtype))
    pn = _power._interp_traced(kmag, noise_a, noise_b, False)
    return pn / jnp.asarray(volume, dtype)


@functools.lru_cache(maxsize=32)
def make_sharded_wiener(mesh, shape, spacing, noise_tabulated=False,
                        log_values=False, dtype_name="float32"):
    """Compile a mesh-native Wiener reconstruction.

    fn(data, lk_tab, val_tab, noise_a, noise_b) -> WF(data), sharded
    like the plain mesh render: distributed forward transform, the
    elementwise sigma^2/(sigma^2 + P_n/V) filter evaluated inline from
    the power table (no sigma grid anywhere), distributed inverse.
    """
    from randomfield_tpu.parallel.render import _inverse, _mesh_specs

    dtype = jnp.dtype(dtype_name)
    _, spec_sharding, out = _mesh_specs(mesh, batched=False)

    def fn(data, lk_tab, val_tab, sig_grid, noise_a, noise_b):
        c = _forward_mesh(data, shape, mesh, dtype)
        sig = sig_grid if sig_grid is not None else _power.sigma_inline(
            shape, spacing, lk_tab, val_tab, log_values, dtype, layout="xyz"
        )
        nvar = _noise_nvar_global(
            noise_a, noise_b, noise_tabulated, shape, spacing, dtype
        )
        c = (c * _wiener_weight(sig, nvar)).astype(c.dtype)
        c = jax.lax.with_sharding_constraint(c, spec_sharding)
        return _inverse(c, shape, mesh, False)

    return jax.jit(fn, out_shardings=out)


@functools.lru_cache(maxsize=32)
def make_sharded_posterior(mesh, shape, spacing, from_seed=False,
                           noise_tabulated=False, log_values=False,
                           dtype_name="float32"):
    """Compile a mesh-native posterior sample of P(field | data).

    Same construction as :func:`_posterior_jit` — ``delta_r +
    WF(data - delta_r - n_r)`` — with the prior draw shared with the
    sharded render (identical Threefry values per logical index, so the
    mesh posterior equals the single-device one for the same seed), the
    noise draw symmetrized the same way, and both transforms
    distributed.
    """
    from randomfield_tpu.parallel.render import (
        _inverse, _mesh_specs, _sampled_spectrum,
    )

    dtype = jnp.dtype(dtype_name)
    nx, ny, nz = shape
    draws_sharding, spec_sharding, out = _mesh_specs(mesh, batched=False)

    def fn(key, data, lk_tab, val_tab, sig_grid, noise_a, noise_b):
        if from_seed:
            key = jax.random.key(key)
        k_s, k_n = jax.random.split(key)
        c_r = _sampled_spectrum(
            k_s, lk_tab, val_tab, jnp.zeros((), dtype), shape, spacing,
            mesh, False, log_values, dtype, sigmas=sig_grid,
        )
        # canonical chunked stream (ops/sample.py:unit_draws) — the same
        # noise realization the single-device _posterior_jit draws via
        # sample_spectrum, so mesh and single-device posteriors agree
        draws = _sample.unit_draws(k_n, shape, dtype)
        draws = jax.lax.with_sharding_constraint(draws, draws_sharding)
        z = jax.lax.complex(draws[0], draws[1]) * jnp.asarray(
            0.7071067811865476, dtype
        )
        z = _transform.symmetrize_with_shape(
            z, nz=nz, scale_self_conjugate=True
        )
        nvar = _noise_nvar_global(
            noise_a, noise_b, noise_tabulated, shape, spacing, dtype
        )
        c_n = z * jnp.sqrt(nvar).astype(dtype)
        c_d = _forward_mesh(data, shape, mesh, dtype)
        sig = sig_grid if sig_grid is not None else _power.sigma_inline(
            shape, spacing, lk_tab, val_tab, log_values, dtype, layout="xyz"
        )
        w = _wiener_weight(sig, nvar).astype(c_d.dtype)
        c = c_r + w * (c_d - c_r - c_n)
        c = jax.lax.with_sharding_constraint(c, spec_sharding)
        return _inverse(c, shape, mesh, False)

    return jax.jit(fn, out_shardings=out)


@functools.lru_cache(maxsize=32)
def make_sharded_posterior_mse(mesh, shape, spacing, noise_tabulated=False,
                               log_values=False, dtype_name="float32"):
    """Compile the exact Wiener-MSE prediction as a sharded reduction.

    Same per-mode conditional-variance sum as
    :func:`predicted_posterior_mse`, evaluated inline from the table
    (no sigma grid) with Hermitian kz multiplicity; the global sum
    lowers to an XLA psum over the spatial mesh axes.
    """
    dtype = jnp.dtype(dtype_name)
    nzh = shape[2] // 2 + 1
    mult = np.full(nzh, 2.0)
    mult[0] = 1.0
    if shape[2] % 2 == 0:
        mult[-1] = 1.0

    def fn(lk_tab, val_tab, sig_grid, noise_a, noise_b):
        sig = sig_grid if sig_grid is not None else _power.sigma_inline(
            shape, spacing, lk_tab, val_tab, log_values, dtype, layout="xyz"
        )
        s2 = sig * sig
        nvar = jnp.broadcast_to(
            _noise_nvar_global(
                noise_a, noise_b, noise_tabulated, shape, spacing, dtype
            ),
            s2.shape,
        )
        denom = s2 + nvar
        cond = s2 * nvar / jnp.where(denom > 0, denom, 1.0)
        return jnp.sum(jnp.asarray(mult, dtype)[None, None, :] * cond)

    return jax.jit(fn)


# --------------------------------------------------------------------------
# Wiener filtering / posterior sampling for full-grid noisy data
# --------------------------------------------------------------------------

def _noise_var_grid(noise_power, shape, spacing, dtype):
    """Per-packed-mode noise variance P_n(|k|) / V in engine units.

    ``noise_power`` — physical noise power (length^3 units): a scalar for
    white noise (per-voxel std s <=> noise_power = s^2 spacing^3), or a
    tabulated (k, P_n) table interpolated like the signal spectrum.
    """
    nx, ny, nz = shape
    volume = nx * ny * nz * float(spacing) ** 3
    if np.isscalar(noise_power) or getattr(noise_power, "ndim", 1) == 0:
        return jnp.asarray(float(noise_power) / volume, dtype)
    table = _power.validate_power(noise_power)
    kmag = _grid.kmag(shape, spacing, dtype)
    pn = _power.interpolate_power(table, kmag, "log10k", dtype)
    return pn / jnp.asarray(volume, dtype)


def _wiener_weight(sigmas, nvar):
    """sigma^2 / (sigma^2 + P_n/V), 0 at degenerate (both-zero) modes —
    the DC mode has sigma = 0 (zero-mean prior), so it is always zeroed."""
    s2 = sigmas * sigmas
    denom = s2 + nvar
    return jnp.where(denom > 0, s2 / jnp.where(denom > 0, denom, 1.0), 0.0)


@functools.partial(jax.jit, static_argnames=("shape", "spacing"))
def _wiener_jit(data, sigmas, nvar, shape, spacing):
    c = _transform.rfftn(data, norm="forward")
    c = (c * _wiener_weight(sigmas, nvar)).astype(c.dtype)
    return _transform.irfftn(c, shape, norm="forward")


@functools.partial(jax.jit, static_argnames=("shape", "spacing"))
def _posterior_jit(key, data, sigmas, nvar, shape, spacing):
    """delta_r + WF(data - delta_r - n_r): exact sample of P(field | data).

    The standard constrained-realization-with-noise construction: render
    an unconstrained prior sample delta_r and a noise sample n_r, then add
    the Wiener reconstruction of the mock data mismatch.  Linearity makes
    the result Gaussian with exactly the posterior mean and covariance.
    """
    k_s, k_n = jax.random.split(key)
    c_r = _sample.sample_spectrum(k_s, sigmas, shape)
    noise_sig = jnp.broadcast_to(
        jnp.sqrt(nvar).astype(sigmas.dtype), sigmas.shape
    )
    c_n = _sample.sample_spectrum(k_n, noise_sig, shape)
    c_d = _transform.rfftn(data, norm="forward")
    w = _wiener_weight(sigmas, nvar).astype(c_d.dtype)
    c = c_r + w * (c_d - c_r - c_n)
    return _transform.irfftn(c, shape, norm="forward")


def wiener_filter(data, sigmas, noise_power, shape, spacing):
    """Wiener-filtered (minimum-variance) field reconstruction.

    ``data = field + noise`` on the full grid; per mode the filter is
    ``sigma^2 / (sigma^2 + P_n/V)``.  ``noise_power = 0`` returns the data
    unchanged (up to transform rounding).
    """
    nvar = _noise_var_grid(noise_power, shape, spacing, sigmas.dtype)
    return _wiener_jit(
        jnp.asarray(data, sigmas.dtype), sigmas, nvar, shape, spacing
    )


def posterior_render(key, data, sigmas, noise_power, shape, spacing):
    """One exact posterior sample of the field given full-grid noisy data."""
    nvar = _noise_var_grid(noise_power, shape, spacing, sigmas.dtype)
    return _posterior_jit(
        key, jnp.asarray(data, sigmas.dtype), sigmas, nvar, shape, spacing
    )


def predicted_posterior_mse(sigmas, noise_power, shape, spacing, nz=None):
    """Exact expected field-mean square error of the Wiener reconstruction.

    E[ mean_x (WF(data) - field)^2 ] = sum_packed m_k * sigma_k^2 *
    (P_n/V) / (sigma_k^2 + P_n/V) — the per-mode conditional variance
    summed with Hermitian multiplicity.  A posterior SAMPLE doubles this
    (independent conditional scatter of the sample and of the truth).
    """
    nvar = _noise_var_grid(noise_power, shape, spacing, sigmas.dtype)
    nzh = shape[2] // 2 + 1
    mult = np.full(nzh, 2.0)
    mult[0] = 1.0
    if shape[2] % 2 == 0:
        mult[-1] = 1.0
    s2 = np.asarray(sigmas, np.float64) ** 2
    nv = np.broadcast_to(np.asarray(nvar, np.float64), s2.shape)
    cond = s2 * nv / np.where(s2 + nv > 0, s2 + nv, 1.0)
    return float(np.sum(mult[None, None, :] * cond))
