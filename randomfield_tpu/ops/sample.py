"""Hermitian-symmetric Gaussian mode sampling of packed half-spectra.

Reference parity: the mode sampler inside ``randomfield/generate.py``
(seeded ``np.random.RandomState(seed).normal(scale=sigmas)`` over the
packed buffer, then ``transform.symmetrize`` — SURVEY.md section 3.2 hot
loop #1).

Design:

* ``jax.random`` counter-based Threefry keys replace the sequential
  Mersenne state.  JAX's partitionable threefry makes ``normal(key,
  global_shape)`` produce *the same values per logical index regardless of
  sharding*, so sharded sampling is deterministic and identical to
  single-device sampling for free — no per-shard key bookkeeping.
* Unit-variance Hermitian noise is sampled first and scaled by the
  precomputed sigma(k) grid afterwards; sigma is symmetric under k -> -k,
  so scaling commutes with symmetrization and XLA fuses draw + scale +
  filter into one pass over the spectrum.
* The Hermitian fixup touches only the kz = 0 / Nyquist planes (O(N^2));
  under spatial sharding XLA lowers the plane flips to small collective
  permutes — no hand-written communication.

XLA fuses the draws, the sigma scale and the filter into the programs
that consume them; no hand-written sampling kernel is needed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from randomfield_tpu.ops import grid as _grid
from randomfield_tpu.ops import transform as _transform

__all__ = ["sample_unit_hermitian", "sample_spectrum",
           "sample_fixed_spectrum", "sample_unit_hermitian_nested",
           "sample_spectrum_nested", "nested_unit_draws", "unit_draws",
           "canonical_chunks", "NESTED_MAX_DIM"]

_INV_SQRT2 = 0.7071067811865476

# x-slab chunk target of the canonical Threefry stream (see unit_draws)
CANONICAL_CHUNK_TARGET = 16


def canonical_chunks(nx: int) -> int:
    """Chunk count of the canonical stream: largest divisor of nx <= 16.

    The ONE definition both the staged pipeline's chunked sampling stage
    (engine/staged.py:_stage_p1) and :func:`unit_draws` share — the
    realization family is pinned by it, so it must never diverge between
    them.
    """
    for c in range(min(CANONICAL_CHUNK_TARGET, nx), 0, -1):
        if nx % c == 0:
            return c
    return 1


def unit_draws(key, shape, dtype=jnp.float32):
    """The canonical Threefry unit-normal draws, fused (2, nx, ny, nzh).

    One realization family for every Threefry pipeline (round-4 change;
    the round-3 fused pipeline drew ``normal(key, (2, nx, ny, nzh))``
    positionally, a DIFFERENT family from the staged pipeline's chunked
    (x, kz, y) stream, so ``pipeline='auto'`` silently changed families
    at the staged threshold).  The canonical stream is the staged one —
    the only one computable at the HBM ceiling, where a single full-size
    ``normal`` call cannot be materialized:

        chunk i of nx/chunks x-planes draws
        ``normal(fold_in(key, i), (2, cx, nzh, ny))``   (x, kz, y) order

    and this helper transposes those draws into the fused engine's
    (2, nx, ny, nzh) contract.  Mode (kx, ky, kz) receives the same
    draw in every pipeline; fused/staged/mesh renders of one seed are
    the same realization (to f32 rounding — sigma scaling and
    symmetrization are applied in different orders).
    """
    re, im = unit_draws_reim(key, shape, dtype)
    return jnp.stack([re, im])


def unit_draws_reim(key, shape, dtype=jnp.float32):
    """:func:`unit_draws` as separate (nx, ny, nzh) re/im arrays.

    Identical values; the stacked (2, ...) array and its two full-size
    transposes are never materialized — each chunk's (kz, y) -> (y, kz)
    swap happens on the small chunk and the chunk axis merges into x by
    a plain reshape.  At 1024^3 this is the difference between ~17 GB
    of draw intermediates (OOM on a 16 GB chip) and the 4.2 GB the two
    lattices themselves occupy (the 1-device-mesh render case).
    """
    nx, ny, nz = shape
    nzh = nz // 2 + 1
    chunks = canonical_chunks(nx)
    cx = nx // chunks

    def one(i):
        d = jax.random.normal(
            jax.random.fold_in(key, i), (2, cx, nzh, ny), dtype
        )
        d = jnp.transpose(d, (0, 1, 3, 2))  # (2, cx, ny, nzh)
        return d[0], d[1]

    idx = jnp.arange(chunks, dtype=jnp.uint32)
    re, im = jax.lax.map(one, idx)  # 2 x (chunks, cx, ny, nzh)
    return re.reshape(nx, ny, nzh), im.reshape(nx, ny, nzh)

# Per-axis size bound of the nested sampler: signed lattice indices are
# packed into 10-bit two's-complement fields of a 30-bit counter word,
# so each axis must satisfy |index| < 512, i.e. n <= 1024.
NESTED_MAX_DIM = 1024


def sample_unit_hermitian(key, shape, dtype=jnp.complex64):
    """Unit-variance Hermitian complex noise on the packed half-spectrum.

    Each packed mode is (x + i y) / sqrt(2) with x, y ~ N(0, 1), giving
    <|z|^2> = 1; the self-conjugate kz planes are then symmetrized so the
    inverse c2r transform of the result is exactly real, with the
    self-conjugate modes real-valued at full (unit) variance.  Draws come
    from the canonical chunked stream (:func:`unit_draws`) shared with
    the staged pipeline.
    """
    real_dtype = jnp.finfo(dtype).dtype
    nz = shape[2]
    draws = unit_draws(key, shape, real_dtype)
    z = jax.lax.complex(draws[0], draws[1]) * jnp.asarray(_INV_SQRT2, real_dtype)
    return _transform.symmetrize_with_shape(z, nz=nz, scale_self_conjugate=True)


def sample_spectrum(key, sigmas, shape):
    """Draw a packed spectrum c_k with per-mode std sigma(k).

    With sigma from :func:`randomfield_tpu.ops.power.tabulate_sigmas`
    (which folds 1/V), ``irfftn(c, norm='forward')`` of the result is a
    real Gaussian field with power spectrum P(k).
    """
    noise = sample_unit_hermitian(key, shape)
    return noise * sigmas.astype(noise.real.dtype)


def _lattice_codes(shape, dtype=jnp.uint32):
    """Resolution-independent 30-bit code per packed mode (device iota).

    Each mode's SIGNED integer lattice indices (sx, sy, sz) — the
    physical wavenumbers in units of each axis' fundamental — are packed
    as 10-bit two's-complement fields: grids of different size over the
    same box assign every shared mode the same code.
    """
    nx, ny, nz = shape
    nzh = nz // 2 + 1
    if max(nx, ny, nz) > NESTED_MAX_DIM:
        raise ValueError(
            f"nested sampling packs signed indices into 10 bits per "
            f"axis: max dim is {NESTED_MAX_DIM}, got {shape}"
        )
    ix = jax.lax.broadcasted_iota(jnp.int32, (nx, ny, nzh), 0)
    iy = jax.lax.broadcasted_iota(jnp.int32, (nx, ny, nzh), 1)
    iz = jax.lax.broadcasted_iota(jnp.int32, (nx, ny, nzh), 2)
    sx = jnp.where(ix < (nx + 1) // 2, ix, ix - nx) & 1023
    sy = jnp.where(iy < (ny + 1) // 2, iy, iy - ny) & 1023
    code = (sx << 20) | (sy << 10) | iz
    return code.astype(dtype)


def sample_unit_hermitian_nested(key, shape, dtype=jnp.complex64):
    """Resolution-NESTED unit Hermitian noise on the packed half-spectrum.

    Same statistics as :func:`sample_unit_hermitian`, but each mode's
    draw is a pure function of the seed and the mode's signed integer
    lattice indices (kx, ky, kz in fundamental units) instead of its
    position in the packed array.  Grids of different size over the SAME
    physical box therefore share every common mode's draw exactly —
    rendering at 2x the resolution refines a realization without
    changing its large-scale modes (zoom / resolution-matched initial
    conditions).  Modes at or above a coarse grid's Nyquist are new at
    the finer size (the coarse Nyquist plane is self-conjugate there and
    regular at 2x, so it cannot be shared).  Its stream is distinct from
    the positional Threefry stream by construction.

    Per-mode bits come from one raw ``threefry_2x32`` call whose 2x32
    counter words are (lattice code, 0) — the first half of the count
    array carries the codes, the second half zeros, so each block's two
    32-bit outputs are the mode's two uniforms (threefry_2x32 pairs
    count[i] with count[i + N/2]; feeding a bare code array would make
    draws depend on array SIZE, not just the mode).  Box-Muller turns
    them into the two unit normals; the standard symmetrization then
    enforces Hermitian pairs.  The canonical-member choice of
    :func:`randomfield_tpu.ops.grid.hermitian_plane_masks` depends only
    on index SIGNS for sub-Nyquist modes, so it is itself
    resolution-independent — shared self-conjugate-plane pairs resolve
    to the same draw at every size.
    """
    real_dtype = jnp.finfo(dtype).dtype
    nz = shape[2]
    draws = nested_unit_draws(key, shape, real_dtype)
    z = jax.lax.complex(draws[0], draws[1]) * jnp.asarray(
        _INV_SQRT2, real_dtype
    )
    return _transform.symmetrize_with_shape(z, nz=nz, scale_self_conjugate=True)


def nested_unit_draws(key, shape, dtype=jnp.float32):
    """The nested stream's raw unit normals, shape (2, nx, ny, nzh).

    Pre-symmetrization/pre-1/sqrt(2) — the same contract as the
    positional ``jax.random.normal(key, (2, ...))`` draws the fused
    engine consumes, so ``render_from_noise`` reproduces the nested
    render exactly (noise export / IC interchange).
    """
    from jax.extend.random import threefry_2x32

    code = _lattice_codes(shape)
    kd = jax.random.key_data(key).astype(jnp.uint32).reshape(2)
    flat = code.reshape(-1)
    out = threefry_2x32(
        kd, jnp.concatenate([flat, jnp.zeros_like(flat)])
    )
    bits1 = out[: flat.shape[0]].reshape(code.shape)
    bits2 = out[flat.shape[0]:].reshape(code.shape)
    # uniforms in (0, 1): 24 high bits + half-ulp offset
    scale = jnp.asarray(2.0**-24, dtype)
    half = jnp.asarray(2.0**-25, dtype)
    u1 = (bits1 >> 8).astype(dtype) * scale + half
    u2 = (bits2 >> 8).astype(dtype) * scale + half
    r = jnp.sqrt(-2.0 * jnp.log(u1))
    theta = jnp.asarray(2.0 * np.pi, dtype) * u2
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)])


def sample_spectrum_nested(key, sigmas, shape):
    """Nested-noise variant of :func:`sample_spectrum` (zoom-matched)."""
    noise = sample_unit_hermitian_nested(key, shape)
    return noise * sigmas.astype(noise.real.dtype)


def sample_fixed_spectrum(key, sigmas, shape, flip=False, nested=False):
    """Variance-suppressed 'fixed' spectrum: |c_k| = sigma(k) EXACTLY.

    Angulo & Pontzen (2016) fixed fields: normalize the Hermitian
    Gaussian draw per mode to unit magnitude, keeping only its (uniform)
    phase, then scale by sigma — every realization carries exactly the
    target per-mode power, removing the leading cosmic-variance term
    from ensemble statistics while leaving phase statistics untouched.
    Self-conjugate modes (real after symmetrization) reduce to a random
    sign, the correct degenerate case.  ``flip=True`` returns the PAIRED
    realization (all phases shifted by pi — for Gaussian fields just the
    negation, but nonlinear descendants such as lognormal mocks or
    displaced catalogs differ nontrivially, which is the point of
    'fixed & paired' ensembles).  ``nested=True`` draws the phases from
    the resolution-nested stream (:func:`sample_unit_hermitian_nested`).
    """
    noise = (sample_unit_hermitian_nested if nested
             else sample_unit_hermitian)(key, shape)
    mag = jnp.abs(noise)
    phase = jnp.where(mag > 0, noise / jnp.where(mag > 0, mag, 1.0), 1.0)
    if flip:
        phase = -phase
    return phase * sigmas.astype(noise.real.dtype)
