"""Staged render: the inverse transform split into separately jitted,
donated programs, for grids whose single fused program does not fit one
device's memory.

The monolithic render (engine/generator.py:render) lets XLA schedule
sampling, the 3-D inverse FFT and the weighting in one program, whose
simultaneous temporaries grow to several field-sized buffers.  This
pipeline bounds the peak to two full-size arrays plus one chunk-size
temporary:

    P1  sample + sigma-scale + Gaussian filter, chunked over x-slabs,
        in (x, kz, y) layout                                  -> c
    P2  complex ifft along x (donates c)                      -> c
    P3  complex ifft along y, back to x-major (donates c)     -> c
    P4  per x-slab: c2r along kz + lightcone weighting +
        transpose to (x, y, z), sequenced by lax.map          -> field

This is the single-device analog of the reference's in-place pyfftw
plan (randomfield/transform.py:Plan); XLA buffer donation plays the part
of FFTW's in-place transforms.  :func:`pick_pipeline` chooses between
the two from the device's allocatable memory.

The staged pipeline's chunked (x, kz, y) draw order IS the canonical
Threefry stream (ops/sample.py:unit_draws): the fused and mesh pipelines
draw the same chunked stream and transpose, so one seed is one
realization on every Threefry pipeline (equal to f32 rounding — sigma
scaling and symmetrization apply in different orders).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp

from randomfield_tpu.ops import grid as _grid
from randomfield_tpu.ops import transform as _transform
from randomfield_tpu.utils import device as _device

__all__ = ["staged_render", "finish_staged", "pick_pipeline",
           "AUTO_STAGED_THRESHOLD", "FUSED_BYTES_PER_CELL"]

_INV_SQRT2 = 0.7071067811865476

# where the device reports no memory limit (the CPU backend), grids with
# more cells than this render staged under pipeline='auto'
AUTO_STAGED_THRESHOLD = 256 * 1024 * 1024

# device bytes per grid cell that pipeline='auto' budgets for a fused
# float32 render: 12.02 measured by XLA's memory_analysis() of the
# 1024^3 program (engine/generator.py:render) on an H100 — 2 GiB sigma
# argument + 4 GiB field output + 6.02 GiB temporaries (PERF.md
# "Bring-up findings") — plus 4 for one earlier field the caller
# still holds
FUSED_BYTES_PER_CELL = 16


def _pick_chunks(n: int, target: int = 8) -> int:
    """Largest divisor of n that is <= target."""
    for c in range(min(target, n), 0, -1):
        if n % c == 0:
            return c
    return 1


@functools.lru_cache(maxsize=16)
def _stage_p1(shape, spacing, dtype_name):
    """Sampling stage: unit Hermitian noise * sigma * filter, (x, kz, y).

    Shared by the v1 and v2 pipelines so both render the SAME
    realization for a given seed (the staged stream is defined by this
    stage alone).
    """
    from randomfield_tpu.ops.sample import canonical_chunks

    nx, ny, nz = shape
    nzh = nz // 2 + 1
    dtype = jnp.dtype(dtype_name)
    # the ONE chunk definition shared with ops/sample.py:unit_draws —
    # this stage defines the canonical Threefry realization family
    chunks = canonical_chunks(nx)
    planes = _grid.self_conjugate_kz_planes(nz)

    @jax.jit
    def p1(key, sigmas_xzy, smoothing_length, kx, kz, ky):
        # sample + sigma-scale + filter, fully chunked over x-slabs: the
        # only full-size buffer is the output spectrum.  Each slab draws
        # from its own fold_in-derived key (the staged pipeline's stream;
        # deterministic per (seed, shape), distinct from the fused path).
        # k vectors arrive as runtime args: baking k^2 in as a constant
        # would embed a full-grid array in the executable (resident HBM).
        s = jnp.asarray(smoothing_length, dtype)
        cx = nx // chunks
        kx_c = kx.reshape(chunks, cx)
        sig_c = sigmas_xzy.reshape(chunks, cx, nzh, ny)

        def one(args):
            i, kxs, sig = args
            draws = jax.random.normal(
                jax.random.fold_in(key, i), (2, cx, nzh, ny), dtype
            )
            z = jax.lax.complex(draws[0], draws[1]) * jnp.asarray(
                _INV_SQRT2, dtype
            )
            k2 = (
                (kxs * kxs)[:, None, None]
                + (kz * kz)[None, :, None]
                + (ky * ky)[None, None, :]
            )
            return z * (sig * jnp.exp(-0.5 * k2 * s * s)).astype(dtype)

        idx = jnp.arange(chunks, dtype=jnp.uint32)
        c = jax.lax.map(one, (idx, kx_c, sig_c)).reshape(nx, nzh, ny)
        # Hermitian fixup of the self-conjugate kz planes (cross-slab
        # conjugate pairs regenerate cheaply at O(N^2))
        for p in planes:
            fixed = _transform._symmetrize_plane(c[:, p, :], True)
            c = c.at[:, p, :].set(fixed)
        return c

    return p1


def _tail_chunks(shape) -> int:
    """x-slab count of the c2r tail (P4), from the device's memory.

    Each chunk's complex slab is held to 1/256 of the allocatable bytes
    (the rate at which a 1024^3 tail fits a 16 GB device in 64 chunks),
    and never fewer than 8 chunks.  Devices that report no limit keep the
    fixed rule: 64 chunks above :data:`AUTO_STAGED_THRESHOLD`, else 8.
    """
    nx, ny, nz = shape
    limit = _device.bytes_limit()
    if limit is None:
        target = 64 if nx * ny * nz > AUTO_STAGED_THRESHOLD else 8
    else:
        spectrum = 8 * nx * ny * (nz // 2 + 1)
        target = max(8, -(-spectrum * 256 // limit))
    return _pick_chunks(nx, target)


@functools.lru_cache(maxsize=16)
def _stages(shape, spacing, dtype_name):
    nx, ny, nz = shape
    nzh = nz // 2 + 1
    tail_chunks = _tail_chunks(shape)

    p1 = _stage_p1(shape, spacing, dtype_name)

    _B = jax.lax.optimization_barrier

    @functools.partial(jax.jit, donate_argnums=0)
    def p2(c):
        # ifft along x on the minor axis of a barrier-pinned transpose
        t = _B(jnp.transpose(c, (1, 2, 0)))  # (nzh, ny, nx)
        return _transform.ifft_minor(t)

    @functools.partial(jax.jit, donate_argnums=0)
    def p3(a):
        # ifft along y, then restore the x-major order the tail maps over
        t = _B(jnp.transpose(a, (0, 2, 1)))  # (nzh, nx, ny)
        t = _transform.ifft_minor(t)
        return _B(jnp.transpose(t, (1, 0, 2)))  # (nx, nzh, ny)

    @functools.partial(jax.jit, donate_argnums=0)
    def p4(c, weights):
        # per x-slab: c2r along kz on the minor axis (the spectrum went
        # through the Hermitian fixup in P1) + lightcone weighting;
        # lax.map sequences the chunk temporaries
        ck = c.reshape(tail_chunks, nx // tail_chunks, nzh, ny)

        def one(chunk):
            t = _B(jnp.transpose(chunk, (0, 2, 1)))  # (cx, ny, nzh)
            f = _transform.irfft_minor(t, nz, assume_hermitian=True)
            return f * weights[None, None, :]

        return jax.lax.map(one, ck).reshape(nx, ny, nz)

    return p1, p2, p3, p4


def _can_v2(shape) -> bool:
    """v2 needs composite nx/ny and an even nz with composite nz/2."""
    from randomfield_tpu.ops.ctfft import can_ct

    nx, ny, nz = shape
    return (
        can_ct(nx) and can_ct(ny) and nz % 2 == 0
        and (nz // 2 == 1 or can_ct(nz // 2))
    )


def _pipeline_version(shape) -> str:
    """'v1' (library c2r tail, the default: faster on the H100, PERF.md
    "Bring-up findings") or 'v2' (half-length einsum pack) when
    ``RF_STAGED_PIPELINE=v2`` asks for it on a shape that allows it."""
    if os.environ.get("RF_STAGED_PIPELINE", "") == "v2" and _can_v2(tuple(shape)):
        return "v2"
    return "v1"


@functools.lru_cache(maxsize=16)
def _stages_v2(shape, spacing, dtype_name):
    """v2 = v1 with the c2r tail as the half-length pack along kz.

    p4's c2r runs per x-slab as the half-length complex pack
    (ops/ctfft.py:irfft_half_axis) directly on the (x, kz, y) chunk: an
    nz/2-point Cooley-Tukey einsum inverse replaces v1's transpose +
    minor-axis c2r, inside the same chunked lax.map program shape.
    """
    from randomfield_tpu.ops import ctfft

    nx, ny, nz = shape
    nzh = nz // 2 + 1
    tail_chunks = _tail_chunks(shape)
    _Bar = jax.lax.optimization_barrier

    _, p2, p3, _ = _stages(shape, spacing, dtype_name)

    @jax.jit
    def p4(c, weights):
        # no donate: a real output cannot alias a complex input, and
        # marking it only emits the XLA "not usable" warning
        ck = c.reshape(tail_chunks, nx // tail_chunks, nzh, ny)

        def one(chunk):
            f = ctfft.irfft_half_axis(chunk, nz, 1)  # (cx, nz, ny) real
            f = _Bar(jnp.transpose(f, (0, 2, 1)))    # (cx, ny, nz)
            return f * weights[None, None, :]

        return jax.lax.map(one, ck).reshape(nx, ny, nz)

    return p2, p3, p4


def finish_staged(c, weights, shape, spacing, dtype_name):
    """Inverse-transform + weight a sampled (nx, nzh, ny) spectrum.

    The post-sampling half of the staged pipeline, shared by
    :func:`staged_render` and the derived-field renders
    (engine/generator.py).  Blocks between programs: async dispatch lets
    consecutive programs' allocations overlap, and near the memory
    ceiling that union fails even though each stage fits on its own.
    """
    shape = tuple(shape)
    if _pipeline_version(shape) == "v2":
        p2, p3, p4 = _stages_v2(shape, float(spacing), dtype_name)
    else:
        _, p2, p3, p4 = _stages(shape, float(spacing), dtype_name)
    c.block_until_ready()
    c = p2(c)
    c.block_until_ready()
    c = p3(c)
    c.block_until_ready()
    return p4(c, weights)


def staged_render(key, sigmas_xzy, weights, smoothing_length, shape, spacing):
    """Render one realization through the staged donated pipeline.

    ``sigmas_xzy`` must be in (nx, nzh, ny) layout
    (``tabulate_sigmas(..., layout='xzy')``).
    """
    shape = tuple(shape)
    dtype_name = str(sigmas_xzy.dtype)
    kx, ky, kz = _grid.kvectors(shape, float(spacing), sigmas_xzy.dtype)
    p1 = _stage_p1(shape, float(spacing), dtype_name)
    c = p1(key, sigmas_xzy, smoothing_length, kx, kz, ky)
    return finish_staged(c, weights, shape, spacing, dtype_name)


def pick_pipeline(shape, pipeline: str) -> str:
    """'fused' or 'staged' for ``pipeline='auto'``; validates the rest.

    'auto' renders fused when :data:`FUSED_BYTES_PER_CELL` times the
    cell count fits the device's allocatable bytes and the field stays
    within the library inverse FFT's element limit
    (ops/transform.py:MAX_FFT_ELEMENTS, where that factor was measured),
    else staged.  A device that reports no limit (the CPU) uses
    :data:`AUTO_STAGED_THRESHOLD` instead.
    """
    if pipeline == "auto":
        n = shape[0] * shape[1] * shape[2]
        limit = _device.bytes_limit()
        if limit is None:
            return "staged" if n > AUTO_STAGED_THRESHOLD else "fused"
        fits = (n * FUSED_BYTES_PER_CELL <= limit
                and n <= _transform.MAX_FFT_ELEMENTS)
        return "fused" if fits else "staged"
    if pipeline not in ("fused", "staged"):
        raise ValueError(f"unknown pipeline {pipeline!r}")
    return pipeline
