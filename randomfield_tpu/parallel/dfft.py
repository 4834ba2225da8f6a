"""Distributed packed FFTs: slab decomposition + all-to-all transposes.

The replacement for the reference's pyfftw plans at scales beyond one
device's memory (SURVEY.md section 5, "long-context analog"; the AccFFT
slab pattern, PAPERS.md).  One transpose per direction:

inverse (k -> x), input sharded along ky over the 'space' axis:

    1. local complex ifft along x        (x is unsharded in k-layout)
    2. all_to_all: reshard ky-slabs -> x-slabs  (THE collective)
    3. local complex ifft along y        (y now unsharded)
    4. local c2r irfft along z           (z always unsharded)

    output: real field sharded along x.

forward (x -> k) is the exact reverse; both use ``shard_map`` so XLA can
never silently fall back to an all-gather (SURVEY.md hard part #1 — with
pjit alone the FFT op would gather the full grid onto every chip).

The c2r axis (z) is deliberately never sharded: packing/unpacking the
Hermitian half-spectrum stays local, and the all-to-all moves the packed
(half) representation — half the bytes of a full complex cube.

Correctness of the unnormalized-inverse convention: ``norm='forward'``
sub-transforms compose into exactly ``irfftn(c, norm='forward')``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from randomfield_tpu.ops import transform as _transform
from randomfield_tpu.parallel.mesh import DATA_AXIS, SPACE_AXIS

__all__ = ["irfftn_slab", "rfftn_slab"]

_B = jax.lax.optimization_barrier


def _ifft_axis(x, axis):
    """Local unnormalized inverse FFT along ``axis`` via the minor axis
    (a barrier-pinned physical transpose on either side)."""
    if axis == x.ndim - 1 or axis == -1:
        return _transform.ifft_minor(x)
    perm = list(range(x.ndim))
    perm[axis], perm[-1] = perm[-1], perm[axis]
    t = _B(jnp.transpose(x, perm))
    t = _transform.ifft_minor(t)
    return _B(jnp.transpose(t, perm))


def _fft_axis(x, axis):
    """Local unnormalized forward FFT along ``axis`` via the minor axis."""
    cdtype = jnp.complex64 if x.dtype in (jnp.float32, jnp.complex64) else jnp.complex128
    x = x.astype(cdtype)
    if axis == x.ndim - 1 or axis == -1:
        return jnp.fft.fft(x, axis=-1, norm="backward")
    perm = list(range(x.ndim))
    perm[axis], perm[-1] = perm[-1], perm[axis]
    t = _B(jnp.transpose(x, perm))
    t = jnp.fft.fft(t, axis=-1, norm="backward")
    return _B(jnp.transpose(t, perm))


def _irfft_last(x, n, assume_hermitian=False):
    """Local c2r along the last axis (ops/transform.py:irfft_minor)."""
    return _transform.irfft_minor(x, n, assume_hermitian)


def _rfft_last(x):
    """Local r2c along the last axis (the library's packed transform)."""
    rdtype = jnp.float32 if x.dtype == jnp.float32 else jnp.float64
    return jnp.fft.rfft(x.astype(rdtype), axis=-1, norm="backward")


def _check_divisible(shape, n_space):
    nx, ny, _ = shape
    if nx % n_space or ny % n_space:
        raise ValueError(
            f"slab decomposition needs nx ({nx}) and ny ({ny}) divisible by "
            f"the 'space' mesh axis size ({n_space})"
        )


def _specs(mesh, batched, k_axis, x_axis):
    """(in_spec, out_spec) with optional leading batch axis over 'data'."""
    data = DATA_AXIS if (batched and DATA_AXIS in mesh.shape) else None
    k = [None, None, None]
    k[k_axis] = SPACE_AXIS
    x = [None, None, None]
    x[x_axis] = SPACE_AXIS
    if batched:
        return P(data, *k), P(data, *x)
    return P(*k), P(*x)


def irfftn_slab(c, shape, mesh: Mesh, batched=False, assume_hermitian=False,
                weights=None):
    """Distributed inverse c2r FFT (norm='forward', i.e. pure mode sum).

    ``c``: packed half-spectrum (..., nx, ny, nz//2+1), sharded along ky
    over the mesh's 'space' axis (and optionally a leading batch axis over
    'data').  Returns the real field (..., nx, ny, nz) sharded along x.
    ``assume_hermitian=True`` (render paths, symmetrized spectra) uses
    the faster half-pack c2r tail (see transform.irfft_minor).

    ``weights``: optional (nz,) per-z-plane multipliers (lightcone
    weighting) applied to the output inside the same shard-local
    program, so XLA can fuse them into the c2r's output pass.
    """
    nx, ny, nz = shape
    n_space = mesh.shape[SPACE_AXIS]
    _check_divisible(shape, n_space)
    in_spec, out_spec = _specs(mesh, batched, k_axis=1, x_axis=0)
    off = 1 if batched else 0
    have_w = weights is not None
    w = jnp.ones((1,), jnp.float32) if not have_w else weights

    def local(cl, wl):
        cl = _ifft_axis(cl, cl.ndim - 3)
        if n_space > 1:
            cl = jax.lax.all_to_all(
                cl, SPACE_AXIS, split_axis=off, concat_axis=off + 1, tiled=True
            )
        cl = _ifft_axis(cl, cl.ndim - 2)
        out = _irfft_last(cl, nz, assume_hermitian)
        if have_w:
            out = out * wl[None, None, :].astype(out.dtype)
        return out

    return jax.shard_map(
        local, mesh=mesh, in_specs=(in_spec, P(None)), out_specs=out_spec,
        check_vma=False,
    )(c, w)


def rfftn_slab(x, shape, mesh: Mesh, batched=False):
    """Distributed forward r2c FFT (norm='backward': plain sum, no scaling).

    ``x``: real field sharded along x over 'space'; returns the packed
    half-spectrum sharded along ky.  Inverse layout of :func:`irfftn_slab`.
    """
    nx, ny, nz = shape
    n_space = mesh.shape[SPACE_AXIS]
    _check_divisible(shape, n_space)
    out_spec, in_spec = _specs(mesh, batched, k_axis=1, x_axis=0)
    off = 1 if batched else 0

    def local(xl):
        cl = _rfft_last(xl)
        cl = _fft_axis(cl, cl.ndim - 2)
        if n_space > 1:
            cl = jax.lax.all_to_all(
                cl, SPACE_AXIS, split_axis=off + 1, concat_axis=off, tiled=True
            )
        return _fft_axis(cl, cl.ndim - 3)

    return jax.shard_map(
        local, mesh=mesh, in_specs=in_spec, out_specs=out_spec, check_vma=False
    )(x)
