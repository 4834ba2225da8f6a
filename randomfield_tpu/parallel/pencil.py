"""Pencil (2-D) decomposition: distributed FFTs beyond the slab limit.

The slab transform (parallel/dfft.py) shards ONE grid axis, so its mesh
cannot exceed min(nx, ny) devices and its all-to-all moves every byte
through a single axis's links.  A pencil decomposition shards TWO axes
over a ('spx', 'spy') sub-mesh, scaling to nx*ny/(block) devices —
the standard shape for the largest grids (AccFFT / P3DFFT pattern,
PAPERS.md; SURVEY.md section 5 "long-context analog", next step past
config 5).

Inverse (k -> x), z always transformed locally as the LAST axis (c2r):

  state 1  block (nx, ny/Px, kzp/Py)   ifft over x (local axis 0)
  A2A(Px)  x <-> ky                    block (nx/Px, ny, kzp/Py)
  state 2                              ifft over y (local axis 1)
  A2A(Py)  y <-> kz                    block (nx/Px, ny/Py, nzh)
  state 3                              c2r over z (local, half-pack)

  output: real field, x sharded over 'spx', y over 'spy', z local.

The packed kz axis (nz//2 + 1, usually odd) is zero-padded to a
multiple of Py for equal all-to-all tiles and sliced back before the
c2r; the pad shards carry zeros and are never transformed.

Forward (x -> k) is the exact reverse.  Both directions are shard_map
programs: one all_to_all per stage, each over a single mesh axis.

Requirements: nx % Px == 0, ny % Px == 0, ny % Py == 0.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from randomfield_tpu.ops import transform as _transform
from randomfield_tpu.parallel.dfft import _fft_axis, _ifft_axis, _rfft_last
from randomfield_tpu.parallel.mesh import DATA_AXIS

__all__ = [
    "SPX_AXIS",
    "SPY_AXIS",
    "make_pencil_mesh",
    "is_pencil_mesh",
    "pencil_sigma_sharding",
    "pencil_field_sharding",
    "irfftn_pencil",
    "rfftn_pencil",
]

SPX_AXIS = "spx"
SPY_AXIS = "spy"


def make_pencil_mesh(data=1, spx=1, spy=1, devices=None) -> Mesh:
    """('data', 'spx', 'spy') mesh from the first data*spx*spy devices.

    Devices fill the mesh in ``jax.devices()`` order, 'spy' fastest.
    """
    if devices is None:
        devices = jax.devices()
    n = data * spx * spy
    if len(devices) < n:
        raise ValueError(f"need {n} devices for mesh ({data=}, {spx=}, "
                         f"{spy=}); have {len(devices)}")
    grid = np.asarray(devices[:n]).reshape(data, spx, spy)
    return Mesh(grid, (DATA_AXIS, SPX_AXIS, SPY_AXIS))


def is_pencil_mesh(mesh: Mesh) -> bool:
    return SPX_AXIS in mesh.shape and SPY_AXIS in mesh.shape


def _check_pencil(shape, px, py):
    nx, ny, _ = shape
    if nx % px or ny % px or ny % py or nx % py:
        raise ValueError(
            f"pencil decomposition needs nx ({nx}) and ny ({ny}) divisible "
            f"by both spx ({px}) and spy ({py})"
        )


def pencil_sigma_sharding(mesh, batched=False) -> NamedSharding:
    """Spectrum-shaped arrays: FULLY pencil-sharded (state 0).

    x over 'spy', ky over 'spx', kz local — per-device bytes scale as
    1/(px*py).  This is the render path's layout for draws and sampled
    spectra (``irfftn_pencil(input_layout='state0')`` starts from it)
    and the on-demand ``Generator.sigmas`` placement.  Round 2 used a
    'spy'-replicated placement here (~4.3 GB of sigma per device at
    2048^3); sigma is now evaluated inline and nothing spectrum-sized
    is replicated anywhere.
    """
    spec = ((DATA_AXIS, SPY_AXIS, SPX_AXIS, None) if batched
            else (SPY_AXIS, SPX_AXIS, None))
    return NamedSharding(mesh, P(*spec))


def pencil_field_sharding(mesh, batched=False) -> NamedSharding:
    """Real fields shard x over 'spx' and y over 'spy'; z local (state 3)."""
    spec = ((DATA_AXIS, SPX_AXIS, SPY_AXIS, None) if batched
            else (SPX_AXIS, SPY_AXIS, None))
    return NamedSharding(mesh, P(*spec))


def _kz_pad(nzh: int, py: int) -> int:
    return (-nzh) % py


def irfftn_pencil(c, shape, mesh: Mesh, batched=False, assume_hermitian=False,
                  input_layout="state1", weights=None):
    """Distributed inverse c2r FFT over a pencil mesh (norm='forward').

    ``c``: packed half-spectrum (..., nx, ny, nzh).

    ``input_layout='state1'``: any input sharding works — the shard_map
    in_specs redistribute to pencil state 1 (x local, ky over 'spx', kz
    padded over 'spy') after an internal kz pad.  With kz-unsharded
    input placements this slices locally, but each device must hold a
    full-x block: per-device bytes scale only as 1/px.

    ``input_layout='state0'``: the input is FULLY pencil-sharded —
    P('spy', 'spx', None): x over 'spy', ky over 'spx', kz local — so
    per-device bytes scale as 1/(px*py) end to end (the render path's
    layout; parallel/render.py).  Costs one extra all-to-all over 'spy'
    (kz <-> x, the state 0 -> 1 transpose), the standard 3-transpose
    pencil schedule (AccFFT/P3DFFT).

    ``weights``: optional (nz,) per-z-plane multipliers applied to the
    output inside the shard-local program.

    Returns the real field sharded per :func:`pencil_field_sharding`.
    """
    nx, ny, nz = shape
    nzh = nz // 2 + 1
    px, py = mesh.shape[SPX_AXIS], mesh.shape[SPY_AXIS]
    _check_pencil(shape, px, py)
    pad = _kz_pad(nzh, py)
    off = 1 if batched else 0
    data = DATA_AXIS if (batched and DATA_AXIS in mesh.shape) else None
    state0 = input_layout == "state0"
    if input_layout not in ("state0", "state1"):
        raise ValueError(f"unknown input_layout {input_layout!r}")

    def local(cl, wl):
        if state0:
            # state 0: (nx/py, ny/px, nzh) — pad kz locally, then
            # all-to-all kz <-> x over 'spy' into state 1
            if pad:
                widths = [(0, 0)] * cl.ndim
                widths[-1] = (0, pad)
                cl = jnp.pad(cl, widths)
            if py > 1:
                cl = jax.lax.all_to_all(
                    cl, SPY_AXIS, split_axis=off + 2, concat_axis=off,
                    tiled=True,
                )
        # state 1: (nx, ny/px, kzp/py) — x fully local
        cl = _ifft_axis(cl, cl.ndim - 3)
        if px > 1:
            cl = jax.lax.all_to_all(
                cl, SPX_AXIS, split_axis=off, concat_axis=off + 1, tiled=True
            )
        # state 2: (nx/px, ny, kzp/py) — y fully local
        cl = _ifft_axis(cl, cl.ndim - 2)
        if py > 1:
            cl = jax.lax.all_to_all(
                cl, SPY_AXIS, split_axis=off + 1, concat_axis=off + 2,
                tiled=True,
            )
        # state 3: (nx/px, ny/py, kzp) — kz fully local; drop the pad
        if pad:
            cl = cl[..., :nzh]
        out = _transform.irfft_minor(cl, nz, assume_hermitian)
        if weights is not None:
            out = out * wl[None, None, :].astype(out.dtype)
        return out

    if state0:
        in_spec = (P(data, SPY_AXIS, SPX_AXIS, None) if batched
                   else P(SPY_AXIS, SPX_AXIS, None))
    else:
        in_spec = (P(data, None, SPX_AXIS, SPY_AXIS) if batched
                   else P(None, SPX_AXIS, SPY_AXIS))
    out_spec = (P(data, SPX_AXIS, SPY_AXIS, None) if batched
                else P(SPX_AXIS, SPY_AXIS, None))

    if pad and not state0:
        # zero-pad kz so each 'spy' shard is an equal all-to-all tile;
        # pad BEFORE shard_map so the pad itself is sharded
        widths = [(0, 0)] * c.ndim
        widths[-1] = (0, pad)
        c = jnp.pad(c, widths)
    w = (jnp.ones((1,), jnp.float32) if weights is None
         else jnp.asarray(weights))
    return jax.shard_map(
        local, mesh=mesh, in_specs=(in_spec, P(None)),
        out_specs=out_spec, check_vma=False,
    )(c, w)


def rfftn_pencil(x, shape, mesh: Mesh, batched=False, keep_pad=False):
    """Distributed forward r2c FFT over a pencil mesh (norm='backward').

    Exact reverse of :func:`irfftn_pencil`: local r2c over z, all_to_all
    kz <-> y over 'spy', local fft over y, all_to_all ky <-> x over
    'spx', local fft over x.  ``keep_pad=True`` returns the spectrum
    with its kz axis still zero-padded to a multiple of 'spy' (equal
    shard blocks) — consumers that immediately shard_map over the
    spectrum (the distributed P(k) estimator) avoid an uneven re-shard
    followed by a re-pad.
    """
    nx, ny, nz = shape
    nzh = nz // 2 + 1
    px, py = mesh.shape[SPX_AXIS], mesh.shape[SPY_AXIS]
    _check_pencil(shape, px, py)
    pad = _kz_pad(nzh, py)
    off = 1 if batched else 0
    data = DATA_AXIS if (batched and DATA_AXIS in mesh.shape) else None

    def local(xl):
        # state 3: (nx/px, ny/py, nz) — z fully local: r2c, pad kz
        cl = _rfft_last(xl)
        if pad:
            widths = [(0, 0)] * cl.ndim
            widths[-1] = (0, pad)
            cl = jnp.pad(cl, widths)
        if py > 1:
            cl = jax.lax.all_to_all(
                cl, SPY_AXIS, split_axis=off + 2, concat_axis=off + 1,
                tiled=True,
            )
        # state 2: (nx/px, ny, kzp/py) — y fully local
        cl = _fft_axis(cl, cl.ndim - 2)
        if px > 1:
            cl = jax.lax.all_to_all(
                cl, SPX_AXIS, split_axis=off + 1, concat_axis=off, tiled=True
            )
        # state 1: (nx, ny/px, kzp/py) — x fully local
        return _fft_axis(cl, cl.ndim - 3)

    in_spec = (P(data, SPX_AXIS, SPY_AXIS, None) if batched
               else P(SPX_AXIS, SPY_AXIS, None))
    out_spec = (P(data, None, SPX_AXIS, SPY_AXIS) if batched
                else P(None, SPX_AXIS, SPY_AXIS))

    c = jax.shard_map(
        local, mesh=mesh, in_specs=in_spec, out_specs=out_spec,
        check_vma=False,
    )(x)
    if pad and not keep_pad:
        c = c[..., :nzh]
    return c
