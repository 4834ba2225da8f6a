"""Distributed catalog painting: mass assignment onto a sharded grid.

Pod-scale mock catalogs (halo/HOD/Zel'dovich, FKP survey grids) need
their particles painted without ever materializing the full grid on one
device.  The scheme here is the standard domain decomposition of
particle-mesh codes, device-shaped:

* the HOST pre-bins particles by block owner (a single digitize —
  O(N) numpy) and hands every shard a padded (3, max_n) block plus a
  weight vector whose padding entries are 0 (painting zeros is a
  no-op, so ragged shard populations cost only the pad);
* each shard paints its block onto a LOCAL block extended by a
  ``margin`` of ghost planes on each sharded face (margin = 1 cell for
  CIC/TSC — the assignment windows reach one neighbor cell), with the
  same cell-centered kernels as the single-device painter
  (models/zeldovich.py:_paint);
* the ghost faces fold into the neighbors with ``ppermute`` rings
  (periodic: the first shard's left ghost wraps to the last shard) —
  slab meshes exchange two x faces; pencil meshes run the standard
  two-sweep halo exchange (x faces on the y-extended block first, so
  corners ride into the y folds);
* the global mean reduces with one psum and every shard normalizes to
  the density contrast locally.

The result is bit-close to the single-device ``paint`` (same kernels,
different add order — f32 scatter-add is order-sensitive at the 1e-7
level) and sharded like a rendered field, so every mesh estimator
(P(k) with window deconvolution, multipoles, xi(r), bispectrum...)
consumes it directly.  Parity: tests/test_paint_sharded.py.

Reference parity: the reference package has no catalog layer (SURVEY.md
section 0); this extends models/zeldovich.py:paint to meshes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from randomfield_tpu.parallel.mesh import SPACE_AXIS, field_sharding

__all__ = ["paint_sharded"]

_ORDERS = {"ngp": 1, "cic": 2, "tsc": 3}


def _paint_local(u, w, ext_shape, order, wrap_axes=(1, 2)):
    """Cell-centered NGP/CIC/TSC onto a local extended block.

    ``u``: (3, n) positions in CELLS, the margin-extended axes already
    shifted into the local frame; axes in ``wrap_axes`` wrap
    periodically, the others rely on the ghost margins.  Same kernels
    as models/zeldovich.py:_paint.
    """
    ex, ny, nz = ext_shape
    dims = (ex, ny, nz)
    grid = jnp.zeros(ex * ny * nz, w.dtype)
    if order == 1:
        idx = [jnp.floor(u[a]).astype(jnp.int32) for a in range(3)]
        idx = [idx[a] % dims[a] if a in wrap_axes else idx[a]
               for a in range(3)]
        flat = (idx[0] * ny + idx[1]) * nz + idx[2]
        return grid.at[flat].add(w).reshape(ext_shape)
    uc = u - 0.5
    if order == 2:
        i0 = jnp.floor(uc).astype(jnp.int32)
        frac = uc - i0.astype(w.dtype)
        for corner in range(8):
            off = [(corner >> a) & 1 for a in range(3)]
            wc = w
            flat = jnp.zeros_like(i0[0])
            for a in range(3):
                wc = wc * jnp.where(off[a], frac[a], 1.0 - frac[a])
                ia = i0[a] + off[a]
                if a in wrap_axes:
                    ia = ia % dims[a]
                flat = flat * dims[a] + ia
            grid = grid.at[flat].add(wc)
        return grid.reshape(ext_shape)
    i0 = jnp.round(uc).astype(jnp.int32)
    s = uc - i0.astype(w.dtype)
    w3 = [0.5 * (0.5 - s) ** 2, 0.75 - s * s, 0.5 * (0.5 + s) ** 2]
    for corner in range(27):
        off = [(corner // 3**a) % 3 for a in range(3)]
        wc = w
        flat = jnp.zeros_like(i0[0])
        for a in range(3):
            wc = wc * w3[off[a]][a]
            ia = i0[a] + (off[a] - 1)
            if a in wrap_axes:
                ia = ia % dims[a]
            flat = flat * dims[a] + ia
        grid = grid.at[flat].add(wc)
    return grid.reshape(ext_shape)


@functools.lru_cache(maxsize=16)
def _make_paint_pencil(mesh, shape, spacing, order, max_n):
    """Pencil-mesh painter: 2-D ghost margins on x (over 'spx') and y
    (over 'spy'); x faces fold first ON THE y-EXTENDED block, so corner
    contributions ride into the y folds (the standard two-sweep halo
    exchange)."""
    from randomfield_tpu.parallel import pencil as _pencil

    nx, ny, nz = shape
    px = mesh.shape[_pencil.SPX_AXIS]
    py = mesh.shape[_pencil.SPY_AXIS]
    nxl, nyl = nx // px, ny // py
    margin = 0 if order == 1 else 1
    extx, exty = nxl + 2 * margin, nyl + 2 * margin
    fwd_x = [(i, (i + 1) % px) for i in range(px)]
    bwd_x = [(i, (i - 1) % px) for i in range(px)]
    fwd_y = [(i, (i + 1) % py) for i in range(py)]
    bwd_y = [(i, (i - 1) % py) for i in range(py)]

    def local(pos, w):
        jx = jax.lax.axis_index(_pencil.SPX_AXIS)
        jy = jax.lax.axis_index(_pencil.SPY_AXIS)
        u = pos[0]
        x_l = u[0] - (jx * nxl).astype(u.dtype) + margin
        y_l = u[1] - (jy * nyl).astype(u.dtype) + margin
        uu = jnp.stack([x_l, y_l, u[2]])
        m = _paint_local(uu, w[0], (extx, exty, nz), order, wrap_axes=(2,))
        if margin:
            if px > 1:
                left = jax.lax.ppermute(
                    m[:margin], _pencil.SPX_AXIS, bwd_x
                )
                right = jax.lax.ppermute(
                    m[-margin:], _pencil.SPX_AXIS, fwd_x
                )
            else:
                left, right = m[:margin], m[-margin:]
            core = m[margin:-margin]
            core = core.at[-margin:].add(left)
            core = core.at[:margin].add(right)
            if py > 1:
                down = jax.lax.ppermute(
                    core[:, :margin], _pencil.SPY_AXIS, bwd_y
                )
                up = jax.lax.ppermute(
                    core[:, -margin:], _pencil.SPY_AXIS, fwd_y
                )
            else:
                down, up = core[:, :margin], core[:, -margin:]
            core = core[:, margin:-margin]
            core = core.at[:, -margin:].add(down)
            core = core.at[:, :margin].add(up)
            m = core
        total = jax.lax.psum(
            jnp.sum(m), (_pencil.SPX_AXIS, _pencil.SPY_AXIS)
        )
        mean = total / (nx * ny * nz)
        return m / mean - 1.0, jnp.broadcast_to(mean, (1,))

    from jax.sharding import PartitionSpec as P

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(
            P((_pencil.SPX_AXIS, _pencil.SPY_AXIS), None, None),
            P((_pencil.SPX_AXIS, _pencil.SPY_AXIS), None),
        ),
        out_specs=(
            P(_pencil.SPX_AXIS, _pencil.SPY_AXIS, None),
            P((_pencil.SPX_AXIS, _pencil.SPY_AXIS)),
        ),
        check_vma=False,
    )
    return jax.jit(fn)


@functools.lru_cache(maxsize=16)
def _make_paint(mesh, shape, spacing, order, max_n):
    nx, ny, nz = shape
    n_space = mesh.shape[SPACE_AXIS]
    nx_loc = nx // n_space
    margin = 0 if order == 1 else 1
    ext = nx_loc + 2 * margin
    fwd = [(i, (i + 1) % n_space) for i in range(n_space)]
    bwd = [(i, (i - 1) % n_space) for i in range(n_space)]

    def local(pos, w):
        # pos: (1, 3, max_n) cells, GLOBAL x; w: (1, max_n)
        j = jax.lax.axis_index(SPACE_AXIS)
        u = pos[0]
        # global x -> extended local frame; owners were assigned by the
        # floor cell, so every touched cell lies inside the margins
        x_local = u[0] - (j * nx_loc).astype(u.dtype) + margin
        u = jnp.stack([x_local, u[1], u[2]])
        m = _paint_local(u, w[0], (ext, ny, nz), order)
        if margin:
            if n_space > 1:
                left = jax.lax.ppermute(m[:margin], SPACE_AXIS, bwd)
                right = jax.lax.ppermute(m[-margin:], SPACE_AXIS, fwd)
                core = m[margin:-margin]
                core = core.at[-margin:].add(left)
                core = core.at[:margin].add(right)
            else:
                core = m[margin:-margin]
                core = core.at[-margin:].add(m[:margin])
                core = core.at[:margin].add(m[-margin:])
            m = core
        total = jax.lax.psum(jnp.sum(m), SPACE_AXIS)
        mean = total / (nx * ny * nz)
        return m / mean - 1.0, jnp.broadcast_to(mean, (1,))

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(SPACE_AXIS, None, None), P(SPACE_AXIS, None)),
        out_specs=(P(SPACE_AXIS, None, None), P(SPACE_AXIS)),
        check_vma=False,
    )
    return jax.jit(fn)


def _axis_owner(u_axis, n_axis, n_loc, order):
    """(owner, wrap-adjusted global coords) along one margin axis."""
    if order == 1:
        ref = np.floor(u_axis)
    elif order == 2:
        ref = np.floor(u_axis - 0.5)
    else:
        ref = np.round(u_axis - 0.5)
    owner = (ref.astype(np.int64) % n_axis) // n_loc
    # wrap-adjust near the periodic seam ONLY: a particle whose
    # reference cell wrapped (e.g. u = 0.2 with CIC ref floor(-0.3) =
    # -1 -> owner = last shard) must continue past the owner's edge,
    # not sit a full box away.  Valid extended range per owner is
    # [owner*n_loc - margin, (owner+1)*n_loc + margin); anything
    # outside by more than the margin is a seam wrap.
    x = u_axis - owner * n_loc
    x = np.where(x > n_loc + 2.0, x - n_axis, x)
    x = np.where(x < -2.0, x + n_axis, x)
    return owner, x + owner * n_loc


def paint_sharded(positions, shape, spacing, mesh, weights=1.0,
                  window="cic"):
    """Mass-assign a particle catalog onto a mesh-sharded grid.

    ``positions``: (3, N) comoving Mpc/h (host array — the host
    pre-bins by block owner).  Returns ``(delta, w_mean)`` like
    models/zeldovich.py:paint, with ``delta`` sharded like a rendered
    field: x-slabs on a ('data','space') mesh, (x, y) blocks on a
    pencil mesh (two-sweep halo exchange folds the ghost faces and
    corners).  Periodic box; ``window`` in 'ngp'/'cic'/'tsc'.
    """
    from randomfield_tpu.parallel import pencil as _pencil

    if window not in _ORDERS:
        raise ValueError(
            f"window must be 'ngp', 'cic' or 'tsc', got {window!r}"
        )
    order = _ORDERS[window]
    shape = tuple(int(s) for s in shape)
    nx, ny, nz = shape
    is_pencil = _pencil.is_pencil_mesh(mesh)
    if is_pencil:
        px = mesh.shape[_pencil.SPX_AXIS]
        py = mesh.shape[_pencil.SPY_AXIS]
        if nx % px or ny % py:
            raise ValueError(
                f"shape {shape} not divisible by pencil ({px}, {py})"
            )
        nx_loc, ny_loc = nx // px, ny // py
        n_shards = px * py
    else:
        n_space = mesh.shape[SPACE_AXIS]
        if nx % n_space:
            raise ValueError(f"nx={nx} not divisible by space={n_space}")
        nx_loc = nx // n_space
        n_shards = n_space
    pos = np.asarray(positions, np.float32).reshape(3, -1)
    n = pos.shape[1]
    w = np.broadcast_to(
        np.asarray(weights, np.float32), (n,)
    ).astype(np.float32)
    # positions in cells, wrapped into the box
    u = pos / np.float32(spacing)
    u[0] %= nx
    u[1] %= ny
    u[2] %= nz
    owner_x, u0 = _axis_owner(u[0], nx, nx_loc, order)
    if is_pencil:
        owner_y, u1 = _axis_owner(u[1], ny, ny_loc, order)
        owner = owner_x * py + owner_y  # 'spx'-major, matching P((spx, spy))
    else:
        owner, u1 = owner_x, u[1]

    counts = np.bincount(owner, minlength=n_shards)
    # next power of two: one compiled program serves a whole ensemble of
    # catalogs with fluctuating per-shard populations
    max_n = 1 << (max(int(counts.max()), 1) - 1).bit_length()
    pos_pad = np.zeros((n_shards, 3, max_n), np.float32)
    w_pad = np.zeros((n_shards, max_n), np.float32)
    idx_sorted = np.argsort(owner, kind="stable")
    start = 0
    for s_i in range(n_shards):
        c = int(counts[s_i])
        sel = idx_sorted[start:start + c]
        start += c
        pos_pad[s_i, 0, :c] = u0[sel]
        pos_pad[s_i, 1, :c] = u1[sel]
        pos_pad[s_i, 2, :c] = u[2][sel]
        w_pad[s_i, :c] = w[sel]
    # padded entries sit at the local origin with weight 0 — no-ops
    if is_pencil:
        fn = _make_paint_pencil(mesh, shape, float(spacing), order,
                                int(max_n))
        sharding = _pencil.pencil_field_sharding(mesh)
    else:
        fn = _make_paint(mesh, shape, float(spacing), order, int(max_n))
        sharding = field_sharding(mesh)
    delta, mean = fn(jnp.asarray(pos_pad), jnp.asarray(w_pad))
    delta = jax.lax.with_sharding_constraint(delta, sharding)
    return delta, float(np.asarray(mean)[0])
