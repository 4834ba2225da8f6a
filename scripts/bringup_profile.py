#!/usr/bin/env python
"""Per-stage times, memory and trace of the plain 1024^3 render on the GPU.

    python scripts/bringup_profile.py [--out DIR]             # one GPU
    python scripts/bringup_profile.py --chips 4 [--out DIR]   # four GPUs

One GPU:
  * peak bytes of the fused 1024^3 render program (XLA memory_analysis)
    and the bytes-per-cell factor engine/staged.py:pick_pipeline uses
  * each staged stage (P1 sample + sigma + filter, P2 x pass, P3 y pass,
    P4 c2r tail + weights) timed as its own program, with its minimal
    traffic (each input read once, each output written once) as a share
    of the H100's 3.35 TB/s
  * the c2r tail two ways: the half-length Cooley-Tukey pack
    (ops/ctfft.py) against the library c2r (``jnp.fft.irfft``, cuFFT),
    on one nz = 1024 tail chunk and on the whole tail
  * fused against staged, end to end, in turns
  * a profiler trace of the fused render: device busy share and the
    kernels that take the time
Four GPUs (--chips 4):
  * 1024^3 slab render with sigma inline against the materialized
    sharded sigma grid, in turns
  * the c2r of a 1024^3 slab shard, ctfft against cuFFT, on all four
  * a profiler trace of the slab render: all-to-all time per device

Every line names the GPU and its power limit.  Traces go to
DIR/trace_* (default profile_out/).
"""

from __future__ import annotations

import argparse
import glob
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
OUT = "profile_out"


def say(msg):
    print(msg, flush=True)


def bench(fn, reps=5):
    """Seconds per call: median and spread of ``reps`` warm calls."""
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), min(ts), max(ts)


def fmt(t, nbytes=None):
    med, lo, hi = t
    s = f"{med * 1e3:9.3f} ms (min {lo * 1e3:.3f}, max {hi * 1e3:.3f})"
    if nbytes:
        s += (f"  {nbytes / 1e9:7.2f} GB  {nbytes / med / 1e12:6.3f} TB/s"
              f" = {nbytes / med / PEAK_BYTES_PER_S:6.1%} of 3.35 TB/s")
    return s


def mem_stat(name):
    import jax

    return (jax.devices()[0].memory_stats() or {}).get(name, 0)


def trace_summary(fn, path, reps=3, top=12):
    """Trace ``reps`` calls into ``path``; print device busy share and
    top kernels."""
    import jax
    from jax.profiler import ProfileData

    jax.block_until_ready(fn())
    name = os.path.basename(path)
    with jax.profiler.trace(path):
        for _ in range(reps):
            jax.block_until_ready(fn())
    pb = sorted(glob.glob(f"{path}/plugins/profile/*/*.xplane.pb"))[-1]
    pd = ProfileData.from_file(pb)
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = {ln.name: list(ln.events) for ln in plane.lines}
        ops = lines.get("XLA Ops") or [
            e for n, evs in lines.items() if "Stream" in n for e in evs]
        if not ops:
            continue
        spans = sorted((e.start_ns, e.start_ns + e.duration_ns) for e in ops)
        busy, cur_s, cur_e = 0.0, *spans[0]
        for s, e in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        window = spans[-1][1] - spans[0][0]
        by_name = {}
        for e in ops:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.duration_ns
        coll = sum(v for k, v in by_name.items()
                   if any(t in k.lower() for t in ("all-to-all", "alltoall",
                                                   "nccl", "all_to_all")))
        say(f"  trace {name} {plane.name}: window {window / 1e6:.3f} ms over "
            f"{reps} calls, busy {busy / window:.1%} (idle "
            f"{1 - busy / window:.1%}), collectives "
            f"{coll / 1e6 / reps:.3f} ms/call")
        for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
            say(f"    {v / 1e6 / reps:9.3f} ms/call  {k[:90]}")


def one_gpu(out):
    import jax
    import jax.numpy as jnp

    import randomfield_tpu as rf
    from randomfield_tpu.engine import generator as gen
    from randomfield_tpu.engine import staged
    from randomfield_tpu.ops import ctfft
    from randomfield_tpu.ops import grid as _grid

    n, spacing = 1024, 2.0
    shape = (n, n, n)
    nzh = n // 2 + 1
    cells = n ** 3
    half = n * n * nzh  # complex half-spectrum elements

    # ---- memory of the fused program --------------------------------------
    key = jax.eval_shape(lambda: jax.random.key(0))
    f32 = jnp.float32
    lowered = gen.render.lower(
        key, jax.ShapeDtypeStruct((n, n, nzh), f32),
        jax.ShapeDtypeStruct((n,), f32), jax.ShapeDtypeStruct((), f32),
        shape=shape, spacing=spacing,
    )
    ma = lowered.compile().memory_analysis()
    total = (ma.argument_size_in_bytes + ma.output_size_in_bytes
             + ma.temp_size_in_bytes - ma.alias_size_in_bytes)
    say(f"fused 1024^3 memory_analysis: arguments "
        f"{ma.argument_size_in_bytes / 2**30:.3f} GiB, outputs "
        f"{ma.output_size_in_bytes / 2**30:.3f} GiB, temporaries "
        f"{ma.temp_size_in_bytes / 2**30:.3f} GiB, aliased "
        f"{ma.alias_size_in_bytes / 2**30:.3f} GiB; total "
        f"{total / 2**30:.3f} GiB = {total / cells:.2f} bytes/cell; "
        f"device bytes_limit {mem_stat('bytes_limit') / 2**30:.2f} GiB")

    # ---- staged stages, one program each ----------------------------------
    g = rf.Generator(n, n, n, grid_spacing=spacing, pipeline="staged")
    p1, p2, p3, _ = staged._stages(shape, spacing, "float32")
    _, _, p4ct = staged._stages_v2(shape, spacing, "float32")
    chunks = staged._tail_chunks(shape)
    bar = jax.lax.optimization_barrier

    @jax.jit
    def p4cu(c, weights):
        # the staged tail with the library c2r on the minor axis
        def one(chunk):
            t = bar(jnp.transpose(chunk, (0, 2, 1)))
            f = jnp.fft.irfft(t, n, axis=-1, norm="forward")
            return f * weights[None, None, :]

        ck = c.reshape(chunks, n // chunks, nzh, n)
        return jax.lax.map(one, ck).reshape(shape)

    kx, ky, kz = _grid.kvectors(shape, spacing, f32)
    sig = g.sigmas
    w = g._weights(True)
    sm = jnp.float32(0.0)
    k0 = jax.random.key(1)
    c = p1(k0, sig, sm, kx, kz, ky)
    stage_t = {}
    stage_t["P1 sample+sigma+filter"] = (
        bench(lambda: p1(k0, sig, sm, kx, kz, ky)), 8 * half + 4 * half)

    # donated stages: feed each call a fresh copy made outside the timer
    def donated(fn, x, reps=5):
        jax.block_until_ready(fn(jnp.copy(x)))
        ts = []
        for _ in range(reps):
            y = jnp.copy(x)
            y.block_until_ready()
            t0 = time.perf_counter()
            jax.block_until_ready(fn(y))
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts), min(ts), max(ts)

    stage_t["P2 x pass (transpose + ifft)"] = (donated(p2, c), 2 * 8 * half)
    c2 = p2(jnp.copy(c))
    stage_t["P3 y pass (ifft + transposes)"] = (donated(p3, c2), 2 * 8 * half)
    c3 = p3(jnp.copy(c2))
    del c2
    stage_t["P4 tail, ctfft half-pack + weights"] = (
        bench(lambda: p4ct(c3, w)), 8 * half + 4 * cells)
    stage_t["P4 tail, cuFFT irfft + weights"] = (
        bench(lambda: p4cu(c3, w)), 8 * half + 4 * cells)
    for k, (t, b) in stage_t.items():
        say(f"stage {k:38s} {fmt(t, b)}")
    a = np.asarray(p4ct(c3, w)[:8])
    b = np.asarray(p4cu(c3, w)[:8])
    say(f"tail ctfft vs cuFFT max |diff| / std = "
        f"{np.abs(a - b).max() / a.std():.3e}")
    del c, c3

    # ---- one tail chunk, nz = 1024 ----------------------------------------
    cx = n // chunks
    rng = np.random.RandomState(0)
    chunk = jnp.asarray((rng.normal(size=(cx, nzh, n))
                         + 1j * rng.normal(size=(cx, nzh, n))).astype(np.complex64))
    bar = jax.lax.optimization_barrier
    ct = jax.jit(lambda x: bar(jnp.transpose(
        ctfft.irfft_half_axis(x, n, 1), (0, 2, 1))))
    cu = jax.jit(lambda x: jnp.fft.irfft(
        bar(jnp.transpose(x, (0, 2, 1))), n, axis=-1, norm="forward"))
    nb = 8 * cx * nzh * n + 4 * cx * n * n
    say(f"tail chunk ({cx}, {nzh}, {n}) ctfft half-pack {fmt(bench(lambda: ct(chunk)), nb)}")
    say(f"tail chunk ({cx}, {nzh}, {n}) cuFFT irfft     {fmt(bench(lambda: cu(chunk)), nb)}")
    del chunk, g, sig

    # ---- fused vs staged, in turns ----------------------------------------
    gf = rf.Generator(n, n, n, grid_spacing=spacing, pipeline="fused")
    gs = rf.Generator(n, n, n, grid_spacing=spacing, pipeline="staged")
    seeds = iter(range(1000))
    res = {"fused": [], "staged": []}
    for order in ("fused", "staged", "staged", "fused"):
        gg = gf if order == "fused" else gs
        res[order].append(bench(lambda: gg.generate_delta_field(next(seeds)), 3))
    for k, v in res.items():
        say(f"render 1024^3 {k:6s}: " + "; ".join(fmt(t) for t in v))
    del gs
    trace_summary(lambda: gf.generate_delta_field(next(seeds)),
                  os.path.join(out, "trace_fused1024"))
    say(f"peak_bytes_in_use {mem_stat('peak_bytes_in_use') / 2**30:.3f} GiB")


def four_gpu(out):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import randomfield_tpu as rf
    from randomfield_tpu.engine.generator import _as_key
    from randomfield_tpu.ops import ctfft
    from randomfield_tpu.parallel.mesh import SPACE_AXIS, make_mesh
    from randomfield_tpu.parallel.render import make_sharded_render

    n, spacing = 1024, 2.0
    mesh = make_mesh(1, 4)
    g = rf.Generator(n, n, n, grid_spacing=spacing, mesh=mesh)
    fn = make_sharded_render(mesh, g.shape, g.grid_spacing,
                             log_values=g._table_host[2])
    lk, val = g._table_args()
    grid = g.sigmas
    w = g._weights(True)
    sm = jnp.float32(0.0)
    seeds = iter(range(1000))
    res = {"inline": [], "grid": []}
    for order in ("inline", "grid", "grid", "inline"):
        sig = None if order == "inline" else grid
        res[order].append(bench(
            lambda: fn(_as_key(next(seeds)), lk, val, sig, w, sm), 3))
    for k, v in res.items():
        say(f"slab 1024^3 sigma {k:6s}: " + "; ".join(fmt(t) for t in v))
    a = np.asarray(fn(_as_key(5), lk, val, None, w, sm)[:4])
    b = np.asarray(fn(_as_key(5), lk, val, grid, w, sm)[:4])
    say(f"inline vs grid max |diff| / std = {np.abs(a - b).max() / a.std():.3e}")
    del grid
    g.state = g.state._replace(sigmas=None)

    # c2r of a slab shard: (n/4, n, nzh) complex per GPU
    nzh = n // 2 + 1
    sh = NamedSharding(mesh, P(SPACE_AXIS, None, None))
    c = jax.jit(lambda k: jax.lax.complex(
        jax.random.normal(k, (n, n, nzh)), jax.random.normal(k, (n, n, nzh))),
        out_shardings=sh)(jax.random.key(0))

    def local(f):
        return jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=P(SPACE_AXIS, None, None),
            out_specs=P(SPACE_AXIS, None, None), check_vma=False))

    ct = local(lambda x: ctfft.irfft_half_axis(x, n, axis=-1))
    cu = local(lambda x: jnp.fft.irfft(x, n, axis=-1, norm="forward"))
    nb = (8 * n * n * nzh + 4 * n ** 3) // 4
    say(f"slab shard c2r ({n // 4}, {n}, {nzh}) ctfft {fmt(bench(lambda: ct(c)), nb)}")
    say(f"slab shard c2r ({n // 4}, {n}, {nzh}) cuFFT {fmt(bench(lambda: cu(c)), nb)}")
    del c
    trace_summary(lambda: g.generate_delta_field(next(seeds)),
                  os.path.join(out, "trace_slab1024"))


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--chips", type=int, default=1, choices=(1, 4))
    p.add_argument("--out", default=OUT, help="directory for the traces")
    args = p.parse_args()

    from randomfield_tpu.utils.cache import enable_compile_cache
    from randomfield_tpu.utils.device import require_gpu

    require_gpu()
    enable_compile_cache()
    os.makedirs(args.out, exist_ok=True)
    say("gpu: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    four_gpu(args.out) if args.chips == 4 else one_gpu(args.out)


if __name__ == "__main__":
    main()
