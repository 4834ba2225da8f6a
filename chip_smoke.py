#!/usr/bin/env python
"""Drive the main render paths once on the GPU and check what comes out.

    python chip_smoke.py             # one GPU: phases 1-4
    python chip_smoke.py --chips 4   # four GPUs: the mesh phases only

Every phase goes through the public ``Generator`` API at the sizes of
the configs in BASELINE.json and prints its result on its own line:

  1. oracle parity at 256^3 (config 2): custom tabulated P(k) and
     Gaussian smoothing; Threefry noise drawn on the GPU is rendered by
     the GPU and by the float64 host oracle (validate/oracle.py)
  2. 512^3 lightcone (config 3): determinism, variance vs prediction,
     realized P(k) vs the input table
  3. 1024^3 headline under pipeline='auto' and the other pipeline: the
     phase-2 gates plus the median and spread of 5 warm renders
  4. 1024^3 ensemble (config 4): sample_power_batch over 8 seeds (the
     config's 64 cut to 8 for time), one seed checked against the
     field-space estimate
  5. (--chips 4) config 5 on four GPUs: 1024^3 slab and pencil renders
     and the mesh sample_power against one GPU in the same process, and
     a 2048^3 slab render under the phase-2 gates

A failed gate raises, so the process exits non-zero before the last
line.  The last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
There is no CPU fallback: without a GPU the script exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np


def say(msg):
    print(msg, flush=True)


def check(ok, what):
    if not ok:
        raise SystemExit(f"FAILED: {what}")
    say(f"  ok: {what}")


def timed(fn, reps):
    """Seconds of ``reps`` warm calls, each ending on the device; no
    result is kept alive past its own call."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn().block_until_ready()
        ts.append(time.perf_counter() - t0)
    return ts


def spread(ts):
    return (f"median {statistics.median(ts):.4f} s, min {min(ts):.4f} s, "
            f"max {max(ts):.4f} s over {len(ts)}")


def field_gates(g, seed, label):
    """Phase-2 gates on a rendered scene: bitwise determinism, variance
    within 5 % of the prediction, realized P(k) within 15 % of the input
    table on bins with more than 1000 modes."""
    import jax.numpy as jnp

    from randomfield_tpu.ops.power import interpolate_power
    from randomfield_tpu.validate.stats import field_moments

    a = g.generate_delta_field(seed)
    b = g.generate_delta_field(seed)
    same = bool(jnp.array_equal(a, b))
    del a, b
    check(same, f"{label}: two renders of seed {seed} are bitwise equal")
    d = g.generate_delta_field(seed, apply_lightcone=False)
    _, var = field_moments(d)
    ratio = var / g.predicted_variance()
    say(f"  {label}: var/predicted = {ratio:.5f}")
    check(abs(ratio - 1) < 0.05, f"{label}: variance within 5 % of prediction")
    k, pk, nm = g.calculate_power(d, nbins=16)
    del d
    mask = nm > 1000
    want = np.asarray(interpolate_power(
        g.power, jnp.asarray(k[mask], jnp.float32)))
    resid = float(np.abs(pk[mask] / want - 1).max())
    say(f"  {label}: max |P/P_in - 1| = {resid:.4f} on {int(mask.sum())} bins")
    check(resid < 0.15, f"{label}: realized P(k) within 15 % of the input")


def phase_oracle():
    """Phase 1: the GPU render vs the float64 oracle on the same draws."""
    import jax.numpy as jnp

    import randomfield_tpu as rf
    from randomfield_tpu.models.powerspec import make_power_table
    from randomfield_tpu.validate import oracle

    say("phase 1: oracle parity, 256^3 (config 2)")
    n, spacing, smoothing = 256, 4.0, 8.0
    k, pk = make_power_table(rf.create_cosmology("Planck13"))
    g = rf.Generator(n, n, n, grid_spacing=spacing, power=(k, pk))
    draws = g.generate_noise(seed=2)
    got = np.asarray(g.generate_from_noise(
        draws, smoothing_length=smoothing, apply_lightcone=False))
    draws = np.asarray(draws, np.float64)
    want = oracle.render_from_noise(
        draws[0], draws[1], (n, n, n), spacing, (k, pk),
        smoothing_length=smoothing,
    )
    scale = float(np.std(want))
    err = np.abs(got - want)
    bound = 2e-5 * scale + 1e-7 + 2e-4 * np.abs(want)
    say(f"  max |gpu - oracle| / std = {err.max() / scale:.3e}; "
        f"worst share of tolerance = {(err / bound).max():.3f}")
    check(bool((err <= bound).all()),
          "render_from_noise matches the oracle "
          "(atol 2e-5*std + 1e-7, rtol 2e-4)")


def phase_lightcone():
    import randomfield_tpu as rf

    say("phase 2: 512^3 lightcone with growth evolution (config 3)")
    g = rf.Generator(512, 512, 512, grid_spacing=4.0)
    say(f"  pipeline {g.pipeline}; growth D(z) from "
        f"{g.growth_function[0]:.4f} to {g.growth_function[-1]:.4f}")
    field_gates(g, seed=3, label="512^3")


def phase_headline():
    import randomfield_tpu as rf

    say("phase 3: 1024^3 headline, both pipelines")
    n, spacing = 1024, 2.0
    auto = rf.Generator(n, n, n, grid_spacing=spacing, pipeline="auto")
    first = auto.pipeline
    del auto
    for pipeline in (first, "staged" if first == "fused" else "fused"):
        g = rf.Generator(n, n, n, grid_spacing=spacing, pipeline=pipeline)
        label = f"1024^3 {g.pipeline}" + (" (auto)" if pipeline == first else "")
        t0 = time.perf_counter()
        g.generate_delta_field(0).block_until_ready()
        say(f"  {label}: first render (compile) {time.perf_counter() - t0:.2f} s")
        seeds = iter(range(1, 100))
        ts = timed(lambda: g.generate_delta_field(next(seeds)), 5)
        say(f"  {label}: warm render {spread(ts)} "
            f"({n**3 / statistics.median(ts) / 1e9:.2f} Gcells/s)")
        field_gates(g, seed=7, label=label)
        del g


def phase_ensemble():
    import randomfield_tpu as rf

    say("phase 4: 1024^3 ensemble sample_power_batch (config 4; "
        "its 64 seeds cut to 8 for time)")
    n, spacing, nbins = 1024, 2.0, 16
    g = rf.Generator(n, n, n, grid_spacing=spacing)
    g.sample_power_batch([100], nbins=nbins)
    t0 = time.perf_counter()
    k, p, nm = g.sample_power_batch(np.arange(8), nbins=nbins)
    dt = time.perf_counter() - t0
    say(f"  8 seeds in {dt:.3f} s ({8 / dt:.2f} seeds/s), pipeline {g.pipeline}")
    check(p.shape == (8, nbins) and bool(np.isfinite(p[:, nm > 0]).all()),
          "8 finite binned spectra")
    d = g.generate_delta_field(5, apply_lightcone=False)
    kf, pf, nf = g.calculate_power(d, nbins=nbins)
    del d
    mask = nf > 0
    dev = float(np.abs(pf[mask] / p[5, mask] - 1).max())
    say(f"  seed 5: max |P_field / P_spectrum - 1| = {dev:.2e}")
    check(dev < 2e-3, "seed 5: field-space P(k) equals sample_power "
          "to 2e-3 per bin (f32 transforms)")


def phase_mesh():
    """Config 5 on four GPUs: mesh renders against one GPU, then 2048^3."""
    import jax
    import jax.numpy as jnp

    import randomfield_tpu as rf
    from randomfield_tpu.parallel.mesh import make_mesh
    from randomfield_tpu.parallel.pencil import make_pencil_mesh

    n, spacing, seed = 1024, 2.0, 11
    say("phase 5: meshes on four GPUs vs one GPU (config 5)")
    single = rf.Generator(n, n, n, grid_spacing=spacing, pipeline="fused")
    ref = single.generate_delta_field(seed)
    seeds = iter(range(20, 100))
    ts = timed(lambda: single.generate_delta_field(next(seeds)), 5)
    say(f"  1024^3 one GPU: warm render {spread(ts)}")
    scale = float(jnp.std(ref))
    ks, ps, ns = single.sample_power(seed, nbins=16)
    ref = np.asarray(ref)
    del single
    for name, mesh in (("slab (1, 4)", make_mesh(1, 4)),
                       ("pencil (1, 2, 2)", make_pencil_mesh(1, 2, 2))):
        g = rf.Generator(n, n, n, grid_spacing=spacing, mesh=mesh)
        t0 = time.perf_counter()
        got = g.generate_delta_field(seed)
        got.block_until_ready()
        say(f"  1024^3 {name}: first render (compile) "
            f"{time.perf_counter() - t0:.2f} s")
        seeds = iter(range(20, 100))
        ts = timed(lambda: g.generate_delta_field(next(seeds)), 5)
        say(f"  1024^3 {name}: warm render {spread(ts)}")
        err = float(np.abs(np.asarray(got) - ref).max()) / scale
        say(f"  1024^3 {name}: max |mesh - single| / std = {err:.3e}")
        check(err < 1e-4, f"1024^3 {name} equals the one-GPU render to "
              "1e-4 std (different FFT decomposition)")
        del got
        if name.startswith("slab"):
            km, pm, nmm = g.sample_power(seed, nbins=16)
            mask = ns > 0
            # counts are f32 sums of up to ~1e8 modes per bin, summed
            # in another order across shards: equal to f32 rounding
            cdev = float(np.abs(nmm[mask] / ns[mask] - 1).max())
            check(cdev < 1e-6, f"mesh sample_power mode counts "
                  f"(max relative deviation {cdev:.1e} < 1e-6)")
            dev = float(np.abs(pm[mask] / ps[mask] - 1).max())
            say(f"  mesh sample_power: max |P_mesh / P_single - 1| = {dev:.2e}")
            check(dev < 1e-4, "mesh sample_power equals one GPU to 1e-4")
        del g
    del ref
    n = 2048
    g = rf.Generator(n, n, n, grid_spacing=1.0, mesh=make_mesh(1, 4))
    t0 = time.perf_counter()
    g.generate_delta_field(0).block_until_ready()
    say(f"  2048^3 slab: first render (compile) {time.perf_counter() - t0:.2f} s")
    seeds = iter(range(1, 100))
    ts = timed(lambda: g.generate_delta_field(next(seeds)), 3)
    say(f"  2048^3 slab: warm render {spread(ts)} "
        f"({n**3 / statistics.median(ts) / 1e9:.2f} Gcells/s)")
    peak = max(d.memory_stats()["peak_bytes_in_use"] for d in jax.devices())
    say(f"  2048^3 slab: peak device memory {peak / 2**30:.2f} GiB per GPU")
    field_gates(g, seed=4, label="2048^3 slab")
    say(f"  devices: {jax.devices()}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--chips", type=int, default=1, choices=(1, 4),
                   help="4: run only the mesh phases, on four GPUs")
    args = p.parse_args(argv)

    import jax
    import jaxlib

    from randomfield_tpu.utils.cache import enable_compile_cache
    from randomfield_tpu.utils.device import require_gpu

    devices = require_gpu()
    if len(devices) < args.chips:
        raise SystemExit(f"--chips {args.chips} needs {args.chips} GPUs; "
                         f"JAX sees {len(devices)}")
    cache = enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    say(f"nvidia-smi: {smi}")
    say(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}; "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; compile cache {cache}")
    say(f"devices: {devices}")
    t0 = time.perf_counter()
    if args.chips == 4:
        phase_mesh()
    else:
        phase_oracle()
        phase_lightcone()
        phase_headline()
        phase_ensemble()
    say(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind, "count": len(d),
    }}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
