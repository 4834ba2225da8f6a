"""Multi-device execution: pencil decomposition + multi-host wiring.

Run modes:

  # single process, 8 virtual CPU devices (works anywhere):
  python examples/pencil_multihost.py

  # one process per host of a real cluster (jax.distributed
  # auto-detects SLURM / Open MPI; see parallel/multihost.py):
  python examples/pencil_multihost.py --multihost

The same Generator code covers every case; only the mesh construction
and (on multi-host) the `multihost.initialize()` call differ.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

if "--multihost" in sys.argv:
    # each host runs this same script; initialize() auto-detects the
    # coordinator and process ids from the cluster manager
    from randomfield_tpu.parallel import multihost

    multihost.initialize()
else:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402

import randomfield_tpu as rf  # noqa: E402
from randomfield_tpu.parallel.pencil import make_pencil_mesh  # noqa: E402
from randomfield_tpu.utils.io import save_field_sharded  # noqa: E402
from randomfield_tpu.validate.stats import field_moments  # noqa: E402

# 2-D spatial decomposition: x over 'spx', y over 'spy', z local.
# Scales past the slab limit of min(nx, ny) devices.
mesh = make_pencil_mesh(data=2, spx=2, spy=2)
g = rf.Generator(64, 64, 64, grid_spacing=4.0, mesh=mesh)

delta = g.generate_delta_field(seed=0)
mean, var = field_moments(delta)
print(f"render: var={var:.4f} predicted={g.predicted_variance():.4f}")

# distributed P(k): forward pencil FFT + shard-local binning + psum —
# the full spectrum is never gathered
k, p, n = g.calculate_power(delta, nbins=12)
print("P(k) bins:", np.array2string(p[n > 0][:4], precision=3))

# data-parallel ensemble over the 'data' axis, spatially sharded fields
fields = g.generate_delta_fields(np.arange(4), smoothing_length=8.0)
print("ensemble:", fields.shape, fields.sharding.spec)

# per-process chunked export (no host ever gathers the field)
out = save_field_sharded("/tmp/pencil_field", delta, generator=g, seed=0)
print("chunks written to", out)
