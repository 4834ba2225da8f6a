"""Multi-host execution: jax.distributed wiring + global array placement.

The reference is a single-process library (SURVEY.md section 2,
"Parallelism strategies" — none); this layer is what lets the same
mesh-sharded render programs (parallel/render.py, parallel/dfft.py) span
*processes*: a config-5 grid spread over several hosts, where
``jax.devices()`` only becomes the global device list after
``jax.distributed.initialize``.

Design rules that make the rest of the framework multi-process-clean:

* Every mesh is built from **global** devices (``parallel.mesh.make_mesh``
  already uses ``jax.devices()``; after :func:`initialize` that list spans
  processes, with each process's local devices contiguous — so the
  'space' axis maps to intra-host links first).
* Large per-scene arrays (the sigma grid) are placed shard-by-shard with
  ``jax.make_array_from_callback`` so no process ever materializes or
  ships a remote shard (:func:`place`).
* Small per-call inputs (weights, smoothing length, seeds) are passed as
  host numpy — jit replicates them; PRNG **keys are derived inside jit**
  from integer seeds, because a key committed to one process's device
  cannot enter a global program.
* Results come back via :func:`replicated_to_host` (statistics, which are
  psum-replicated) or stay device-resident and sharded (fields), with
  per-shard export in utils/io.py:save_field_sharded.

CPU-based testing: ``initialize(..., cpu_devices_per_process=N)`` forces
the CPU platform with N local devices and Gloo cross-process collectives
— the same recipe tests/test_multihost.py runs under pytest with two
subprocesses, which stands in for a multi-host cluster.
"""

from __future__ import annotations

import numpy as np

import jax

__all__ = [
    "initialize",
    "is_multiprocess",
    "place",
    "replicated_to_host",
    "local_shards",
]


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               local_device_ids=None, cpu_devices_per_process=None):
    """Join this process to a global JAX runtime.

    Under a cluster manager that ``jax.distributed.initialize()``
    auto-detects (SLURM, Open MPI, Kubernetes) call with **no
    arguments**; the coordinator, process count and process id come from
    its environment.

    For multi-process testing on CPU (or any explicit setup) pass
    ``coordinator_address`` ('host:port'), ``num_processes`` and
    ``process_id``.  ``cpu_devices_per_process=N`` additionally forces the
    CPU platform with N local virtual devices and Gloo collectives; it
    must be called before any JAX backend initialization (it goes through
    ``jax.config``, which works even after jax has been imported).
    """
    if cpu_devices_per_process:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", int(cpu_devices_per_process))
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = int(num_processes)
    if process_id is not None:
        kwargs["process_id"] = int(process_id)
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)


def is_multiprocess() -> bool:
    """True when the runtime spans more than one process."""
    return jax.process_count() > 1


def place(arr, sharding):
    """Place a host (or locally computed) array onto a global sharding.

    Single-process: a plain ``device_put``.  Multi-process: each process
    materializes only its *addressable* shards via
    ``jax.make_array_from_callback`` — nothing is gathered or shipped
    across hosts.  ``arr`` must hold the same logical values on every
    process (true for all scene precomputation, which is deterministic in
    the scene spec).
    """
    if not is_multiprocess():
        return jax.device_put(arr, sharding)
    host = np.asarray(arr)
    return jax.make_array_from_callback(
        host.shape, sharding, lambda idx: np.ascontiguousarray(host[idx])
    )


def replicated_to_host(x):
    """Host numpy copy of a fully-replicated (e.g. psum'd) global array.

    ``np.asarray`` refuses arrays with non-addressable shards even when
    every shard holds the same value; read the first local shard instead.
    """
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        return np.asarray(x.addressable_shards[0].data)
    return np.asarray(x)


def local_shards(arr):
    """[(global_index, host_block)] for this process's addressable shards.

    The building block for per-host IO (utils/io.py:save_field_sharded):
    each process writes exactly the blocks it owns.
    """
    out = []
    for s in arr.addressable_shards:
        out.append((s.index, np.asarray(s.data)))
    return out
