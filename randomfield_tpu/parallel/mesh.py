"""Device mesh construction for data-parallel x spatially-sharded execution.

The reference has no parallelism at all (SURVEY.md section 2,
"Parallelism strategies"); this layer is new.  Two mesh axes:

* ``'data'`` — embarrassingly parallel seeds (ensembles, config 4); no
  communication during rendering, psum only for ensemble statistics.
* ``'space'`` — slab decomposition of the grid (config 5); the
  distributed irfftn's all-to-all transposes run within this axis.

The mesh follows the algorithm, not a link topology: on GPUs joined all
to all (NVLink within a host) every device pair has the same link, and
XLA hands the all-to-alls to NCCL.  Devices fill the mesh in
``jax.devices()`` order, 'space' fastest.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "spectrum_sharding", "field_sharding", "P"]

DATA_AXIS = "data"
SPACE_AXIS = "space"


def make_mesh(data=1, space=1, devices=None) -> Mesh:
    """Build a ('data', 'space') mesh from the first data*space devices."""
    if devices is None:
        devices = jax.devices()
    n = data * space
    if len(devices) < n:
        raise ValueError(f"need {n} devices for mesh ({data=}, {space=}); "
                         f"have {len(devices)}")
    grid = np.asarray(devices[:n]).reshape(data, space)
    return Mesh(grid, (DATA_AXIS, SPACE_AXIS))


def spectrum_sharding(mesh, batched=False) -> NamedSharding:
    """Packed half-spectra shard along ky (axis -2 of the k-mesh ordering).

    ky is the slab axis in k-space so that the x axis stays local for the
    first inverse-FFT stage (see parallel/dfft.py).
    """
    spec = (DATA_AXIS, None, SPACE_AXIS, None) if batched else (None, SPACE_AXIS, None)
    return NamedSharding(mesh, P(*spec))


def field_sharding(mesh, batched=False) -> NamedSharding:
    """Real-space fields shard along x (axis -3) — the dfft output layout."""
    spec = (DATA_AXIS, SPACE_AXIS, None, None) if batched else (SPACE_AXIS, None, None)
    return NamedSharding(mesh, P(*spec))
