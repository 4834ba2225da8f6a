"""Scene (static spec) and State (precomputed device arrays).

The reference's ``Generator.__init__`` mixes configuration and expensive
precomputation into one object (randomfield/generate.py:Generator).  On
an accelerator the natural split is:

* :class:`Scene` — a frozen, hashable spec (shape, spacing, cosmology,
  options).  Hashable means it can be a jit static argument, so each scene
  compiles exactly one render program.
* :class:`State` — the precomputed pytree of device arrays (sigma(k) grid,
  lightcone plane weights) that renders are closed over.  Analogous to the
  buffers the reference precomputes in its constructor, but immutable —
  XLA buffer donation replaces the reference's in-place reuse.
"""

from __future__ import annotations

import dataclasses
import typing

import jax.numpy as jnp
import numpy as np

from randomfield_tpu.models import cosmology as _cosmo
from randomfield_tpu.ops import power as _power

__all__ = ["Scene", "State", "build_state"]


@dataclasses.dataclass(frozen=True)
class Scene:
    """Static scene spec — hashable, jit-friendly."""

    nx: int
    ny: int
    nz: int
    grid_spacing: float  # Mpc/h
    cosmology: _cosmo.Cosmology = _cosmo.Planck13
    interpolation: str = "log10k"
    dtype: typing.Any = jnp.float32
    z0: float = 0.0  # redshift of the nearest lightcone plane

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.nx, self.ny, self.nz)

    @property
    def volume(self) -> float:
        return self.nx * self.ny * self.nz * self.grid_spacing**3

    @property
    def k_bounds(self) -> tuple[float, float]:
        from randomfield_tpu.ops.grid import get_k_bounds

        return get_k_bounds(self.shape, self.grid_spacing)


class State(typing.NamedTuple):
    """Precomputed per-scene device arrays (a pytree; safe to donate)."""

    sigmas: typing.Optional[jnp.ndarray]  # (nx, ny, nz//2+1) — sqrt(P(|k|)/V);
    # None for mesh scenes, which evaluate sigma inline from the table
    # (parallel/render.py) and materialize a sharded grid only on demand
    lightcone_weights: jnp.ndarray  # (nz,) float — D(z_plane)/D(0)


def build_state(scene: Scene, power, layout="xyz",
                with_sigmas=True) -> tuple[State, dict]:
    """Precompute sigma(k) + lightcone weights for a scene.

    Returns ``(state, aux)`` where ``aux`` holds host-side float64 arrays
    useful for reporting/validation: plane redshifts, growth factors, and
    the validated power table.  ``layout`` selects the sigma-grid axis
    order ('xzy' for the staged pipeline — see engine/staged.py).
    ``with_sigmas=False`` skips the O(N^3) sigma tabulation (mesh scenes
    evaluate sigma inline per shard; storing a grid would replicate it).
    """
    table = _power.validate_power(power)
    if with_sigmas:
        sigmas = _power.tabulate_sigmas(
            scene.shape, scene.grid_spacing, table, scene.interpolation,
            scene.dtype, layout=layout,
        )
    else:
        _power.require_coverage(table, scene.shape, scene.grid_spacing)
        sigmas = None
    redshifts = _cosmo.get_redshifts(
        scene.cosmology, scene.nz, scene.grid_spacing, scaled_by_h=True, z0=scene.z0
    )
    growth = _cosmo.get_growth_function(scene.cosmology, redshifts)
    # growth_function is normalized to D(z=0)=1, so D(z_i) IS the lightcone
    # weight D(z_i)/D(0); when z0 > 0 the nearest plane is not at weight 1.
    weights = jnp.asarray(growth, dtype=scene.dtype)
    state = State(sigmas=sigmas, lightcone_weights=weights)
    aux = {"redshifts": redshifts, "growth": growth, "power": table}
    return state, aux
