"""What the program asks of the device it runs on.

Two questions only: which platform JAX picked, and how many bytes one
device may allocate.  Pipeline choices derive from the second
(engine/staged.py:pick_pipeline); measurement scripts use the first to
refuse to report a CPU run as a device number.
"""

from __future__ import annotations

import jax

__all__ = ["platform", "bytes_limit", "require_gpu"]


def platform() -> str:
    """The platform of this process's first device ('cpu', 'gpu', ...)."""
    return jax.local_devices()[0].platform


def bytes_limit() -> int | None:
    """Allocatable bytes on this process's first device, or None where
    the device reports no memory statistics (the CPU backend).  Local,
    because a multi-process runtime answers only for its own devices."""
    stats = jax.local_devices()[0].memory_stats()
    if not stats or "bytes_limit" not in stats:
        return None
    return int(stats["bytes_limit"])


def require_gpu():
    """The device list, or SystemExit when JAX found no GPU.

    Measurement entry points call this first: a number taken on the CPU
    must never be reported under a device metric.
    """
    found = platform()
    if found != "gpu":
        raise SystemExit(
            f"no GPU: JAX runs on {found!r} ({jax.devices()}); this script "
            "measures the GPU and has no CPU fallback"
        )
    return jax.devices()
