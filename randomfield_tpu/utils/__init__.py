"""Small utilities: timing, device info, compile cache."""

from randomfield_tpu.utils.cache import enable_compile_cache
from randomfield_tpu.utils.timing import Timer, block_and_time

__all__ = ["Timer", "block_and_time", "enable_compile_cache"]
