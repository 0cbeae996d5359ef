"""Utilities: compilation caching, warm-up, profiling."""

from .cache import enable_persistent_cache
from .profiling import device_trace

__all__ = [
    "enable_persistent_cache",
    "device_trace",
]
