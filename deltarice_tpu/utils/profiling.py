"""Profiling helpers.

The reference has no tracing at all (performance numbers came from external
wall-clock scripts). Here a context manager wraps ``jax.profiler`` for
device traces.
"""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a jax.profiler device trace around a block into ``logdir``
    (read with ``jax.profiler.ProfileData``, TensorBoard or xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
