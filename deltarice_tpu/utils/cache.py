"""Persistent XLA compilation cache.

The reference C filter has no compile step; the codec's device programs
compile on first use in every process. JAX's persistent compilation cache
keeps compiled executables across processes:

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX uses that directory and this
  module sets nothing;
* otherwise the cache lives at one fixed directory inside the checkout
  (``.jax_cache/``, git-ignored) — a fixed path, because the path is part
  of the cache key;
* ``DELTARICE_TPU_CACHE=0`` disables it.

:func:`enable_persistent_cache` runs lazily from the codec entry points
(never at import, so importing the package does not change a host
application's JAX config).
"""

from __future__ import annotations

import os

import jax

_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_DEFAULT = os.path.join(_CHECKOUT, ".jax_cache")
_enabled = False


def enable_persistent_cache(path: str | None = None) -> str:
    """Enable JAX's persistent compilation cache (idempotent); returns the
    directory in use, or "" when disabled."""
    global _enabled
    if os.environ.get("DELTARICE_TPU_CACHE") == "0":
        return ""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    if path is None and jax.config.jax_compilation_cache_dir:
        return jax.config.jax_compilation_cache_dir  # respect the host app
    cache_dir = path or _DEFAULT
    if not _enabled:
        try:
            os.makedirs(cache_dir, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", cache_dir)
            jax.config.update(
                "jax_persistent_cache_min_compile_time_secs", 1.0
            )
        except Exception:
            return ""  # a read-only checkout must not break the codec
        _enabled = True
    return cache_dir
