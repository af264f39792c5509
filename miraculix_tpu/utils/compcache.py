"""Persistent XLA compilation cache for the CLI / bench entry points.

Production-scale programs pay minute-class compiles; a disk cache lets the
next process skip them.  Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
already reads it and this module sets no directory of its own; otherwise
the cache lives at a fixed path inside the checkout (``.jax_cache/``, which
``.gitignore`` lists) — the path is part of the cache key, so it must not
move between runs.
"""
from __future__ import annotations

import os

_DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compilation_cache() -> bool:
    """Turn on jax's persistent compilation cache.  Returns True when the
    config was applied (not a guarantee the backend honors it).  Set
    MIRACULIX_TPU_COMPILE_CACHE to "0"/"off" to disable it."""
    env = os.environ.get("MIRACULIX_TPU_COMPILE_CACHE")
    if env is not None and env.lower() in ("0", "off", "no", ""):
        return False
    try:
        import jax

        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            os.makedirs(_DEFAULT_DIR, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", _DEFAULT_DIR)
        # cache everything that took noticeable compile time; tiny
        # programs would only churn the directory
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
        return True
    except Exception:
        return False
