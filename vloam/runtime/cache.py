"""Cache directories: the persistent XLA compilation cache shared by
every entry point, and generated-frame caches for benchmarks and evals.

The fused chunks take the better part of a minute to compile cold; a warm
cache makes repeat runs start in seconds. Where JAX_COMPILATION_CACHE_DIR
is set, JAX reads it itself and no other path is set in code; otherwise the
cache lives in one fixed directory inside the checkout (the path is part of
the cache key, so it must not move between runs).
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = Path(__file__).resolve().parents[2]
CHECKOUT_CACHE = CHECKOUT / ".jax_cache"


def compile_cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get(ENV_VAR) or str(CHECKOUT_CACHE)


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path


def frame_cache_dir(name: str) -> Path:
    """A directory inside the checkout for generated frames."""
    path = CHECKOUT / ".cache" / name
    path.mkdir(parents=True, exist_ok=True)
    return path
