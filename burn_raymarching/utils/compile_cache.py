"""Where JAX keeps its persistent compilation cache.

Every entry point calls ``configure_compile_cache`` before it compiles
anything. ``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and
wins: nothing else is set in code. Otherwise the cache lives at one fixed
path inside the checkout (``.jax_cache/``, listed in .gitignore), so the
path — part of the cache key — does not move between runs.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def configure_compile_cache() -> None:
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
