"""The persistent XLA compilation cache shared by every entry point.

``enable()`` keeps compiled programs where ``JAX_COMPILATION_CACHE_DIR``
says, if it is set, and otherwise in ``.jax_cache/`` at the checkout root
(listed in ``.gitignore``). The path is fixed, so a rerun from the same
checkout hits the cache; nothing is written outside the checkout unless
the variable asks for it.
"""

from __future__ import annotations

import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(ROOT, ".jax_cache")


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable() -> str:
    """Point JAX's persistent compilation cache at ``cache_dir()`` and
    cache every program, however small or quick to compile."""
    import jax
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return path
