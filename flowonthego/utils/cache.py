"""Persistent compilation cache: one policy for the CLI, scripts, tools
and tests.

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself; nothing here
  names another directory.
* Otherwise: one fixed directory inside the checkout, ``.jax_cache/``
  (git-ignored).  The path is part of what a later process looks up, so
  it never moves.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache; returns its directory."""
    import jax

    path = os.environ.get(ENV_VAR)
    if not path:
        path = REPO_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    # 0.1 s: the test suite's mid-size programs (per-scale solves, resize
    # forms, oracle helpers) compile in 0.1-0.5 s each; at the default
    # 0.5 s threshold they are recompiled by every process.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    return path
