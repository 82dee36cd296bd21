"""Persistent XLA compilation cache.

Every stage compiles one program per power-of-two shape bucket, so a
cold run spends minutes compiling; an on-disk cache pays that once per
(program, shape). Enabled by the CLI and the benchmark scripts.
"""

from __future__ import annotations

import os

_DEFAULT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")


def enable_compilation_cache() -> str:
    """Idempotently turn on the JAX persistent compilation cache.

    The directory is ``JAX_COMPILATION_CACHE_DIR`` where that is set, and
    the checkout's fixed ``.jax_cache`` otherwise (the path is part of
    the cache key, so it must not move between runs). Returns the
    directory, or "" where the cache stays off.

    GPU only: XLA:CPU persists ahead-of-time machine code keyed without
    the host's CPU feature set, so an entry written on one machine can
    crash the process that loads it on another, and CPU compiles are
    short enough not to need it.
    """
    import jax
    if jax.default_backend() != "gpu":
        return ""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or _DEFAULT
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    # every program: a run compiles hundreds, most in under a second
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
