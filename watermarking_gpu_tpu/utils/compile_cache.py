"""Persistent compilation cache for cold-start avoidance.

JAX's persistent compilation cache stores compiled executables on disk keyed
by program fingerprint, so every process after the first skips XLA and
Triton compilation — the reference's analog is its OpenCL JIT at startup
(reference ``Watermark_GPU/main.cpp:99-118``).

Where the cache lives:

* ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and no
  other directory is set in code;
* otherwise a caller-given path (the ini key ``compilation_cache_dir``);
* otherwise ``.jax_cache/`` at the root of the checkout — a fixed path, so a
  second process finds what the first compiled (the path is part of the
  cache's key).
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> str:
    """``.jax_cache/`` at the root of the checkout (listed in .gitignore)."""
    return str(Path(__file__).resolve().parents[2] / ".jax_cache")


def enable_compilation_cache(path: "str | os.PathLike | None" = None,
                             min_compile_seconds: float = 1.0) -> str:
    """Persist compiled executables across processes; returns the directory.

    Must run before the first compilation. ``JAX_COMPILATION_CACHE_DIR``
    takes precedence over ``path``; with neither, ``default_cache_dir()``.
    Programs whose compile takes less than ``min_compile_seconds`` are not
    persisted (avoids flooding the cache with trivial programs).
    """
    import jax

    env = os.environ.get(ENV_VAR)
    if env:
        directory = env
    else:
        directory = os.fspath(path) if path else default_cache_dir()
        os.makedirs(directory, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", directory)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_seconds))
    return directory
