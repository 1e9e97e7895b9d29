"""Profiling hooks.

The reference's only observability is wall-clock prints (SURVEY.md §5); the
framework adds an optional JAX profiler trace around any section —
inspect with TensorBoard or xprof.
"""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Capture a jax.profiler trace into `log_dir` (no-op when None)."""
    if not log_dir:
        yield
        return
    with jax.profiler.trace(log_dir):
        yield


@contextlib.contextmanager
def annotate(name: str):
    """Named span that shows up in profiler timelines."""
    with jax.profiler.TraceAnnotation(name):
        yield
