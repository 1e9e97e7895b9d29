"""Wall-clock timing with device synchronization.

Counterpart of the reference ``timer`` namespace
(``/root/reference/Watermark_GPU/Utilities.hpp:20-26``): JAX dispatch is async,
so timed sections must end with ``jax.block_until_ready`` to measure real
device time (the reference relies on ``queue.finish()`` inside each op).
"""

from __future__ import annotations

import time

import jax


class Timer:
    def __init__(self):
        self._start = 0.0
        self._end = 0.0

    def start(self) -> None:
        self._start = time.perf_counter()

    def end(self, *sync_values) -> None:
        """Stop the clock, first blocking on any provided device values."""
        for value in sync_values:
            jax.block_until_ready(value)
        self._end = time.perf_counter()

    @property
    def elapsed_seconds(self) -> float:
        return self._end - self._start


def execution_time(show_fps: bool, seconds: float) -> str:
    """Format like the reference (main.cpp:464-467)."""
    if show_fps:
        return f"FPS: {1.0 / seconds:.2f} FPS"
    return f"{seconds:.6f} seconds"
