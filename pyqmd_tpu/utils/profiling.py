"""Tracing / profiling helpers (SURVEY §5).

The reference's observability is an FPS deque and an on-screen substep meter
(/root/reference/nuclear_sim.py:60, 119-121; rendering.py:224-229) with no
timers around the kernel. The equivalents here: a wall-clock
steps/sec counter with correct device fencing (``block_until_ready``), and
a ``jax.profiler`` trace context for capturing XLA/GPU timelines viewable
in TensorBoard/Perfetto.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque

import jax


class StepTimer:
    """Rolling steps/sec with device fencing.

    The reference's FPS deque (nuclear_sim.py:60) measures the host loop
    only; on an async dispatch runtime that would measure nothing — so
    ``lap`` fences on the result it is handed.
    """

    def __init__(self, window: int = 30):
        self.times: deque[float] = deque(maxlen=window)
        self._last = None

    def start(self):
        self._last = time.perf_counter()

    def reset(self):
        self.times.clear()
        self._last = None

    @property
    def primed(self) -> bool:
        """True once start() (or a lap) has set a reference timestamp."""
        return self._last is not None

    def lap(self, result=None, steps: int = 1) -> float:
        """Fence on ``result`` and record; returns the rolling steps/sec."""
        if result is not None:
            jax.block_until_ready(result)
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            if dt > 0:
                self.times.append(steps / dt)
        self._last = now
        return self.steps_per_sec

    @property
    def steps_per_sec(self) -> float:
        if not self.times:
            return 0.0
        return sum(self.times) / len(self.times)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace (open with TensorBoard or Perfetto)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region inside a trace (shows up on the device timeline)."""
    return jax.profiler.TraceAnnotation(name)
