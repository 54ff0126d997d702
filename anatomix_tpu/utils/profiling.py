"""Profiling / tracing hooks (SURVEY.md §5.1).

The reference only has manual EMA wall-clock timers around
`torch.cuda.synchronize()`; here the same scalar timings exist in the train
loops (data/step EMAs) plus real `jax.profiler` trace capture for TensorBoard
and the host-clock timers in `benchtools` for benchmarks.
"""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace viewable in TensorBoard / Perfetto."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str):
    """Named region in the profiler timeline."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield


class EMATimer:
    """The reference's EMA iteration timers (`trainers/train.py:186-191`)."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.value = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.time()

    def stop(self) -> float:
        dt = time.time() - self._t0
        self.value = (
            dt if self.value == 0.0
            else (1 - self.alpha) * self.value + self.alpha * dt
        )
        return self.value
