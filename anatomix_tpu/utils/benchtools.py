"""Host-clock timing of device work.

JAX dispatches asynchronously: a call returns once its work is queued, not
when the device has finished it. Every timing here therefore ends in
`jax.block_until_ready` on the full output; without it the clock would
measure the enqueue. The first call of a new shape compiles, so it is
reported apart from the steady calls.
"""

from __future__ import annotations

import time

import jax


def time_calls(fn, *args, reps: int = 3):
    """Run `fn(*args)` once cold and `reps` times warm.

    Returns `(first_seconds, steady_seconds, out)`: the wall time of the
    first call (compilation included), the median of the warm calls, and
    the last output."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return first, times[len(times) // 2], out
