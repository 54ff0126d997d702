"""Reduce a `jax.profiler` trace of GPU work to per-op device time.

    python trace_attrib.py <trace_dir> [reps] [top]

`<trace_dir>` is the directory given to `jax.profiler.trace`; `reps` is the
number of calls traced (times are divided by it). The reduction reads the
`.xplane.pb` file with `jax.profiler.ProfileData`, keeps the device planes
(`/device:GPU:<n>`) and sums event durations by name on their "XLA Ops"
line (HLO op names; kernel names on the stream lines where that line is
missing). Device busy time is the union of the op intervals; the window
runs from the first op's start to the last op's end.
"""

from __future__ import annotations

import collections
import glob
import json
import os
import sys


def _device_lines(plane):
    lines = list(plane.lines)
    ops = [ln for ln in lines if ln.name == "XLA Ops"]
    if ops:
        return ops
    return [ln for ln in lines if ln.name.startswith("Stream")]


def _busy_ns(intervals) -> float:
    busy = 0.0
    end = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def device_op_times(trace_dir: str, reps: int = 1, top: int = 25) -> dict:
    """Per-op device milliseconds per call, busy and window milliseconds,
    and the plane and line names seen (for reading a new trace by hand)."""
    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                   "*.xplane.pb"))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    data = ProfileData.from_file(max(paths, key=os.path.getmtime))
    by_op: collections.Counter = collections.Counter()
    intervals = []
    layout = {}
    for plane in data.planes:
        layout[plane.name] = [ln.name for ln in plane.lines][:12]
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in _device_lines(plane):
            for ev in line.events:
                by_op[ev.name] += ev.duration_ns
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not intervals:
        raise ValueError(f"no GPU device events in {trace_dir}")
    window = max(e for _, e in intervals) - min(s for s, _ in intervals)
    busy = _busy_ns(intervals)
    total = sum(by_op.values())
    return {
        "busy_ms_per_call": busy / reps / 1e6,
        "window_ms_per_call": window / reps / 1e6,
        "idle_share": 1.0 - busy / window if window else 0.0,
        "sum_op_ms_per_call": total / reps / 1e6,
        "top_ops": [
            {"name": name, "ms_per_call": ns / reps / 1e6,
             "share": ns / total}
            for name, ns in by_op.most_common(top)
        ],
        "planes": layout,
    }


if __name__ == "__main__":
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    top = int(sys.argv[3]) if len(sys.argv) > 3 else 25
    print(json.dumps(device_op_times(sys.argv[1], reps, top), indent=1))
