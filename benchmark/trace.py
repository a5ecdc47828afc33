"""Device readings from a ``torch.profiler`` slice of the window.

The profiler traces the card through CUPTI; from its device events
(kernels, copies, sets) this module takes the busy time (the union of
their intervals), kernel time, host-to-device copy time, the
device operations that took most time, and the longest idle gaps
between device operations, each named by the innermost host-side event
the trace shows at the gap's middle (with the device's activity alone
traced, the CUDA runtime calls; "host in Python" where there is none)
and by the device operation before it.  Nothing is exported to
disk.  The arithmetic is that of the program's
``models/inception_trace.py`` and ``functions/train_trace.py``, copied
so the yardstick does not move with the program.
"""

from __future__ import annotations

import bisect
import dataclasses
import typing

TOP = 10


@dataclasses.dataclass
class Slice:
    """What one profiled slice of the window held."""

    window_s: float
    busy_s: float
    kernel_s: float
    h2d_s: float
    device_ops: typing.List[typing.Tuple[str, float]]
    idle_gaps: typing.List[typing.Tuple[str, float]]


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def union(intervals: typing.Sequence[typing.Tuple[float, float]]) -> typing.List[
        typing.Tuple[float, float]]:
    """Merged, sorted intervals."""
    merged: typing.List[typing.List[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(s, e) for s, e in merged]


def summarize(device: typing.Sequence[typing.Tuple[float, float, str]],
              host: typing.Sequence[typing.Tuple[float, float, str]],
              lo_us: float, hi_us: float) -> Slice:
    """``device`` and ``host`` are ``(start_us, end_us, name)`` events on
    one clock; the slice is ``[lo_us, hi_us)`` on it.  Device events are
    cut to the slice: what ran while the profiler was starting or
    stopping is not the slice's."""
    device = [(max(s, lo_us), min(e, hi_us), n) for s, e, n in device if e > lo_us and s < hi_us]
    window_s = (hi_us - lo_us) / 1e6
    busy = union([(s, e) for s, e, _ in device])
    by_name: typing.Dict[str, float] = {}
    kernel_us = h2d_us = 0.0
    for s, e, name in device:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
        if name.startswith("Memcpy HtoD"):
            h2d_us += e - s
        elif not _is_copy(name):
            kernel_us += e - s
    host = sorted(host)
    starts = [s for s, _, _ in host]
    by_end = sorted((e, name) for _, e, name in device)
    ends = [e for e, _ in by_end]
    longest = sorted(((nxt - end, end) for (_, end), (nxt, _) in zip(busy, busy[1:])),
                     reverse=True)[:TOP]
    gaps = []
    for length, end in longest:
        mid = end + length / 2
        covering = [h for h in host[:bisect.bisect_right(starts, mid)] if h[1] >= mid]
        name = min(covering, key=lambda h: h[1] - h[0])[2] if covering else "host in Python"
        before = by_end[bisect.bisect_right(ends, end) - 1][1]
        gaps.append((f"{name[:40]}, after {before[:70]}", length / 1e6))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return Slice(window_s, sum(e - s for s, e in busy) / 1e6, kernel_us / 1e6, h2d_us / 1e6,
                 [(n[:120], us / 1e6) for n, us in ops], gaps)


def from_profiler(prof, start_ns: int, end_ns: int) -> Slice:
    """The slice ``[start_ns, end_ns)`` (``time.time_ns()``) of what a
    stopped ``torch.profiler.profile`` recorded: its events are in
    microseconds from the trace's start, which it keeps on that clock."""
    import torch

    origin = prof.profiler.kineto_results.trace_start_ns()
    device, host = [], []
    for evt in prof.events():
        start, end = evt.time_range.start, evt.time_range.end
        if end <= start:
            continue
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            device.append((start, end, evt.name))
        else:
            host.append((start, end, evt.name))
    return summarize(device, host, (start_ns - origin) / 1e3, (end_ns - origin) / 1e3)
