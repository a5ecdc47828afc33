"""Profiling hooks — the device-side view beside the span tracer.

Port of ``flink_tensorflow_tpu/utils/profiling.py`` in PyTorch's idiom:

- :func:`trace` — context manager around a block; records a
  ``torch.profiler`` trace with CPU and CUDA activities and writes it as
  a Chrome trace (Perfetto-loadable) under ``log_dir``.  Where CUDA
  activity cannot be traced (no card, or CUPTI does not start) it
  raises: a CPU-only trace is never handed back as a device trace.
  Given the job's span tracer, it writes the tracer's spans into the same
  ``trace.json``, shifted onto the profiler's clock
  (:func:`merge_tracer`): one Perfetto timeline in which each device
  idle gap sits under the program span open at the time.
- :func:`annotate_batch` — names one micro-batch execution
  (``torch.profiler.record_function``), so the trace attributes device
  work to operator + batch number.
- :func:`device_memory_stats` — ``torch.cuda.memory_stats`` under the
  reference's keys (``bytes_in_use``, ``peak_bytes_in_use``,
  ``bytes_limit``); the runtime's ``hbm_bytes_in_use`` gauges read it.
"""

from __future__ import annotations

import contextlib
import json
import os
import typing

import torch


@contextlib.contextmanager
def trace(log_dir: str, *, record_shapes: bool = False, tracer=None):
    """Record a ``torch.profiler`` trace of the enclosed block (CPU and
    CUDA activities) and export it to ``<log_dir>/trace.json``; with
    ``tracer`` (a :class:`~flink_tensorflow_tpu_torch.tracing.Tracer`),
    its spans join the file on the profiler's clock.

    Raises ``RuntimeError`` when CUDA is unavailable or the profiler
    comes back without its CUDA activity (CUPTI did not start)."""
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("profiling.trace records device activity and needs CUDA")
    if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
        raise RuntimeError("torch.profiler cannot trace CUDA here (CUPTI unavailable)")
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   record_shapes=record_shapes)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(path)
        if tracer is not None:
            with open(path) as f:
                merged = merge_tracer(json.load(f), tracer)
            with open(path, "w") as f:
                json.dump(merged, f)


def merge_tracer(profile: dict, tracer) -> dict:
    """``profile`` (a ``torch.profiler`` Chrome trace) with ``tracer``'s
    tracks added under a process of their own.  The profiler's ``ts`` is
    microseconds after ``baseTimeNanoseconds`` on the Unix clock (after
    the epoch where the file has no base); each span is placed there
    through :meth:`Tracer.to_unix_ns`."""
    from flink_tensorflow_tpu_torch.tracing.tracer import events_to_chrome

    events = tracer.events()    # re-reads the tracer's clock anchor
    base_ns = int(profile.get("baseTimeNanoseconds", 0))
    mono, unix_ns = tracer.clock
    # The monotonic instant at the profiler's ts 0: ts = (t - epoch) * 1e6.
    epoch = mono - (unix_ns - base_ns) / 1e9
    rows = profile.get("traceEvents", [])
    pids = [ev["pid"] for ev in rows if isinstance(ev.get("pid"), int)]
    pid = max(pids, default=0) + 1
    spans = events_to_chrome(events, epoch=epoch, process_name="flink-tensorflow-tpu spans")
    for ev in spans["traceEvents"]:
        ev["pid"] = pid
    out = dict(profile)
    out["traceEvents"] = list(rows) + spans["traceEvents"]
    out["clock"] = tracer.clock_meta()
    return out


def annotate_batch(scope: str, step: int):
    """Step annotation for one dispatched batch: a named region on the
    trace timeline (``scope`` = operator subtask)."""
    return torch.profiler.record_function(f"{scope}#{step}")


def device_memory_stats(device: typing.Any = None) -> typing.Dict[str, int]:
    """Live device memory of ``device`` (default: the current CUDA
    device) under the reference's keys.  A CPU device has no device
    memory and gives ``{}``, as the reference does on backends without
    memory stats; ``None`` without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return {}
    if not torch.cuda.is_available():
        raise RuntimeError("device_memory_stats: CUDA is not available")
    stats = torch.cuda.memory_stats(dev)
    _, total = torch.cuda.mem_get_info(dev)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
        "bytes_limit": int(total),
        "num_allocs": int(stats.get("allocation.all.allocated", 0)),
    }
