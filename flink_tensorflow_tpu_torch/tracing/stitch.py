"""Cohort trace stitching — merge per-process Chrome traces onto one
timebase.

A distributed job exports ONE trace file per process (the reference's
executor suffixes ``trace_path`` with ``.proc<k>``; the port's does not
write per-process files yet, so this merges files), each stamped with a
``cohort`` block: the process index, pid, the estimated monotonic-clock
offset to process 0 (tracing/clocksync.py), its error bound, and the
tracer's epoch.  ``merge_cohort_traces`` shifts every file's events
into the process-0 clock domain and emits a single Perfetto-loadable
timeline with one *process* group per cohort process (tracks keep their
operator names, prefixed ``p<k>:`` so per-process attribution stays
unambiguous), letting a record's ``emit -> serde -> wire -> queue ->
process`` spans read continuously across the process boundary.

Accuracy: cross-file ordering is exact up to the recorded clock-offset
error bounds (half the best ping RTT per process — microseconds on
loopback, tens of microseconds on a datacenter link), which
``cross_process_traces`` exposes so consumers can reason about edge
cases instead of trusting a false precision.
"""

from __future__ import annotations

import json
import typing

from flink_tensorflow_tpu_torch.tracing.attribution import events_from_chrome

Trace = typing.Dict[str, typing.Any]


def load_trace(path: str) -> Trace:
    with open(path) as f:
        return json.load(f)


def _cohort_meta(trace: Trace, fallback_index: int) -> dict:
    meta = trace.get("cohort")
    if meta is None:
        raise ValueError(
            "trace file carries no 'cohort' block — it was not exported "
            "by a DistributedExecutor cohort process (re-run the job "
            "with JobConfig(distributed=..., trace=True); each process "
            "writes <trace_path>.proc<k>.json)"
        )
    meta = dict(meta)
    meta.setdefault("process_index", fallback_index)
    meta.setdefault("offset_to_proc0_s", 0.0)
    meta.setdefault("error_bound_s", 0.0)
    meta.setdefault("epoch_monotonic_s", 0.0)
    return meta


def merge_cohort_traces(traces: typing.Sequence[Trace]) -> Trace:
    """One merged Chrome trace over the cohort's per-process exports.

    Every event's timestamp moves onto the process-0 monotonic clock:
    ``t_proc0 = ts + epoch_p + offset_p``, re-zeroed on the earliest
    event base across the cohort so the merged file starts near 0.
    """
    if not traces:
        raise ValueError("no trace files to merge")
    metas = [_cohort_meta(t, i) for i, t in enumerate(traces)]
    # Base of file p in proc-0 seconds; the merged origin is the minimum.
    bases = [m["epoch_monotonic_s"] + m["offset_to_proc0_s"] for m in metas]
    ref = min(bases)
    merged_events: typing.List[dict] = []
    processes = []
    next_tid = 1
    for trace, meta, base in zip(traces, metas, bases):
        pidx = int(meta["process_index"])
        out_pid = pidx + 1  # Perfetto pid 0 renders oddly; 1-based
        shift_us = (base - ref) * 1e6
        merged_events.append({
            "ph": "M", "pid": out_pid, "tid": 0, "name": "process_name",
            "args": {"name": f"proc {pidx} (pid {meta.get('pid', '?')})"},
        })
        merged_events.append({
            "ph": "M", "pid": out_pid, "tid": 0,
            "name": "process_sort_index", "args": {"sort_index": pidx},
        })
        # Per-file tid -> (merged tid, prefixed track name).
        names: typing.Dict[int, str] = {}
        for ev in trace.get("traceEvents", []):
            if ev.get("ph") == "M" and ev.get("name") == "thread_name":
                names[ev["tid"]] = ev["args"]["name"]
        tid_map: typing.Dict[int, int] = {}
        for tid, track in sorted(names.items()):
            tid_map[tid] = next_tid
            merged_events.append({
                "ph": "M", "pid": out_pid, "tid": next_tid,
                "name": "thread_name",
                "args": {"name": f"p{pidx}:{track}"},
            })
            merged_events.append({
                "ph": "M", "pid": out_pid, "tid": next_tid,
                "name": "thread_sort_index", "args": {"sort_index": next_tid},
            })
            next_tid += 1
        for ev in trace.get("traceEvents", []):
            ph = ev.get("ph")
            if ph not in ("X", "i"):
                continue
            tid = tid_map.get(ev.get("tid"))
            if tid is None:
                continue
            shifted = dict(ev)
            shifted["pid"] = out_pid
            shifted["tid"] = tid
            shifted["ts"] = round(ev.get("ts", 0.0) + shift_us, 3)
            merged_events.append(shifted)
        processes.append({
            "process_index": pidx,
            "pid": meta.get("pid"),
            "offset_to_proc0_s": meta["offset_to_proc0_s"],
            "error_bound_s": meta["error_bound_s"],
        })
    merged_events.sort(key=lambda ev: (ev.get("ph") == "M" and -1) or 0)
    return {
        "traceEvents": merged_events,
        "displayTimeUnit": "ms",
        "cohort_merge": {
            "processes": processes,
            "max_error_bound_s": max(
                p["error_bound_s"] for p in processes),
        },
    }


def merge_cohort_trace_files(paths: typing.Sequence[str]) -> Trace:
    return merge_cohort_traces([load_trace(p) for p in paths])


def cross_process_traces(
    merged: Trace,
) -> typing.Dict[int, typing.List[tuple]]:
    """``{trace_id: [(t0_s, t1_s, process_index, track, span_name), ...]}``
    for every trace id whose spans touched MORE than one cohort process
    — the stitched record journeys, each sorted by corrected start time
    (the single continuous source -> remote-edge -> sink path per
    record).  Timestamps are merged-timebase seconds."""
    events = events_from_chrome(merged)
    by_id: typing.Dict[int, typing.List[tuple]] = {}
    for track, name, ph, t0, dur, args in events:
        if ph != "X" or not args:
            continue
        trace_id = args.get("trace")
        if trace_id is None:
            continue
        # Merged tracks are "p<k>:<operator>.<subtask>".
        pidx, sep, rest = track.partition(":")
        if not sep or not pidx.startswith("p") or not pidx[1:].isdigit():
            continue
        by_id.setdefault(trace_id, []).append(
            (t0, t0 + dur, int(pidx[1:]), rest, name))
    out = {}
    for trace_id, spans in by_id.items():
        if len({s[2] for s in spans}) > 1:
            out[trace_id] = sorted(spans)
    return out
