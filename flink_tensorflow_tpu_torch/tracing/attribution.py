"""Latency attribution — fold a span stream into a per-operator stage table.

The profiler half of the tracing plane: given the tracer's events (or a
Chrome trace file it exported), aggregate the stage spans per operator
and report p50/p95/p99/total per stage.  The canonical stages tile a
batch's end-to-end path:

- ``queue``   — channel enqueue -> delivery at the downstream subtask
- ``h2d``     — host assemble + host->device wire transfer + jit launch
- ``compute`` — launch -> the fetch thread reaching the batch (device
  compute, overlapped with earlier batches' fetches)
- ``d2h``     — the batch's own device->host fetch round trip
- ``serde``   — record encode/decode on remote edges
- ``wire``    — socket send time on remote edges

Other spans (``process``, ``emit``, ``align``, ``snapshot``,
``split.read``, ``lane_wait``, ...) are aggregated too and listed after
the canonical block.  Device-resident elisions (``h2d.elided`` /
``d2h.elided`` instants — batches whose transfer never happened because
the chain kept them HBM-resident) appear as count-only rows, so a
model->model chain's table shows ONE h2d and ONE d2h column of real
spans plus the matching elision counts on the other side.  Pure
functions over event tuples — unit-testable with synthetic data, no
runtime required.
"""

from __future__ import annotations

import typing

#: Canonical stage order of the attribution table.
STAGES = ("queue", "h2d", "compute", "d2h", "serde", "wire")

Row = typing.Dict[str, typing.Any]


def _percentile(sorted_vals: typing.Sequence[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted sample."""
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1, int(round(q / 100.0 * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def _operator_of(track: str) -> typing.Optional[str]:
    """``"lenet.0" -> "lenet"``; job-level tracks (no ``.N`` suffix)
    return None and stay out of the per-operator table."""
    task, dot, tail = track.rpartition(".")
    if dot and tail.isdigit():
        return task
    return None


def attribution(events: typing.Iterable[tuple]) -> typing.Dict[str, typing.Dict[str, Row]]:
    """``{operator: {stage: {count, p50_ms, p95_ms, p99_ms, total_ms}}}``
    over the tracer's ``(track, name, ph, t0, dur, args)`` events."""
    samples: typing.Dict[str, typing.Dict[str, typing.List[float]]] = {}
    elisions: typing.Dict[str, typing.Dict[str, int]] = {}
    for track, name, ph, _t0, dur, _args in events:
        op = _operator_of(track)
        if op is None:
            continue
        if ph == "X":
            samples.setdefault(op, {}).setdefault(name, []).append(dur * 1e3)
        elif ph == "i" and name.endswith(".elided"):
            # Device-resident elision markers: transfers that never
            # happened have no duration — count them so the table shows
            # the elision next to the real h2d/d2h rows.
            per_op = elisions.setdefault(op, {})
            per_op[name] = per_op.get(name, 0) + 1
    out: typing.Dict[str, typing.Dict[str, Row]] = {}
    for op, stages in samples.items():
        rows: typing.Dict[str, Row] = {}
        for stage, vals in stages.items():
            vals.sort()
            rows[stage] = {
                "count": len(vals),
                "p50_ms": round(_percentile(vals, 50), 3),
                "p95_ms": round(_percentile(vals, 95), 3),
                "p99_ms": round(_percentile(vals, 99), 3),
                "total_ms": round(sum(vals), 3),
            }
        out[op] = rows
    for op, names in elisions.items():
        rows = out.setdefault(op, {})
        for name, count in names.items():
            rows[name] = {"count": count, "p50_ms": 0.0, "p95_ms": 0.0,
                          "p99_ms": 0.0, "total_ms": 0.0}
    return out


def events_from_chrome(trace: dict) -> typing.List[tuple]:
    """Reconstruct ``(track, name, ph, t0, dur, args)`` event tuples from
    an exported Chrome trace dict — the file round-trip path of the CLI
    (``flink-tpu-trace --from-file trace.json``)."""
    names: typing.Dict[int, str] = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            names[ev["tid"]] = ev["args"]["name"]
    out: typing.List[tuple] = []
    for ev in trace.get("traceEvents", []):
        ph = ev.get("ph")
        if ph not in ("X", "i"):
            continue
        track = names.get(ev.get("tid"), f"tid{ev.get('tid')}")
        out.append((track, ev.get("name"), ph, ev.get("ts", 0.0) / 1e6,
                    ev.get("dur", 0.0) / 1e6, ev.get("args")))
    out.sort(key=lambda e: e[3])
    return out


def format_attribution_table(attr: typing.Dict[str, typing.Dict[str, Row]]) -> str:
    """Render the per-operator stage table: canonical stages first (in
    pipeline order), remaining spans after, skipping stages an operator
    never recorded."""
    header = ["operator", "stage", "count", "p50 ms", "p95 ms", "p99 ms", "total ms"]
    body: typing.List[typing.List[str]] = []
    for op in sorted(attr):
        rows = attr[op]
        ordered = [s for s in STAGES if s in rows] + sorted(
            s for s in rows if s not in STAGES)
        for stage in ordered:
            r = rows[stage]
            body.append([
                op, stage, str(r["count"]),
                f"{r['p50_ms']:.3f}", f"{r['p95_ms']:.3f}",
                f"{r['p99_ms']:.3f}", f"{r['total_ms']:.3f}",
            ])
    widths = [max(len(h), *(len(b[i]) for b in body)) if body else len(h)
              for i, h in enumerate(header)]
    lines = ["  ".join(h.ljust(w) for h, w in zip(header, widths)),
             "  ".join("-" * w for w in widths)]
    for b in body:
        lines.append("  ".join(c.ljust(w) for c, w in zip(b, widths)))
    return "\n".join(lines)
