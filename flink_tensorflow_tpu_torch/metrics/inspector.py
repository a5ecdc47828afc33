"""Live job inspector — run a pipeline, print per-operator runtime stats.

Port of ``flink_tensorflow_tpu/metrics/inspector.py``:

    python -m flink_tensorflow_tpu_torch.metrics pipeline.py
    python -m flink_tensorflow_tpu_torch.metrics pipeline.py --snapshot-only

``pipeline.py`` defines ``main(argv)`` that builds a port job and calls
``execute``.  ``--live --cohort`` polls process 0's cohort collector
(``executor.cohort_collector.merged_snapshot()``, every process's
metrics merged): the pipeline must configure ``distributed=`` with
``process_index=0``.

The inspector captures a pipeline script's plan the same way the
plan-time analyzer does (``analysis.capture``: the script's ``main`` runs
with ``execute`` patched out, so we get the fully-configured
environment), then ACTUALLY executes the job with the metric plane
attached and prints:

- a per-operator-subtask table: records/sec, p50/p99 record latency,
  queue depth, backpressure fraction, watermark lag;
- one machine-readable JSON snapshot line (``--snapshot-only`` emits only
  this) — the shape benches and CI assertions parse.

Exit code 0 = ran to completion; 2 = capture or execution failed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import typing

Row = typing.Dict[str, typing.Any]

#: Health levels of the reference's ``metrics/health.py`` (``STATE_NAMES``,
#: worst last), the values of the ``health`` scope's gauges.
STATE_NAMES = ("OK", "WARN", "BREACH")

#: Scopes that are job-level, not operator subtasks.
#: Job-level (non-subtask) scopes surfaced in the snapshot's "job"
#: block: checkpoint bookkeeping and, under FLINK_TPU_SANITIZE=1, the
#: concurrency sanitizer's violation/tracked-ops gauges.
_JOB_SCOPES = {"checkpoint", "sanitizer"}


def _split_scope(scope: str) -> typing.Tuple[str, typing.Optional[int]]:
    """``"lenet.0" -> ("lenet", 0)``; non-subtask scopes keep index None."""
    task, dot, tail = scope.rpartition(".")
    if dot and tail.isdigit():
        return task, int(tail)
    return scope, None


def _finite(value: typing.Any) -> typing.Optional[float]:
    if isinstance(value, (int, float)) and not isinstance(value, bool) \
            and math.isfinite(value):
        return float(value)
    return None


def build_rows(snapshot: typing.Dict[str, typing.Dict[str, typing.Any]],
               wall_s: float) -> typing.List[Row]:
    """Fold a ``MetricRegistry.snapshot()`` scope tree into one row per
    operator subtask with the inspector's canonical fields.  Every row
    carries every key (None where the runtime had nothing to measure —
    e.g. watermark lag on a processing-time pipeline)."""
    rows: typing.List[Row] = []
    for scope in sorted(snapshot):
        task, index = _split_scope(scope)
        if index is None or task in _JOB_SCOPES:
            continue
        m = snapshot[scope]
        records_in = (m.get("records_in") or {}).get("count", 0)
        records_out = (m.get("records_out") or {}).get("count", 0)
        processed = records_in or records_out
        # Per-record latency: the model runner's device-inclusive number
        # when present, else the operator's host processing latency.
        lat = m.get("record_latency_s") or m.get("process_latency_s") or {}
        busy = _finite((m.get("process_latency_s") or {}).get("total_s"))
        blocked = _finite(m.get("backpressure_s")) or 0.0
        rows.append({
            "operator": task,
            "subtask": index,
            "records_in": records_in,
            "records_out": records_out,
            "records_per_s": (processed / wall_s) if wall_s > 0 else None,
            "p50_latency_s": _finite(lat.get("p50")),
            "p99_latency_s": _finite(lat.get("p99")),
            # Sources have no input gate: their queue depth is genuinely 0.
            "queue_depth": m.get("queue_depth") or 0,
            "queue_high_watermark": m.get("queue_high_watermark") or 0,
            "backpressure_s": blocked,
            "backpressure_fraction":
                min(1.0, blocked / wall_s) if wall_s > 0 else None,
            "busy_fraction":
                min(1.0, busy / wall_s) if busy is not None and wall_s > 0 else None,
            "watermark_lag_s": _finite(m.get("watermark_lag_s")),
        })
    return rows


def _fmt(value: typing.Any, scale: float = 1.0, digits: int = 2) -> str:
    if value is None:
        return "-"
    if isinstance(value, float):
        return f"{value * scale:.{digits}f}"
    return str(value)


def format_table(rows: typing.Sequence[Row]) -> str:
    header = ["operator", "rec/s", "p50 ms", "p99 ms", "queue",
              "bp %", "busy %", "wm lag s"]
    body = [[
        f"{r['operator']}.{r['subtask']}",
        _fmt(r["records_per_s"], digits=1),
        _fmt(r["p50_latency_s"], 1e3),
        _fmt(r["p99_latency_s"], 1e3),
        _fmt(r["queue_depth"]),
        _fmt(r["backpressure_fraction"], 100, 1),
        _fmt(r["busy_fraction"], 100, 1),
        _fmt(r["watermark_lag_s"], digits=3),
    ] for r in rows]
    widths = [max(len(h), *(len(b[i]) for b in body)) if body else len(h)
              for i, h in enumerate(header)]
    lines = ["  ".join(h.ljust(w) for h, w in zip(header, widths))]
    lines.append("  ".join("-" * w for w in widths))
    for b in body:
        lines.append("  ".join(c.ljust(w) for c, w in zip(b, widths)))
    return "\n".join(lines)


def inspect_pipeline(
    path: str,
    job_args: typing.Sequence[str] = ("--smoke", "--cpu"),
    *,
    report_interval_s: typing.Optional[float] = None,
    jsonl_path: typing.Optional[str] = None,
    prometheus_path: typing.Optional[str] = None,
    timeout_s: float = 600.0,
) -> typing.Dict[str, typing.Any]:
    """Capture ``path``'s plan, execute it with the metric plane attached,
    and return the job snapshot (the JSON the CLI prints)."""
    from flink_tensorflow_tpu_torch.analysis.capture import capture_pipeline_file

    env = capture_pipeline_file(path, job_args)
    metrics_cfg = dataclasses.replace(
        env.config.metrics,
        report_interval_s=report_interval_s,
        jsonl_path=jsonl_path,
        prometheus_path=prometheus_path,
    )
    env.configure(metrics=metrics_cfg)
    from flink_tensorflow_tpu_torch.analysis.chaining import compute_chains

    plan = compute_chains(env.graph, enabled=env.config.chaining)
    t0 = time.monotonic()
    env.execute("inspect", timeout=timeout_s)
    wall_s = time.monotonic() - t0
    tree = env.metric_registry.snapshot()
    job_level = {scope: tree[scope] for scope in _JOB_SCOPES if scope in tree}
    return {
        "pipeline": path,
        "wall_s": wall_s,
        # The execution chain topology (analysis/chaining.py): which
        # operators share a subtask thread — fused members pass records
        # by direct call and show no queue gauges at all.
        "chains": plan.names(),
        "chained_edges": plan.chained_edge_count,
        "subtasks": build_rows(tree, wall_s),
        "job": job_level,
    }


def build_live_rows(snapshot: typing.Dict[str, typing.Dict[str, typing.Any]]) -> typing.List[Row]:
    """One row per operator subtask from a single reporter snapshot —
    the live view's per-frame fold.  Rates are the meters' WINDOW rates
    (events/sec since the previous report; the reporter thread owns the
    window cadence), so each frame shows current throughput, not the
    lifetime average."""
    rows: typing.List[Row] = []
    # Health plane (metrics/health.py): the process-0 evaluator
    # publishes per-operator verdicts as numeric gauges under the
    # "health" scope — merged snapshots carry them for free, so the
    # live table's health column needs no extra plumbing.
    health = snapshot.get("health") or {}
    for scope in sorted(snapshot):
        task, index = _split_scope(scope)
        if index is None or task in _JOB_SCOPES:
            continue
        m = snapshot[scope]
        rec_in = m.get("records_in") or {}
        rec_out = m.get("records_out") or {}
        rows.append({
            "operator": task,
            "subtask": index,
            "health": _health_name(health.get(task)),
            "records_in": rec_in.get("count", 0),
            "in_per_s": _finite(rec_in.get("window_rate")),
            "out_per_s": _finite(rec_out.get("window_rate")),
            "queue_depth": m.get("queue_depth") or 0,
            "queue_high_watermark": m.get("queue_high_watermark") or 0,
            "backpressure_s": _finite(m.get("backpressure_s")) or 0.0,
            "idle_s": _finite(m.get("idle_s")),
            "watermark_lag_s": _finite(m.get("watermark_lag_s")),
            "splits_completed": m.get("splits_completed"),
            # Roofline plane (metrics/roofline.py): model operators under
            # JobConfig.roofline publish MFU against the declared
            # DeviceSpec peak and a bound classification; None keeps the
            # column out of the table entirely.
            "mfu_pct": _finite(m.get("roofline.mfu_pct")),
            "bound": _bound_name(m.get("roofline.bound")),
        })
    return rows


def _bound_name(code: typing.Any) -> typing.Optional[str]:
    """``roofline.bound`` gauge code -> "compute"/"memory"/"host"/"wire"
    (None when the operator publishes no roofline gauges)."""
    if isinstance(code, bool) or not isinstance(code, (int, float)):
        return None
    from flink_tensorflow_tpu_torch.metrics.roofline import BOUND_NAMES

    idx = int(code)
    if 0 <= idx < len(BOUND_NAMES):
        return BOUND_NAMES[idx]
    return None


def _health_name(state: typing.Any) -> typing.Optional[str]:
    """``health`` scope gauge value -> "OK"/"WARN"/"BREACH" (None when
    no evaluator published a verdict for the operator)."""
    if isinstance(state, bool) or not isinstance(state, (int, float)):
        return None
    idx = int(state)
    if 0 <= idx < len(STATE_NAMES):
        return STATE_NAMES[idx]
    return None


def format_live_table(rows: typing.Sequence[Row]) -> str:
    # The health column only appears when some row carries a verdict —
    # jobs without JobConfig.health keep the pre-health layout.  Same
    # rule for the roofline columns (JobConfig.roofline unset = the
    # pre-roofline layout).
    with_health = any(r.get("health") is not None for r in rows)
    with_roofline = any(r.get("mfu_pct") is not None
                        or r.get("bound") is not None for r in rows)
    header = ["operator", "in", "in/s", "out/s", "queue", "q.hwm",
              "bp s", "idle s", "wm lag s"]
    if with_roofline:
        header += ["mfu%", "bound"]
    if with_health:
        header.append("health")
    body = [[
        f"{r['operator']}.{r['subtask']}",
        _fmt(r["records_in"]),
        _fmt(r["in_per_s"], digits=1),
        _fmt(r["out_per_s"], digits=1),
        _fmt(r["queue_depth"]),
        _fmt(r["queue_high_watermark"]),
        _fmt(r["backpressure_s"], digits=2),
        _fmt(r["idle_s"], digits=2),
        _fmt(r["watermark_lag_s"], digits=3),
    ] + ([_fmt(r.get("mfu_pct"), digits=2), r.get("bound") or "-"]
         if with_roofline else [])
      + ([r.get("health") or "-"] if with_health else [])
        for r in rows]
    widths = [max(len(h), *(len(b[i]) for b in body)) if body else len(h)
              for i, h in enumerate(header)]
    lines = ["  ".join(h.ljust(w) for h, w in zip(header, widths))]
    lines.append("  ".join("-" * w for w in widths))
    for b in body:
        lines.append("  ".join(c.ljust(w) for c, w in zip(b, widths)))
    return "\n".join(lines)


def live_inspect(
    path: str,
    job_args: typing.Sequence[str] = ("--smoke", "--cpu"),
    *,
    interval_s: float = 1.0,
    stream: typing.Optional[typing.TextIO] = None,
    max_frames: typing.Optional[int] = None,
    timeout_s: float = 600.0,
    cohort: bool = False,
) -> typing.Dict[str, typing.Any]:
    """``flink-tpu-inspect --live``: run the pipeline with a reporter
    thread attached and render a top-style per-operator frame each
    interval, polling the reporter stream (a
    :class:`~flink_tensorflow_tpu_torch.metrics.reporters.
    LatestSnapshotReporter` sink) — the first in-repo consumer of the
    runtime gauges.  With ``cohort=True`` (``--live --cohort``) the
    frames poll the process-0 :class:`~flink_tensorflow_tpu_torch.metrics.
    cohort.CohortCollector` instead — per-operator rows AGGREGATED over
    every cohort process (the same merged snapshot the autoscaling
    supervisor consumes); requires the pipeline to configure
    ``distributed=`` with ``process_index=0``.  Returns the final job
    snapshot (same shape as :func:`inspect_pipeline`)."""
    from flink_tensorflow_tpu_torch.analysis.capture import capture_pipeline_file
    from flink_tensorflow_tpu_torch.metrics.reporters import LatestSnapshotReporter

    out = stream or sys.stdout
    env = capture_pipeline_file(path, job_args)
    latest = LatestSnapshotReporter()
    env.configure(metrics=dataclasses.replace(
        env.config.metrics,
        report_interval_s=interval_s,
        reporters=(*env.config.metrics.reporters, latest),
    ))
    t0 = time.monotonic()
    handle = env.execute_async("inspect-live")
    collector = None
    if cohort:
        collector = getattr(handle.executor, "cohort_collector", None)
        if collector is None:
            handle.executor.cancel()
            handle.wait(timeout=timeout_s)
            raise ValueError(
                "--cohort needs the process-0 member of a distributed "
                "job: configure JobConfig(distributed=DistributedConfig("
                "process_index=0, ...)) in the pipeline (peers run the "
                "same script with their own process_index and push to "
                "this collector)")
    done = handle.executor._all_done
    frames = 0
    clear = "\x1b[2J\x1b[H" if getattr(out, "isatty", lambda: False)() else ""
    try:
        while True:
            finished = done.wait(interval_s)
            if collector is not None:
                report = collector.merged_snapshot()
            else:
                report = latest.latest()
            if report is not None:
                ts, snapshot = report
                stamp = time.strftime("%H:%M:%S", time.localtime(ts))
                frames += 1
                scope_note = ""
                if collector is not None:
                    reporting = 1 + len(collector.peers_reporting)
                    scope_note = (f", cohort {reporting}/"
                                  f"{collector.num_processes} procs")
                print(f"{clear}== {path} [live {stamp}, frame {frames}, "
                      f"{time.monotonic() - t0:.1f}s{scope_note}] ==",
                      file=out)
                print(format_live_table(build_live_rows(snapshot)), file=out)
                out.flush()
            if finished or (max_frames is not None and frames >= max_frames):
                break
            if time.monotonic() - t0 > timeout_s:
                break
    finally:
        handle.executor.cancel()
        handle.wait(timeout=timeout_s)
    wall_s = time.monotonic() - t0
    if collector is not None:
        tree = collector.merged_snapshot()[1]
    else:
        tree = env.metric_registry.snapshot()
    result = {
        "pipeline": path,
        "wall_s": wall_s,
        "frames": frames,
        "subtasks": build_rows(tree, wall_s),
        "job": {scope: tree[scope] for scope in _JOB_SCOPES if scope in tree},
    }
    if collector is not None:
        result["cohort"] = {
            "num_processes": collector.num_processes,
            "peers_reporting": collector.peers_reporting,
            "pushes": collector.pushes,
        }
    return result


def main(argv: typing.Optional[typing.Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m flink_tensorflow_tpu_torch.metrics",
        description="Job inspector: execute a pipeline script with runtime "
                    "instrumentation attached and print per-operator rate, "
                    "latency percentiles, queue depth, backpressure, and "
                    "watermark lag.",
    )
    parser.add_argument("pipelines", nargs="+", metavar="pipeline.py",
                        help="pipeline script(s) defining main(argv)")
    parser.add_argument("--job-args", default="--smoke --cpu",
                        help="argv passed to each pipeline's main() "
                             "(default: '--smoke --cpu')")
    parser.add_argument("--interval", type=float, default=None,
                        help="live report interval in seconds (default: no "
                             "reporter thread; one snapshot at completion)")
    parser.add_argument("--jsonl", default=None, metavar="PATH",
                        help="also append JSON-lines reports to PATH")
    parser.add_argument("--prometheus", default=None, metavar="PATH",
                        help="also maintain a Prometheus exposition file")
    parser.add_argument("--timeout", type=float, default=600.0,
                        help="job execution timeout in seconds")
    parser.add_argument("--snapshot-only", action="store_true",
                        help="emit only the machine-readable JSON snapshot")
    parser.add_argument("--live", action="store_true",
                        help="top-style live view: render a per-operator "
                             "frame (records/s, queue depth, backpressure, "
                             "watermark lag) each interval while the job "
                             "runs, polling the reporter stream")
    parser.add_argument("--live-interval", type=float, default=1.0,
                        help="live-view frame period in seconds (default 1.0)")
    parser.add_argument("--cohort", action="store_true",
                        help="with --live on the process-0 member of a "
                             "distributed job: render rows aggregated over "
                             "the WHOLE cohort (the CohortCollector's merged "
                             "snapshot — meters summed, reservoirs merged, "
                             "gauges per policy) instead of this process "
                             "alone")
    args = parser.parse_args(argv)
    if args.cohort and not args.live:
        parser.error("--cohort requires --live")

    exit_code = 0
    for path in args.pipelines:
        try:
            if args.live:
                snap = live_inspect(
                    path, args.job_args.split(),
                    interval_s=args.live_interval,
                    timeout_s=args.timeout,
                    cohort=args.cohort,
                )
            else:
                snap = inspect_pipeline(
                    path, args.job_args.split(),
                    report_interval_s=args.interval,
                    jsonl_path=args.jsonl,
                    prometheus_path=args.prometheus,
                    timeout_s=args.timeout,
                )
        except Exception as ex:  # noqa: BLE001 - report and keep going
            print(f"{path}: inspection failed: {ex}", file=sys.stderr)
            exit_code = max(exit_code, 2)
            continue
        if not args.snapshot_only and not args.live:
            print(f"== {path} ({snap['wall_s']:.2f}s wall, "
                  f"{len(snap['chains'])} chain(s), "
                  f"{snap['chained_edges']} fused edge(s)) ==")
            for members in snap["chains"]:
                print("chain: " + " -> ".join(members))
            print(format_table(snap["subtasks"]))
        from flink_tensorflow_tpu_torch.metrics.reporters import json_safe

        print(json.dumps(json_safe(snap)))
    return exit_code


def cli() -> None:
    """``python -m flink_tensorflow_tpu_torch.metrics``."""
    sys.exit(main())
