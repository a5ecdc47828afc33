"""The span tracer's CLI — execute a port pipeline under span tracing and
print the per-operator latency-attribution table (port of
``flink_tensorflow_tpu/tracing/cli.py``).

    python -m flink_tensorflow_tpu_torch.tracing pipeline.py --out p.trace.json
    python -m flink_tensorflow_tpu_torch.tracing --from-file p.trace.json
    python -m flink_tensorflow_tpu_torch.tracing --cohort t.proc0.json t.proc1.json
    python -m flink_tensorflow_tpu_torch.tracing --from-flight-dump flight.json

``pipeline.py`` defines ``main(argv)``, which builds a job on the port's
``StreamExecutionEnvironment`` and calls ``execute``; ``--job-args``
is its argv.

Captures the pipeline's plan the same way the analyzer/inspector CLIs do
(``analysis.capture``), executes it with ``trace=True``, writes the
Chrome trace JSON (Perfetto-loadable), and prints p50/p95/p99 per stage
(queue / h2d / compute / d2h / serde / wire) per operator plus one
machine-readable JSON line.  ``--cohort`` instead MERGES a distributed
job's per-process trace files onto the process-0 clock (tracing/
stitch.py) — one Perfetto timeline with per-process track groups and
offset-corrected cross-process spans.  ``--from-flight-dump`` replays a
flight-recorder crash dump through the same table/export.  Exit 0 = ran
to completion; 2 = capture or execution failed.
"""

from __future__ import annotations

import argparse
import json
import sys
import typing

from flink_tensorflow_tpu_torch.tracing.attribution import (
    attribution,
    events_from_chrome,
    format_attribution_table,
)


def trace_pipeline(
    path: str,
    job_args: typing.Sequence[str] = ("--smoke", "--cpu"),
    *,
    out: typing.Optional[str] = None,
    sample_rate: float = 1.0,
    timeout_s: float = 600.0,
) -> typing.Dict[str, typing.Any]:
    """Capture ``path``'s plan, execute it traced, export the Chrome
    trace to ``out`` (default ``<path>.trace.json``), and return the
    attribution summary dict the CLI prints."""
    from flink_tensorflow_tpu_torch.analysis.capture import capture_pipeline_file

    out = out or f"{path}.trace.json"
    env = capture_pipeline_file(path, job_args)
    env.configure(trace=True, trace_path=out, trace_sample_rate=sample_rate)
    handle = env.execute_async("trace")
    handle.wait(timeout_s)
    tracer = handle.executor.tracer
    events = tracer.events()
    return {
        "pipeline": path,
        "trace_file": out,
        "events": len(events),
        "dropped": tracer.dropped(),
        "sample_rate": sample_rate,
        "attribution": attribution(events),
    }


def expand_proc_files(paths: typing.Sequence[str]) -> typing.List[str]:
    """Resolve trace-file arguments to concrete paths: an existing file
    passes through; a glob pattern expands; a bare prefix ``P``
    discovers its ``P.proc<k>*`` per-process siblings (the names the
    distributed executor writes).  Expansions order by process index —
    not lexicographically, where proc10 would sort before proc2 — so
    the cohort stitcher sees process 0 first."""
    import glob as globmod
    import os
    import re

    def proc_key(path: str) -> typing.Tuple[int, str]:
        m = re.search(r"\.proc(\d+)", os.path.basename(path))
        return (int(m.group(1)) if m else -1, path)

    out: typing.List[str] = []
    for p in paths:
        if os.path.exists(p):
            out.append(p)
            continue
        matches = (globmod.glob(p) if any(ch in p for ch in "*?[")
                   else globmod.glob(f"{p}.proc*"))
        out.extend(sorted(matches, key=proc_key) or [p])
    return out


def main(argv: typing.Optional[typing.Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m flink_tensorflow_tpu_torch.tracing",
        description="Span tracer: execute a pipeline with per-batch span "
                    "tracing, export a Perfetto-loadable Chrome trace, and "
                    "print the per-operator stage attribution table "
                    "(queue / h2d / compute / d2h / serde / wire).",
    )
    parser.add_argument("pipelines", nargs="*", metavar="pipeline.py",
                        help="pipeline script(s) defining main(argv)")
    parser.add_argument("--from-file", default=None, metavar="TRACE.json",
                        help="skip execution: attribute an existing exported "
                             "Chrome trace instead")
    parser.add_argument("--cohort", action="store_true",
                        help="treat the positional arguments as a cohort's "
                             "per-process trace files (*.proc<k>.json): merge "
                             "them onto the process-0 clock, write the single "
                             "Perfetto timeline to --out, and print the "
                             "merged attribution table plus the stitched "
                             "cross-process trace count")
    parser.add_argument("--from-flight-dump", default=None,
                        metavar="FLIGHT.json",
                        help="skip execution: replay a flight-recorder dump "
                             "(attribution over its events; --out exports it "
                             "as a Chrome trace)")
    parser.add_argument("--job-args", default="--smoke --cpu",
                        help="argv passed to each pipeline's main() "
                             "(default: '--smoke --cpu')")
    parser.add_argument("--out", default=None, metavar="PATH",
                        help="Chrome trace output path "
                             "(default: <pipeline>.trace.json)")
    parser.add_argument("--sample", type=float, default=1.0,
                        help="head-based trace sample rate in (0, 1] "
                             "(default: 1.0 — every record)")
    parser.add_argument("--timeout", type=float, default=600.0,
                        help="job execution timeout in seconds")
    parser.add_argument("--table-only", action="store_true",
                        help="print only the attribution table (no JSON line)")
    args = parser.parse_args(argv)

    if args.cohort:
        # A glob or a bare prefix auto-discovers the .proc<k> files the
        # distributed executor wrote, in process order.
        files = expand_proc_files(args.pipelines)
        if len(files) < 2:
            parser.error(
                "--cohort needs >= 2 per-process trace files "
                f"(arguments resolved to {files or 'nothing'} — pass the "
                "files, a glob, or the bare path prefix before .proc<k>)")
        from flink_tensorflow_tpu_torch.tracing.stitch import (
            cross_process_traces,
            merge_cohort_trace_files,
        )

        merged = merge_cohort_trace_files(files)
        out = args.out or "cohort.trace.json"
        with open(out, "w") as f:
            json.dump(merged, f)
        events = events_from_chrome(merged)
        stitched = cross_process_traces(merged)
        attr = attribution(events)
        print(f"== merged {len(files)} process traces -> {out} "
              f"({len(events)} events, {len(stitched)} cross-process "
              f"traces, clock error bound "
              f"{merged['cohort_merge']['max_error_bound_s'] * 1e6:.0f}us) ==")
        print(format_attribution_table(attr))
        if not args.table_only:
            print(json.dumps({
                "trace_file": out, "events": len(events),
                "cross_process_traces": len(stitched),
                "cohort_merge": merged["cohort_merge"],
                "attribution": attr,
            }))
        return 0

    if args.from_flight_dump is not None:
        from flink_tensorflow_tpu_torch.tracing.flight import (
            flight_dump_to_chrome,
            load_flight_dump,
        )

        doc = load_flight_dump(args.from_flight_dump)
        events = list(doc.get("events", ())) + \
            list(doc.get("tracer_events", ()))
        events.sort(key=lambda ev: ev[3])
        attr = attribution(events)
        print(f"== flight dump {args.from_flight_dump} "
              f"(reason={doc.get('reason')}, pid={doc.get('pid')}, "
              f"{len(events)} events) ==")
        print(format_attribution_table(attr))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(flight_dump_to_chrome(doc), f)
            print(f"chrome trace -> {args.out}")
        if not args.table_only:
            print(json.dumps({
                "flight_dump": args.from_flight_dump,
                "reason": doc.get("reason"),
                "events": len(events), "attribution": attr,
            }))
        return 0

    if args.from_file is not None:
        # A glob or a bare .proc<k> prefix attributes the whole set of
        # per-process files at once (unstitched — use --cohort for the
        # clock-corrected merge).
        files = expand_proc_files([args.from_file])
        events = []
        for path in files:
            with open(path) as f:
                events.extend(events_from_chrome(json.load(f)))
        events.sort(key=lambda ev: ev[3])
        attr = attribution(events)
        print(format_attribution_table(attr))
        if not args.table_only:
            print(json.dumps({
                "trace_file": files[0] if len(files) == 1 else files,
                "events": len(events), "attribution": attr}))
        return 0

    if not args.pipelines:
        parser.error("provide pipeline script(s) or --from-file")
    exit_code = 0
    for path in args.pipelines:
        try:
            summary = trace_pipeline(
                path, args.job_args.split(),
                out=args.out, sample_rate=args.sample,
                timeout_s=args.timeout,
            )
        except Exception as ex:  # noqa: BLE001 - report and keep going
            print(f"{path}: tracing failed: {ex}", file=sys.stderr)
            exit_code = max(exit_code, 2)
            continue
        print(f"== {path} -> {summary['trace_file']} "
              f"({summary['events']} events, {summary['dropped']} dropped) ==")
        print(format_attribution_table(summary["attribution"]))
        if not args.table_only:
            print(json.dumps(summary))
    return exit_code


def cli() -> None:
    """``python -m flink_tensorflow_tpu_torch.tracing``."""
    sys.exit(main())
