"""flink-tpu-doctor — correlate the evidence streams into a ranked
root-cause report.

Port of ``flink_tensorflow_tpu/tracing/doctor.py``, kept equal to it (the
report and its JSON line are the reference's).  Run it as
``python -m flink_tensorflow_tpu_torch.tracing.doctor``.  The sanitizer,
shardcheck, statecheck and roofline folds parse report dicts: those of
``analysis/shardcheck.py --out`` and ``analysis/statecheck.py --out``
(whose keys are the reference's), from either package.

    flink-tpu-doctor --snapshot cohort.snapshot.json
    flink-tpu-doctor --snapshot s.json --flight flight.json --top 3
    flink-tpu-doctor --flight w0.flight.json w1.flight.json \\
                     --trace job.trace.json --decision decision.json \\
                     --out report.json

The observability stack leaves three kinds of evidence behind: the
(merged cohort) metric snapshot, span traces / flight-recorder dumps,
and — when the autoscale loop acted — the supervisor's decision file.
Each answers a different question; the doctor joins them:

- **which rule breached** — the snapshot's ``health.*`` gauges (written
  by the live :class:`~flink_tensorflow_tpu_torch.metrics.health.
  HealthEvaluator`) plus a one-shot re-evaluation of the value-mode
  rules from the default catalogue, ranked by how far past the
  threshold each signal sits;
- **which operator/edge is the bottleneck** — queue depth against the
  per-edge channels, time upstream writers spent blocked
  (``in_backpressure_s`` — "this operator CAUSES the backpressure"),
  own blocked-emitting time, idleness;
- **which stage dominates its latency** — the trace/flight events fold
  through the standard attribution table
  (queue / h2d / compute / d2h / serde / wire) per operator;
- **what the supervisor did** — health transitions and autoscale
  decisions recorded on the flight ring, plus the decision file.

Pure functions over parsed evidence (unit-testable on synthetic data);
the CLI prints the ranked findings and one machine-readable JSON line.
Exit 0 = report produced; 2 = no readable evidence.
"""

from __future__ import annotations

import argparse
import json
import sys
import typing

from flink_tensorflow_tpu_torch.tracing.attribution import STAGES, attribution

Snapshot = typing.Mapping[str, typing.Mapping[str, typing.Any]]


def _split_scope(scope: str) -> typing.Tuple[str, typing.Optional[int]]:
    task, dot, tail = scope.rpartition(".")
    if dot and tail.isdigit():
        return task, int(tail)
    return scope, None


def _num(value: typing.Any) -> typing.Optional[float]:
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return None
    v = float(value)
    return v if v == v else None


# -- evidence folds --------------------------------------------------------
def health_findings(snapshot: Snapshot, *,
                    channel_capacity: int = 1024
                    ) -> typing.List[typing.Dict[str, typing.Any]]:
    """Ranked rule findings over one snapshot: the live evaluator's
    ``health.*`` gauges first (they carry the sustained/hysteresis
    verdicts), then a one-shot triage of the default catalogue's
    value-mode rules — rate-mode rules need two snapshots and are the
    live evaluator's job.  Rank key: state, then threshold overshoot."""
    from flink_tensorflow_tpu_torch.metrics.health import (
        BREACH,
        OK,
        STATE_NAMES,
        WARN,
        default_rules,
    )

    findings: typing.List[typing.Dict[str, typing.Any]] = []
    for target, value in (snapshot.get("health") or {}).items():
        state = _num(value)
        if state is None or int(state) == OK or target == "job":
            continue
        findings.append({
            "source": "health-gauges", "rule": "health",
            "target": target, "state": STATE_NAMES[int(state)],
            "severity": int(state), "overshoot": 0.0, "value": None,
        })
    for rule in default_rules(channel_capacity=channel_capacity):
        if rule.mode != "value":
            continue
        for target, value in rule.observe(snapshot).items():
            if not rule.worse(value, rule.warn):
                continue
            breached = rule.worse(value, rule.breach)
            ref = rule.breach if breached else rule.warn
            overshoot = (value / ref if rule.cmp == ">" and ref else
                         (ref / value if value else float("inf")))
            findings.append({
                "source": "triage", "rule": rule.id, "target": target,
                "state": STATE_NAMES[BREACH if breached else WARN],
                "severity": BREACH if breached else WARN,
                "overshoot": round(overshoot, 3), "value": value,
            })
    findings.sort(key=lambda f: (-f["severity"], -f["overshoot"],
                                 f["rule"], f["target"]))
    return findings


def bottleneck_ranking(snapshot: Snapshot
                       ) -> typing.List[typing.Dict[str, typing.Any]]:
    """Operators ranked by backpressure evidence.  The headline signal
    is ``in_backpressure_s`` (time upstream writers spent blocked
    putting INTO this operator's gate — the operator that causes the
    jam), tie-broken by buffered queue depth, own blocked time, and
    credit starvation on the operator's flow-controlled out-edges
    (``credit_starved_s``; the worst such edge is named in
    ``credit_edge`` so the report can point at the exact starved
    link)."""
    def _fresh() -> typing.Dict[str, float]:
        return {"in_backpressure_s": 0.0, "queue_depth": 0.0,
                "backpressure_s": 0.0, "idle_s": 0.0, "edge_depth": 0.0,
                "credit_starved_s": 0.0}

    per_op: typing.Dict[str, typing.Dict[str, float]] = {}
    credit_edges: typing.Dict[str, typing.Tuple[str, float]] = {}

    def _credit(op: str, edge: str, starved: float) -> None:
        per_op.setdefault(op, _fresh())["credit_starved_s"] += starved
        best = credit_edges.get(op)
        if best is None or starved > best[1]:
            credit_edges[op] = (edge, starved)

    for scope, metrics in snapshot.items():
        task, index = _split_scope(scope)
        if index is None:
            # Shuffle-plane credit telemetry lives under non-subtask
            # scopes (`shuffle.out.{task}.{n}.ch{k}`) the generic fold
            # skips — parse them explicitly so a credit-starved shuffle
            # edge still ranks its SENDING operator.
            if scope.startswith("shuffle.out."):
                op_part = scope[len("shuffle.out."):].rsplit(".ch", 1)[0]
                op, _idx = _split_scope(op_part)
                v = _num(metrics.get("credit_starved_s"))
                if v is not None and v > 0:
                    _credit(op, scope, v)
            continue
        agg = per_op.setdefault(task, _fresh())
        for name, key in (("in_backpressure_s", "in_backpressure_s"),
                          ("queue_depth", "queue_depth"),
                          ("backpressure_s", "backpressure_s"),
                          ("idle_s", "idle_s")):
            v = _num(metrics.get(name))
            if v is not None:
                agg[key] += v
        for name, value in metrics.items():
            if name.startswith("edge") and name.endswith("_queue_depth"):
                v = _num(value)
                if v is not None:
                    agg["edge_depth"] += v
        # RemoteSink edges publish credit starvation under their own
        # operator scope.
        v = _num(metrics.get("edge.credit_starved_s"))
        if v is not None and v > 0:
            _credit(task, scope, v)
    ranked = [{"operator": op, **{k: round(v, 4) for k, v in agg.items()},
               "credit_edge": credit_edges.get(op, (None, 0.0))[0]}
              for op, agg in per_op.items()]
    ranked.sort(key=lambda r: (-r["in_backpressure_s"],
                               -max(r["queue_depth"], r["edge_depth"]),
                               -r["backpressure_s"],
                               -r["credit_starved_s"], r["operator"]))
    return ranked


def stage_dominance(events: typing.Sequence[tuple]
                    ) -> typing.Dict[str, typing.Dict[str, typing.Any]]:
    """Per-operator dominant stage from trace/flight events: the
    canonical stage with the largest total span time, with its share of
    the operator's canonical-stage total."""
    out: typing.Dict[str, typing.Dict[str, typing.Any]] = {}
    for op, rows in attribution(events).items():
        staged = {s: rows[s]["total_ms"] for s in STAGES if s in rows}
        total = sum(staged.values())
        if not staged or total <= 0:
            continue
        stage = max(staged, key=lambda s: staged[s])
        out[op] = {
            "stage": stage,
            "total_ms": round(staged[stage], 3),
            "share": round(staged[stage] / total, 4),
            "p95_ms": rows[stage]["p95_ms"],
        }
    return out


def supervisor_actions(flight_docs: typing.Sequence[dict],
                       decision: typing.Optional[dict] = None
                       ) -> typing.List[typing.Dict[str, typing.Any]]:
    """Health transitions and autoscale decisions, time-ordered, from
    the flight rings (tracks ``health`` / ``autoscale``) and the
    supervisor's decision file."""
    actions: typing.List[typing.Dict[str, typing.Any]] = []
    for doc in flight_docs:
        pid = doc.get("pid")
        for track, name, _ph, t0, _dur, args in doc.get("events", ()):
            if track not in ("health", "autoscale"):
                continue
            actions.append({"source": f"flight:{pid}", "track": track,
                            "event": name, "t": t0,
                            "args": args if isinstance(args, dict) else {}})
    actions.sort(key=lambda a: a["t"])
    if decision is not None:
        actions.append({
            "source": "decision-file", "track": "autoscale",
            "event": "decision", "t": decision.get("ts"),
            "args": {k: decision.get(k) for k in
                     ("rule_id", "target", "action", "value",
                      "from_workers", "to_workers", "checkpoint_id")},
        })
    return actions


def sanitizer_findings(report: typing.Optional[dict]
                       ) -> typing.List[str]:
    """Distributed-sanitizer conformance violations folded into doctor
    findings.  A protocol violation is PROVEN misbehaviour — it outranks
    every statistical signal, so the caller places these first."""
    if not report:
        return []
    out: typing.List[str] = []
    for v in report.get("violations", ()):
        edge = f" on edge {v['edge']}" if v.get("edge") else ""
        out.append(f"sanitizer: {v.get('kind', 'violation')}{edge} — "
                   f"{v.get('message', '')}")
    for v in report.get("local_violations", ()):
        out.append(f"sanitizer (process {v.get('process')}): "
                   f"{v.get('kind', 'violation')} — {v.get('message', '')}")
    if not out and report.get("truncated"):
        out.append("sanitizer: no violation, but event logs were "
                   "truncated — prefix-dependent checks were skipped")
    return out


def shardcheck_findings(report: typing.Optional[dict]
                        ) -> typing.List[str]:
    """Static shardcheck verdicts (``flink-tpu-shardcheck --out``)
    folded into doctor findings.  ERROR findings are plan-level proof
    (an over-budget HBM plan, a ragged partition) and rank right after
    the sanitizer's protocol violations; WARNs ride along as advisory
    layout context for the statistical signals."""
    if not report:
        return []
    out: typing.List[str] = []
    for f in report.get("findings", ()):
        if f.get("severity") == "INFO":
            continue
        where = f.get("edge") or f.get("node") or "plan"
        out.append(f"shardcheck {f.get('severity', '?')} "
                   f"[{f.get('rule', '?')}] {where}: {f.get('message', '')}")
    return out


def statecheck_findings(report: typing.Optional[dict]
                        ) -> typing.List[str]:
    """Static statecheck verdicts (``flink-tpu-statecheck --out``)
    folded into doctor findings.  ERROR findings are plan-level proof
    (hidden state the snapshot never sees, an at-least-once path into a
    non-idempotent sink, a moment sharded away from its param) and rank
    with the shardcheck verdicts; WARNs ride along as exact-resume
    context for the statistical signals."""
    if not report:
        return []
    out: typing.List[str] = []
    for f in report.get("findings", ()):
        if f.get("severity") == "INFO":
            continue
        where = f.get("edge") or f.get("node") or "plan"
        out.append(f"statecheck {f.get('severity', '?')} "
                   f"[{f.get('rule', '?')}] {where}: {f.get('message', '')}")
    return out


def roofline_findings(report: typing.Optional[dict]) -> typing.List[str]:
    """Roofline drift verdicts (``flink-tpu-roofline --out``) folded
    into doctor findings: measured-vs-predicted divergence and
    unpredicted recompiles are runtime-vs-plan proof, ranked with the
    static shardcheck verdicts; the top headroom row rides along as the
    "where the seconds went" context for the statistical signals."""
    if not report:
        return []
    out = [f"roofline [{f.get('rule', '?')}] {f.get('operator', '?')}: "
           f"{f.get('message', '')}"
           for f in report.get("findings", ())]
    rows = report.get("rows") or ()
    if rows:
        r = rows[0]  # already ranked by recoverable headroom
        out.append(
            f"roofline headroom: {r.get('operator', '?')} leads with "
            f"{r.get('headroom_s', 0):.2f}s recoverable "
            f"({r.get('bound', '-')}-bound at {r.get('mfu_pct', 0):.1f}% "
            "MFU)")
    return out


def diagnose(
    snapshot: typing.Optional[Snapshot] = None,
    *,
    events: typing.Sequence[tuple] = (),
    flight_docs: typing.Sequence[dict] = (),
    decision: typing.Optional[dict] = None,
    sanitizer_report: typing.Optional[dict] = None,
    shardcheck_report: typing.Optional[dict] = None,
    statecheck_report: typing.Optional[dict] = None,
    roofline_report: typing.Optional[dict] = None,
    channel_capacity: int = 1024,
    top: int = 3,
) -> typing.Dict[str, typing.Any]:
    """The full correlation: returns the report dict the CLI prints.
    ``findings`` is the ranked human-readable summary — finding 1 names
    the breached rule, the bottleneck operator, its dominant stage, and
    what (if anything) the supervisor did about it.  A distributed-
    sanitizer report (``flink-tpu-sanitize --out``) contributes proven
    protocol violations, ranked above everything else."""
    snapshot = snapshot or {}
    rules = health_findings(snapshot, channel_capacity=channel_capacity)
    bottlenecks = [b for b in bottleneck_ranking(snapshot)
                   if b["in_backpressure_s"] > 0 or b["queue_depth"] > 0
                   or b["edge_depth"] > 0 or b["backpressure_s"] > 0
                   or b.get("credit_starved_s", 0) > 0]
    stages = stage_dominance(events)
    actions = supervisor_actions(flight_docs, decision)
    san_findings = sanitizer_findings(sanitizer_report)
    shard_findings = shardcheck_findings(shardcheck_report)
    state_findings = statecheck_findings(statecheck_report)
    roof_findings = roofline_findings(roofline_report)

    findings: typing.List[str] = (list(san_findings) + list(shard_findings)
                                  + list(state_findings)
                                  + list(roof_findings))
    named: typing.Set[str] = set()
    for rank, b in enumerate(bottlenecks[:top], start=1):
        op = b["operator"]
        named.add(op)
        hit = [f for f in rules if f["target"].split("/", 1)[0] == op]
        rule_part = (f"{hit[0]['rule']} {hit[0]['state']}" if hit
                     else "no rule past threshold")
        credit_part = ""
        if b.get("credit_starved_s", 0) > 0 and b.get("credit_edge"):
            credit_part = (
                f"; credit-starved {b['credit_starved_s']:.2f}s on edge "
                f"{b['credit_edge']} (the downstream consumer is not "
                "granting — the jam is below this operator)")
        stage_part = ""
        if op in stages:
            s = stages[op]
            stage_part = (f"; dominant stage {s['stage']} "
                          f"({s['share'] * 100:.0f}% of span time, "
                          f"p95 {s['p95_ms']:.3f}ms)")
        findings.append(
            f"#{rank} bottleneck {op}: {rule_part} — upstream blocked "
            f"{b['in_backpressure_s']:.2f}s, queue depth "
            f"{max(b['queue_depth'], b['edge_depth']):.0f}, own "
            f"backpressure {b['backpressure_s']:.2f}s"
            f"{credit_part}{stage_part}")
    for f in rules:
        op = f["target"].split("/", 1)[0]
        if op in named:
            continue
        named.add(op)
        detail = (f" (value {f['value']:.4g}, {f['overshoot']:.2f}x "
                  "threshold)" if f["value"] is not None else "")
        findings.append(f"rule {f['rule']} {f['state']} on "
                        f"{f['target']}{detail}")
    decisions = [a for a in actions if a["event"] == "decision"]
    if decisions:
        d = decisions[-1]["args"]
        findings.append(
            f"supervisor: {d.get('rule_id')} drove "
            f"{d.get('action')} {d.get('from_workers')} -> "
            f"{d.get('to_workers')} workers (restore from checkpoint "
            f"{d.get('checkpoint_id')})")
    elif rules and any(f["severity"] >= 2 for f in rules):
        findings.append("supervisor: no autoscale decision recorded — "
                        "health.autoscale unset, actuator deferred "
                        "(cooldown / no checkpoint), or at bounds")
    if not findings:
        findings.append("no breach evidence: all signals under "
                        "thresholds in the provided evidence")
    return {
        "kind": "flink-tpu-doctor-report",
        "findings": findings,
        "rules": rules,
        "bottlenecks": bottlenecks,
        "stages": stages,
        "actions": actions,
        "sanitizer": san_findings,
        "shardcheck": shard_findings,
        "statecheck": state_findings,
        "roofline": roof_findings,
    }


# -- evidence loading ------------------------------------------------------
def _load_snapshot(path: str) -> Snapshot:
    """A scope tree from either a raw ``{scope: {metric: value}}`` JSON
    file or an inspector/cohort JSON document wrapping one."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: not a metric snapshot")
    # Inspector snapshot docs keep the raw tree under "job" only; a raw
    # tree's values are all dicts keyed by metric name.
    if "snapshot" in doc and isinstance(doc["snapshot"], dict):
        return doc["snapshot"]
    return doc


def main(argv: typing.Optional[typing.Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="flink-tpu-doctor",
        description="Root-cause diagnosis: correlate a cohort metric "
                    "snapshot, trace/flight stage attribution, and the "
                    "autoscale supervisor's records into a ranked report "
                    "(which rule breached, which operator/edge is the "
                    "bottleneck, which stage dominates, what the "
                    "supervisor did).",
    )
    parser.add_argument("--snapshot", default=None, metavar="SNAP.json",
                        help="metric scope tree (CohortCollector."
                             "merged_snapshot / MetricRegistry.snapshot "
                             "serialized as JSON)")
    parser.add_argument("--flight", nargs="*", default=[],
                        metavar="FLIGHT.json",
                        help="flight-recorder dump(s): health/autoscale "
                             "tracks feed the action log, span events feed "
                             "stage attribution")
    parser.add_argument("--trace", nargs="*", default=[],
                        metavar="TRACE.json",
                        help="exported Chrome trace(s) for stage "
                             "attribution")
    parser.add_argument("--decision", default=None, metavar="DECISION.json",
                        help="autoscale decision file written by the "
                             "actuator")
    parser.add_argument("--sanitizer", default=None, metavar="REPORT.json",
                        help="distributed-sanitizer report "
                             "(flink-tpu-sanitize --out): proven protocol "
                             "violations rank above every statistical "
                             "signal")
    parser.add_argument("--shardcheck", default=None, metavar="REPORT.json",
                        help="static shardcheck report "
                             "(flink-tpu-shardcheck --out): plan-level "
                             "layout/donation/HBM verdicts fold in after "
                             "protocol violations")
    parser.add_argument("--statecheck", default=None, metavar="REPORT.json",
                        help="static statecheck report "
                             "(flink-tpu-statecheck --out): exact-resume/"
                             "RNG-stream/rescale-safety verdicts fold in "
                             "alongside the shardcheck ones")
    parser.add_argument("--roofline", default=None, metavar="REPORT.json",
                        help="roofline report (flink-tpu-roofline --out): "
                             "MFU/headroom context and predicted-vs-"
                             "measured drift findings fold in after the "
                             "static shardcheck verdicts")
    parser.add_argument("--channel-capacity", type=int, default=1024,
                        help="channel capacity the queue-depth thresholds "
                             "scale against (default 1024)")
    parser.add_argument("--top", type=int, default=3,
                        help="bottleneck operators to rank (default 3)")
    parser.add_argument("--out", default=None, metavar="PATH",
                        help="also write the full report JSON to PATH")
    parser.add_argument("--report-only", action="store_true",
                        help="print only the findings (no JSON line)")
    args = parser.parse_args(argv)

    snapshot: typing.Optional[Snapshot] = None
    events: typing.List[tuple] = []
    flight_docs: typing.List[dict] = []
    sanitizer_report: typing.Optional[dict] = None
    shardcheck_report: typing.Optional[dict] = None
    statecheck_report: typing.Optional[dict] = None
    roofline_report: typing.Optional[dict] = None
    loaded = 0
    try:
        if args.snapshot:
            snapshot = _load_snapshot(args.snapshot)
            loaded += 1
        if args.trace:
            from flink_tensorflow_tpu_torch.tracing.attribution import (
                events_from_chrome,
            )

            for path in args.trace:
                with open(path) as f:
                    events.extend(events_from_chrome(json.load(f)))
                loaded += 1
        if args.flight:
            from flink_tensorflow_tpu_torch.tracing.flight import load_flight_dump

            for path in args.flight:
                doc = load_flight_dump(path)
                flight_docs.append(doc)
                events.extend(doc.get("events", ()))
                events.extend(doc.get("tracer_events", ()))
                loaded += 1
        if args.sanitizer:
            from flink_tensorflow_tpu_torch.core.sanitizer_stitch import (
                load_report,
            )

            sanitizer_report = load_report(args.sanitizer)
            loaded += 1
        if args.shardcheck:
            with open(args.shardcheck) as f:
                shardcheck_report = json.load(f)
            if not isinstance(shardcheck_report, dict):
                raise ValueError(f"{args.shardcheck}: not a shardcheck "
                                 "report")
            loaded += 1
        if args.statecheck:
            with open(args.statecheck) as f:
                statecheck_report = json.load(f)
            if not isinstance(statecheck_report, dict):
                raise ValueError(f"{args.statecheck}: not a statecheck "
                                 "report")
            loaded += 1
        if args.roofline:
            with open(args.roofline) as f:
                roofline_report = json.load(f)
            if not isinstance(roofline_report, dict):
                raise ValueError(f"{args.roofline}: not a roofline "
                                 "report")
            loaded += 1
    except (OSError, ValueError) as ex:
        print(f"flink-tpu-doctor: unreadable evidence: {ex}",
              file=sys.stderr)
        return 2
    decision = None
    if args.decision:
        from flink_tensorflow_tpu_torch.core.autoscale import read_decision

        decision = read_decision(args.decision)
        if decision is None:
            print(f"flink-tpu-doctor: {args.decision} is not a decision "
                  "file", file=sys.stderr)
            return 2
        loaded += 1
    if not loaded:
        parser.error("provide at least one of --snapshot / --flight / "
                     "--trace / --decision / --sanitizer / --shardcheck / "
                     "--statecheck / --roofline")
    events.sort(key=lambda ev: ev[3])

    report = diagnose(
        snapshot, events=events, flight_docs=flight_docs,
        decision=decision, sanitizer_report=sanitizer_report,
        shardcheck_report=shardcheck_report,
        statecheck_report=statecheck_report,
        roofline_report=roofline_report,
        channel_capacity=args.channel_capacity,
        top=args.top,
    )
    print("== flink-tpu-doctor ==")
    for line in report["findings"]:
        print(f"  {line}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"report -> {args.out}")
    if not args.report_only:
        print(json.dumps(report))
    return 0


def cli() -> None:
    """Console-script entry point (``flink-tpu-doctor``)."""
    sys.exit(main())


if __name__ == "__main__":  # pragma: no cover — python -m parity with cli()
    cli()
