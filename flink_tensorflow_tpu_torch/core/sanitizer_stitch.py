"""Cohort-wide sanitizer stitcher: distributed protocol conformance.

Port of ``flink_tensorflow_tpu/core/sanitizer_stitch.py``.
``core/sanitizer_rt.py`` records each process's half of every
record-plane interaction (frame send and receive with per-connection
sequence numbers, credit grants and spends, epoch handshakes, barrier
alignment windows) into a bounded happens-before ring.  One process's log
proves local invariants only; this module merges a cohort's logs, puts
each process's events on process 0's timebase
(``t_proc0 = t_local + offset_to_proc0_s``; with no clock sync every
offset is 0, which is exact for processes of one host) and checks the
protocol from both ends at once:

- **dist-barrier-blocked-channel**: a data frame reached an input gate
  from a channel blocked for barrier alignment;
- **dist-credit-overspend**: a sender spent more credits than the
  receiver granted on that connection, or spent through its floor;
- **dist-epoch-fence**: a frame of a connection the receiver fenced as
  stale reached an operator, or a trailing epoch was never fenced;
- **dist-barrier-reorder**: the barriers a receiver saw on a frame differ
  from those the sender put on it;
- **dist-deadlock**: a sender parked at zero credit while its peer's gate
  is full and never resumes.

Checks that need a complete stream are reported as skipped, never
guessed, when a ring wrapped or a side's log is missing (a killed
process).  The stitcher also prices each edge's one-way latency from
paired send and receive stamps.

The logs and the report keep the reference's formats, so either
package's stitcher reads either package's logs.  Run::

    python -m flink_tensorflow_tpu_torch.core.sanitizer_stitch \
        job.hb.proc0.json job.hb.proc1.json --out report.json

It prints the report and exits 1 on a violation, 2 on an unreadable log.
"""

from __future__ import annotations

import argparse
import json
import sys
import typing

from flink_tensorflow_tpu_torch.core.sanitizer_rt import load_hb_log

REPORT_KIND = "flink-tpu-sanitize-report"

#: Check identifiers, in report order.
CHECKS = (
    "barrier-blocked-channel",
    "credit-overspend",
    "epoch-fence",
    "barrier-reorder",
    "deadlock",
)


class _Ev(typing.NamedTuple):
    proc: int          # process index in the cohort
    kind: str
    t: float           # local monotonic stamp
    t_ref: float       # shifted onto the process-0 timebase
    edge: str
    conn: str
    seq: int
    args: dict


def _cohort_block(doc: dict, fallback_index: int) -> dict:
    """The log's cohort identity, defaulting to file order + zero offset
    (single-host monotonic clocks) when the run never clock-synced."""
    meta = doc.get("cohort") or {}
    return {
        "process_index": meta.get("process_index", fallback_index),
        "pid": doc.get("pid", meta.get("pid", -1)),
        "offset_to_proc0_s": float(meta.get("offset_to_proc0_s", 0.0) or 0.0),
        "error_bound_s": float(meta.get("error_bound_s", 0.0) or 0.0),
    }


def _events(doc: dict, proc: int, offset: float) -> typing.List[_Ev]:
    out = []
    for row in doc.get("events", ()):
        kind, t, edge, conn, seq, args = row
        out.append(_Ev(proc, kind, float(t), float(t) + offset,
                       edge or "", conn or "", int(seq), args or {}))
    return out


def _percentile(sorted_vals: typing.Sequence[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]


def stitch(docs: typing.Sequence[dict]) -> dict:
    """Merge per-process happens-before logs into one conformance report.

    ``docs`` are loaded log documents (see ``load_hb_log``); order is
    the fallback process index when a log carries no cohort block.
    """
    procs = []
    events: typing.List[_Ev] = []
    truncated_procs: typing.Set[int] = set()
    local_violations = []
    for i, doc in enumerate(docs):
        meta = _cohort_block(doc, i)
        idx = meta["process_index"]
        if doc.get("truncated"):
            truncated_procs.add(idx)
        procs.append({
            **meta,
            "reason": doc.get("reason"),
            "events": len(doc.get("events", ())),
            "recorded": doc.get("recorded", len(doc.get("events", ()))),
            "truncated": bool(doc.get("truncated")),
        })
        events.extend(_events(doc, idx, meta["offset_to_proc0_s"]))
        for v in doc.get("violations", ()):
            local_violations.append({**v, "process": idx})
    events.sort(key=lambda e: e.t_ref)
    err_by_proc = {p["process_index"]: p["error_bound_s"] for p in procs}

    violations: typing.List[dict] = []
    checks: typing.Dict[str, str] = {}

    def violate(check: str, kind: str, edge: str, conn: str, message: str,
                involved: typing.Iterable[int]) -> None:
        checks[check] = "violation"
        violations.append({
            "kind": kind, "edge": edge, "conn": conn,
            "message": message, "processes": sorted(set(involved)),
        })

    # -- index the merged stream ------------------------------------------
    by_kind: typing.Dict[str, typing.List[_Ev]] = {}
    for ev in events:
        by_kind.setdefault(ev.kind, []).append(ev)
    conns: typing.Dict[typing.Tuple[str, str], dict] = {}

    def conn_state(edge: str, conn: str) -> dict:
        return conns.setdefault((edge, conn), {
            "sends": [], "recvs": [], "delivers": [],
            "grants": 0, "grant_proc": None, "spends": [],
            "recv_handshake": None, "send_proc": None, "recv_proc": None,
        })

    for ev in by_kind.get("frame.send", ()):
        st = conn_state(ev.edge, ev.conn)
        st["sends"].append(ev)
        st["send_proc"] = ev.proc
    for ev in by_kind.get("frame.recv", ()):
        st = conn_state(ev.edge, ev.conn)
        st["recvs"].append(ev)
        st["recv_proc"] = ev.proc
    for ev in by_kind.get("frame.deliver", ()):
        conn_state(ev.edge, ev.conn)["delivers"].append(ev)
    for ev in by_kind.get("credit.grant", ()):
        st = conn_state(ev.edge, ev.conn)
        st["grants"] += int(ev.args.get("n", 0))
        st["grant_proc"] = ev.proc
    for ev in by_kind.get("credit.spend", ()):
        conn_state(ev.edge, ev.conn)["spends"].append(ev)
    for ev in by_kind.get("epoch.handshake", ()):
        if ev.args.get("role") == "recv":
            conn_state(ev.edge, ev.conn)["recv_handshake"] = ev

    def complete(*proc_ids: typing.Optional[int]) -> bool:
        """Both sides' logs present and never wrapped — prefix-dependent
        checks are only sound then."""
        return all(p is not None and p not in truncated_procs
                   for p in proc_ids)

    # -- (a) no delivery from an alignment-blocked channel's peer ---------
    # align.block/unblock and frame.deliver are same-process events, so
    # the windows compare on LOCAL time — clock error cannot smear them.
    checks.setdefault("barrier-blocked-channel", "ok")
    blocked: typing.Dict[typing.Tuple[int, str, str], float] = {}
    for ev in events:
        if ev.kind == "align.block":
            blocked[(ev.proc, ev.edge, ev.conn)] = ev.t
        elif ev.kind == "align.unblock":
            for key in [k for k in blocked if k[0] == ev.proc
                        and k[1] == ev.edge]:
                del blocked[key]
        elif ev.kind == "frame.deliver" and ev.args.get("data"):
            gate = ev.args.get("gate", "")
            ch = str(ev.args.get("ch", ""))
            since = blocked.get((ev.proc, gate, ch))
            if since is not None and ev.t >= since:
                violate(
                    "barrier-blocked-channel", "dist-barrier-blocked-channel",
                    ev.edge, ev.conn,
                    f"edge {ev.edge!r} (conn {ev.conn}) delivered data into "
                    f"gate {gate!r} channel {ch} while that channel was "
                    "blocked for barrier alignment — the peer's records "
                    "overtook the checkpoint cut",
                    [ev.proc])

    # -- (b) credit-spend never exceeds cumulative grants -----------------
    checks.setdefault("credit-overspend", "ok")
    for (edge, conn), st in sorted(conns.items()):
        for ev in st["spends"]:
            bal = ev.args.get("balance")
            floor = ev.args.get("floor", 0)
            if bal is not None and bal < floor:
                violate(
                    "credit-overspend", "dist-credit-overspend", edge, conn,
                    f"edge {edge!r} (conn {conn}) spent a credit to balance "
                    f"{bal} below its floor {floor} "
                    f"(generation {ev.args.get('gen')})",
                    [ev.proc])
        if not st["spends"]:
            continue
        if not complete(st["spends"][0].proc, st["grant_proc"]):
            if checks["credit-overspend"] == "ok":
                checks["credit-overspend"] = "skipped (incomplete log)"
            continue
        overdraw = max((-ev.args.get("floor", 0) for ev in st["spends"]),
                       default=0)
        if len(st["spends"]) > st["grants"] + overdraw:
            violate(
                "credit-overspend", "dist-credit-overspend", edge, conn,
                f"edge {edge!r} (conn {conn}) spent {len(st['spends'])} "
                f"credits against {st['grants']} granted "
                f"(+{overdraw} overdraw allowance) — the sender outran the "
                "receiver's window",
                [st["spends"][0].proc] + (
                    [st["grant_proc"]] if st["grant_proc"] is not None else []))

    # -- (c) stale-epoch frames never reach an operator -------------------
    checks.setdefault("epoch-fence", "ok")
    for (edge, conn), st in sorted(conns.items()):
        hs = st["recv_handshake"]
        if hs is None:
            continue
        stale = bool(hs.args.get("stale"))
        epoch = hs.args.get("epoch", 0)
        server_epoch = hs.args.get("server_epoch", 0)
        if stale and st["delivers"]:
            violate(
                "epoch-fence", "dist-epoch-fence", edge, conn,
                f"edge {edge!r} (conn {conn}, epoch {epoch} < server epoch "
                f"{server_epoch}) was fenced as stale yet "
                f"{len(st['delivers'])} frame(s) reached the operator's "
                "gate — zombie records leaked past the restart fence",
                [hs.proc])
        elif not stale and epoch < server_epoch and complete(hs.proc):
            violate(
                "epoch-fence", "dist-epoch-fence", edge, conn,
                f"edge {edge!r} (conn {conn}) handshook with stale epoch "
                f"{epoch} (server at {server_epoch}) but was never fenced",
                [hs.proc])

    # -- (d) barrier order on the wire == barrier order at the receiver --
    checks.setdefault("barrier-reorder", "ok")
    for (edge, conn), st in sorted(conns.items()):
        if not st["sends"] or not st["recvs"]:
            continue
        if not complete(st["send_proc"], st["recv_proc"]):
            if checks["barrier-reorder"] == "ok":
                checks["barrier-reorder"] = "skipped (incomplete log)"
            continue
        sent = {ev.seq: tuple(ev.args.get("barriers") or ())
                for ev in st["sends"]}
        recvd = {ev.seq: tuple(ev.args.get("barriers") or ())
                 for ev in st["recvs"]}
        for seq in sorted(set(sent) & set(recvd)):
            if sent[seq] != recvd[seq]:
                violate(
                    "barrier-reorder", "dist-barrier-reorder", edge, conn,
                    f"edge {edge!r} (conn {conn}) frame {seq}: barriers "
                    f"{list(sent[seq])} on the wire but {list(recvd[seq])} "
                    "at the receiver — a barrier was reordered against the "
                    "data stream",
                    [st["send_proc"], st["recv_proc"]])

    # -- (e) cross-process waits-for cycle = distributed deadlock ---------
    checks.setdefault("deadlock", "ok")
    sender_last: typing.Dict[str, _Ev] = {}
    receiver_last: typing.Dict[str, _Ev] = {}
    for ev in events:
        if ev.kind in ("credit.park", "credit.unpark", "frame.send"):
            sender_last[ev.edge] = ev
        elif ev.kind in ("gate.full", "gate.resume"):
            receiver_last[ev.edge] = ev
    for edge, snd in sorted(sender_last.items()):
        rcv = receiver_last.get(edge)
        if (snd.kind == "credit.park" and rcv is not None
                and rcv.kind == "gate.full"):
            violate(
                "deadlock", "dist-deadlock", edge, snd.conn,
                f"edge {edge!r}: sender (process {snd.proc}) is parked at "
                f"zero credit while the receiver (process {rcv.proc}) "
                "reports its gate full and never resumed — a cross-process "
                "waits-for cycle (sender waits for credits ← credits wait "
                "for gate drain ← gate waits for the consumer)",
                [snd.proc, rcv.proc])

    # -- per-edge wire latency from paired send/recv stamps ---------------
    edges: typing.Dict[str, dict] = {}
    for (edge, conn), st in sorted(conns.items()):
        recv_by_seq = {ev.seq: ev for ev in st["recvs"]}
        lats = []
        nbytes = 0
        for ev in st["sends"]:
            nbytes += int(ev.args.get("nbytes", 0))
            peer = recv_by_seq.get(ev.seq)
            if peer is not None:
                lats.append(peer.t_ref - ev.t_ref)
        agg = edges.setdefault(edge, {
            "frames_sent": 0, "frames_recvd": 0, "bytes": 0,
            "latencies": [], "error_bound_s": 0.0})
        agg["frames_sent"] += len(st["sends"])
        agg["frames_recvd"] += len(st["recvs"])
        agg["bytes"] += nbytes
        agg["latencies"].extend(lats)
        if st["send_proc"] is not None and st["recv_proc"] is not None:
            agg["error_bound_s"] = max(
                agg["error_bound_s"],
                err_by_proc.get(st["send_proc"], 0.0)
                + err_by_proc.get(st["recv_proc"], 0.0))
    for edge, agg in edges.items():
        lats = sorted(agg.pop("latencies"))
        if lats:
            agg["wire_latency_s"] = {
                "count": len(lats),
                "mean": sum(lats) / len(lats),
                "p95": _percentile(lats, 0.95),
                "max": lats[-1],
            }

    return {
        "kind": REPORT_KIND,
        "processes": procs,
        "events": len(events),
        "truncated": bool(truncated_procs),
        "checks": {c: checks.get(c, "ok") for c in CHECKS},
        "violations": violations,
        "local_violations": local_violations,
        "edges": edges,
    }


def load_report(path: str) -> dict:
    """Load a stitched conformance report."""
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("kind") != REPORT_KIND:
        raise ValueError(f"{path}: not a flink-tpu-sanitize report")
    return doc


def main(argv: typing.Optional[typing.Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m flink_tensorflow_tpu_torch.core.sanitizer_stitch",
        description="Stitch per-process sanitizer happens-before logs and "
                    "run distributed protocol conformance checks.")
    parser.add_argument("logs", nargs="+", metavar="HB_LOG",
                        help="per-process sanitizer logs "
                             "(FLINK_TPU_SANITIZE_LOG dumps, .proc<k> files)")
    parser.add_argument("--cohort", action="store_true",
                        help="merge the logs as one cohort and run the "
                             "distributed conformance checks (default when "
                             "more than one log is given)")
    parser.add_argument("--out", metavar="REPORT.json",
                        help="also write the conformance report as JSON")
    parser.add_argument("--report-only", action="store_true",
                        help="suppress the trailing machine-readable "
                             "JSON line")
    args = parser.parse_args(argv)

    docs = []
    for path in args.logs:
        try:
            docs.append(load_hb_log(path))
        except (OSError, ValueError) as exc:
            print(f"sanitizer_stitch: {exc}", file=sys.stderr)
            return 2

    report = stitch(docs)
    print("== sanitizer_stitch ==")
    for p in report["processes"]:
        print(f"process {p['process_index']} (pid {p['pid']}): "
              f"{p['events']} events"
              f"{' (truncated ring)' if p['truncated'] else ''}, "
              f"offset {p['offset_to_proc0_s'] * 1e6:+.1f} us "
              f"±{p['error_bound_s'] * 1e6:.1f} us, "
              f"dumped on {p['reason']!r}")
    for check, status in report["checks"].items():
        print(f"  check {check}: {status}")
    for edge, agg in sorted(report["edges"].items()):
        lat = agg.get("wire_latency_s")
        lat_str = (f", one-way p95 {lat['p95'] * 1e3:.3f} ms "
                   f"±{agg['error_bound_s'] * 1e3:.3f} ms"
                   if lat else "")
        print(f"  edge {edge}: {agg['frames_sent']} frames sent / "
              f"{agg['frames_recvd']} received{lat_str}")
    for v in report["local_violations"]:
        print(f"LOCAL VIOLATION [process {v['process']}] "
              f"[{v['kind']}] {v['message']}")
    for v in report["violations"]:
        conn = f" conn {v['conn']}" if v.get("conn") else ""
        print(f"VIOLATION [{v['kind']}] edge {v['edge']!r}{conn} "
              f"(processes {v['processes']}): {v['message']}")
    n_bad = len(report["violations"]) + len(report["local_violations"])
    print(f"{len(report['processes'])} process(es), "
          f"{report['events']} events: "
          + (f"{n_bad} violation(s)" if n_bad else "conformant"))
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2)
        print(f"report written to {args.out}")
    if not args.report_only:
        print(json.dumps({
            "processes": len(report["processes"]),
            "events": report["events"],
            "violations": n_bad,
            "checks": report["checks"],
        }))
    return 1 if n_bad else 0


def cli() -> None:
    sys.exit(main())


if __name__ == "__main__":
    cli()
