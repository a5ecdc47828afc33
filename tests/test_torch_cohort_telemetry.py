"""The port's cohort telemetry plane and the record plane's spans held to
the JAX package's (``flink_tensorflow_tpu/{core/cohort_telemetry,
metrics/cohort}.py``, the spans of ``core/shuffle.py`` and
``io/remote.py``) on the same inputs.

Twins of the classes of ``tests/test_cohort_telemetry.py`` (all but the
lint class, which waits for the port's analysis plane): clock-offset
estimates, metric-state merges, the telemetry services' loopback exchange
under injected skew, a real two-process port cohort whose per-process
trace files stitch into cross-process record journeys, the flight
recorder and the reactor's gauges.  Then the record plane's and the
pipe's spans: names, counts and arguments of the shuffle writers and of
``RemoteSink`` / ``RemoteSource`` over the same records in both packages,
credit waits under overload, the pipe's one-way wire latency, and the
cohort executor's telemetry wiring (pre-sync error bounds, per-process
trace files, the peer-lost flight event, ``--live --cohort``).
"""

import json
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time
import tracemalloc

import numpy as np
import pytest

from flink_tensorflow_tpu import StreamExecutionEnvironment as JaxEnv
from flink_tensorflow_tpu.core import cohort_telemetry as jtelemetry
from flink_tensorflow_tpu.core import elements as jel
from flink_tensorflow_tpu.core import shuffle as jshuffle
from flink_tensorflow_tpu.core.channels import InputGate as JaxGate
from flink_tensorflow_tpu.io import remote as jremote
from flink_tensorflow_tpu.metrics import cohort as jcohort
from flink_tensorflow_tpu.metrics.registry import MetricRegistry as JaxRegistry
from flink_tensorflow_tpu.tensors import TensorValue as JaxValue
from flink_tensorflow_tpu.tracing import clocksync as jclocksync
from flink_tensorflow_tpu.tracing import flight as jflight
from flink_tensorflow_tpu.tracing import stitch as jstitch
from flink_tensorflow_tpu.tracing.tracer import Tracer as JaxTracer
from flink_tensorflow_tpu_torch import DistributedConfig, StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.core import cohort_telemetry
from flink_tensorflow_tpu_torch.core import elements as el
from flink_tensorflow_tpu_torch.core import shuffle
from flink_tensorflow_tpu_torch.core.channels import InputGate
from flink_tensorflow_tpu_torch.io import remote
from flink_tensorflow_tpu_torch.metrics import cohort
from flink_tensorflow_tpu_torch.metrics.registry import MetricRegistry
from flink_tensorflow_tpu_torch.tensors.value import TensorValue
from flink_tensorflow_tpu_torch.tracing import clocksync, flight, stitch
from flink_tensorflow_tpu_torch.tracing.tracer import TraceContext, Tracer

sys.path.insert(0, os.path.dirname(__file__))
from _torch_ports import free_ports  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
_WORKER = os.path.join(os.path.dirname(__file__), "_torch_cohort_trace_worker.py")

PKGS = {
    "jax": dict(clocksync=jclocksync, cohort=jcohort, telemetry=jtelemetry, flight=jflight,
                registry=JaxRegistry, tracer=JaxTracer, stitch=jstitch, shuffle=jshuffle,
                el=jel, gate=JaxGate, value=JaxValue, remote=jremote, env=JaxEnv),
    "port": dict(clocksync=clocksync, cohort=cohort, telemetry=cohort_telemetry,
                 flight=flight, registry=MetricRegistry, tracer=Tracer, stitch=stitch,
                 shuffle=shuffle, el=el, gate=InputGate, value=TensorValue, remote=remote,
                 env=StreamExecutionEnvironment),
}


def canon(x):
    """``x`` with NaN as the string "nan", so empty reservoirs compare."""
    if isinstance(x, float) and x != x:
        return "nan"
    if isinstance(x, dict):
        return {k: canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(canon(v) for v in x)
    return x


def twin(run):
    """``run(pkg)`` on both packages; the results must be equal.  Returns
    the port's."""
    jax_out, port_out = canon(run(PKGS["jax"])), canon(run(PKGS["port"]))
    assert port_out == jax_out
    return port_out


# ---------------------------------------------------------------------------
# clock-offset estimation
# ---------------------------------------------------------------------------


class TestOffsetEstimator:
    def test_symmetric_legs_recover_skew_exactly(self):
        skew, leg, t0 = 3.7, 0.002, 100.0

        def run(pkg):
            est = pkg["clocksync"].OffsetEstimator()
            ok = est.add_sample(t0, t0 + leg + skew, t0 + 2 * leg, now=0.0)
            return ok, est.offset_s, est.error_bound_s
        ok, offset, bound = twin(run)
        assert ok
        assert offset == pytest.approx(skew, abs=1e-12)
        assert bound == pytest.approx(leg)

    def test_error_within_half_rtt_under_asymmetric_legs(self):
        def run(pkg):
            rng = np.random.RandomState(42)
            out = []
            for _ in range(200):
                skew = float(rng.uniform(-1e4, 1e4))
                d1, d2 = float(rng.uniform(1e-5, 5e-3)), float(rng.uniform(1e-5, 5e-3))
                est = pkg["clocksync"].OffsetEstimator()
                t0 = float(rng.uniform(0, 1e3))
                assert est.add_sample(t0, t0 + d1 + skew, t0 + d1 + d2, now=0.0)
                out.append((skew, est.offset_s, est.error_bound_s))
            return out
        for skew, offset, bound in twin(run):
            assert abs(offset - skew) <= bound + 1e-12

    def test_min_rtt_sample_wins(self):
        def run(pkg):
            est = pkg["clocksync"].OffsetEstimator()
            got = [est.add_sample(0.0, 0.05, 0.10, now=0.0), est.error_bound_s,
                   est.add_sample(1.0, 1.2, 1.4, now=1.0), est.error_bound_s,
                   est.add_sample(2.0, 2.001, 2.002, now=2.0), est.error_bound_s]
            return got
        got = twin(run)
        assert got[1] == pytest.approx(0.05) and not got[2]
        assert got[5] == pytest.approx(0.001)

    def test_stale_best_yields_to_fresh_sample(self):
        def run(pkg):
            est = pkg["clocksync"].OffsetEstimator(max_age_s=10.0)
            est.add_sample(0.0, 0.001, 0.002, now=0.0)
            tight = est.error_bound_s
            return (tight, est.add_sample(1.0, 1.05, 1.1, now=5.0),
                    est.add_sample(20.0, 20.05, 20.1, now=20.0), est.error_bound_s)
        tight, fresh_enough, aged, bound = twin(run)
        assert not fresh_enough and aged and bound > tight

    def test_negative_rtt_rejected(self):
        def run(pkg):
            est = pkg["clocksync"].OffsetEstimator()
            return est.add_sample(5.0, 5.0, 4.9, now=0.0), est.ready, est.samples
        assert twin(run) == (False, False, 0)


# ---------------------------------------------------------------------------
# metric-state merge semantics
# ---------------------------------------------------------------------------


def _registry_with(pkg, scope, *, records=0, lat_samples=(), gauges=()):
    reg = pkg["registry"](seed=7)
    g = reg.group(scope)
    m = g.meter("records_in")
    for _ in range(records):
        m.mark()
    h = g.histogram("lat")
    for s in lat_samples:
        h.record(s)
    for name, value in gauges:
        g.gauge(name, (lambda v=value: v))
    return reg


def _counts(snapshot):
    """A snapshot without its time-dependent meter rates."""
    out = {}
    for scope, metrics in snapshot.items():
        out[scope] = {name: ({k: v for k, v in value.items() if "rate" not in k}
                             if isinstance(value, dict) else value)
                      for name, value in metrics.items()}
    return out


class TestMergeSemantics:
    NAMES = ("backpressure_s", "queue_depth", "send_queue_bytes", "watermark_lag",
             "queue_high_watermark", "chain_length", "poll_to_dispatch_s",
             "max_poll_to_dispatch_s", "admitted", "evicted", "preempted", "rejected",
             "serving_steps", "active_seqs", "waiting_seqs", "tokens_in_use",
             "cache_h2d_blocks", "cache_d2h_blocks", "cache_resident_moves",
             "step_h2d_bytes", "dispatches", "checkpoints_aborted", "fired_total",
             "watermark_lag_s", "current_split_age_s", "last_checkpoint_id",
             "last_size_bytes", "roofline.bound", "roofline.mfu_pct",
             "roofline.compile_events", "edge0_src_queue_depth", "kv_page_occupancy_pct")

    def test_gauge_policy_table(self):
        got = twin(lambda pkg: {n: pkg["cohort"].gauge_policy(n) for n in self.NAMES})
        assert got["backpressure_s"] == got["queue_depth"] == "sum"
        assert got["watermark_lag"] == got["queue_high_watermark"] == "max"
        assert got["chain_length"] == "last"
        assert got["poll_to_dispatch_s"] == got["max_poll_to_dispatch_s"] == "max"

    def test_gauge_policy_covers_post_pr9_names(self):
        got = twin(lambda pkg: {n: pkg["cohort"].gauge_policy(n) for n in self.NAMES})
        for name in ("admitted", "evicted", "preempted", "rejected", "serving_steps",
                     "active_seqs", "waiting_seqs", "tokens_in_use", "cache_h2d_blocks",
                     "cache_d2h_blocks", "cache_resident_moves", "step_h2d_bytes",
                     "dispatches", "checkpoints_aborted", "fired_total", "last_size_bytes"):
            assert got[name] == "sum", name
        for name in ("watermark_lag_s", "current_split_age_s", "last_checkpoint_id"):
            assert got[name] == "max", name

    def test_meters_and_counters_sum_across_processes(self):
        def run(pkg):
            a = _registry_with(pkg, "wire", records=10).export_state()
            b = _registry_with(pkg, "wire", records=32).export_state()
            return _counts(pkg["cohort"].state_to_snapshot(pkg["cohort"].merge_states([a, b])))
        assert twin(run)["wire"]["records_in"]["count"] == 42

    def test_disjoint_subtask_scopes_union(self):
        def run(pkg):
            a = _registry_with(pkg, "op.0", records=5).export_state()
            b = _registry_with(pkg, "op.1", records=7).export_state()
            return _counts(pkg["cohort"].state_to_snapshot(pkg["cohort"].merge_states([a, b])))
        merged = twin(run)
        assert merged["op.0"]["records_in"]["count"] == 5
        assert merged["op.1"]["records_in"]["count"] == 7

    def test_reservoir_merge_is_deterministic_concatenation(self):
        def run(pkg):
            a = _registry_with(pkg, "op.0", lat_samples=[1.0, 2.0]).export_state()
            b = _registry_with(pkg, "op.0", lat_samples=[3.0, 4.0]).export_state()
            m1, m2 = pkg["cohort"].merge_states([a, b]), pkg["cohort"].merge_states([a, b])
            assert m1 == m2
            return m1["op.0"]["lat"], pkg["cohort"].state_to_snapshot(m1)["op.0"]["lat"]
        (kind, payload), summary = twin(run)
        assert kind == "histogram" and payload["samples"] == [1.0, 2.0, 3.0, 4.0]
        assert summary["p50"] == pytest.approx(2.5)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_seeded_states_merge_equal_across_packages(self, seed):
        """Three processes' seeded registries (meters, histograms, timers,
        counters, gauges of every policy) merge to the same tree, and
        each package merges the other's export trees the same way."""
        def states(pkg):
            rng = np.random.RandomState(seed)
            out = []
            for p in range(3):
                reg = pkg["registry"](seed=seed)
                for scope in ("op.0", "wire", f"op.{p + 1}", "checkpoint"):
                    g = reg.group(scope)
                    g.meter("records_in").mark(int(rng.randint(1, 100)))
                    g.counter("records").inc(int(rng.randint(1, 100)))
                    for v in rng.rand(int(rng.randint(1, 40))):
                        g.histogram("lat").record(float(v))
                    g.timer("flush").update(float(rng.rand()))
                    for name in ("backpressure_s", "queue_high_watermark", "chain_length",
                                 "last_checkpoint_id"):
                        g.gauge(name, lambda v=float(rng.rand() * 10): v)
                out.append(reg.export_state(max_samples=16))
            return out

        def run(pkg):
            merged = pkg["cohort"].merge_states(states(pkg))
            return _counts(pkg["cohort"].state_to_snapshot(merged))
        got = twin(run)
        assert got["wire"]["records"] > 0
        jax_states = states(PKGS["jax"])
        assert cohort.merge_states(jax_states) == jcohort.merge_states(jax_states)

    def test_gauges_follow_policy(self):
        def run(pkg):
            a = _registry_with(pkg, "op.0", gauges=[("backpressure_s", 2.0),
                                                    ("queue_high_watermark", 5),
                                                    ("chain_length", 3)]).export_state()
            b = _registry_with(pkg, "op.0", gauges=[("backpressure_s", 3.0),
                                                    ("queue_high_watermark", 9),
                                                    ("chain_length", 4)]).export_state()
            return _counts(pkg["cohort"].state_to_snapshot(
                pkg["cohort"].merge_states([a, b])))["op.0"]
        got = twin(run)
        assert got["backpressure_s"] == pytest.approx(5.0)
        assert got["queue_high_watermark"] == 9
        assert got["chain_length"] == 4

    def test_export_state_strides_large_reservoirs(self):
        def run(pkg):
            reg = _registry_with(pkg, "op.0", lat_samples=range(2000))
            state = reg.export_state(max_samples=100)
            assert state == reg.export_state(max_samples=100)
            return state["op.0"]["lat"]
        _, payload = twin(run)
        assert payload["count"] == 2000 and len(payload["samples"]) <= 100

    def test_collector_is_the_supervisor_feed(self):
        from flink_tensorflow_tpu.metrics import inspector as jinspector
        from flink_tensorflow_tpu_torch.metrics import inspector

        def run(pkg):
            collector = pkg["cohort"].CohortCollector(
                _registry_with(pkg, "op.0", records=10), 0, num_processes=3)
            collector.on_push(1, 1, _registry_with(pkg, "op.1", records=20).export_state())
            collector.on_push(2, 1, _registry_with(pkg, "op.2", records=30).export_state())
            # A stale sequence number is dropped (a control reconnect).
            collector.on_push(1, 1, _registry_with(pkg, "op.1", records=999).export_state())
            _, snap = collector.merged_snapshot()
            return collector.peers_reporting, collector.pushes, _counts(snap)
        peers, pushes, snap = twin(run)
        assert (peers, pushes) == ([1, 2], 2)
        assert [snap[f"op.{i}"]["records_in"]["count"] for i in range(3)] == [10, 20, 30]
        rows = inspector.build_live_rows(snap)
        assert rows == jinspector.build_live_rows(snap)
        assert [(r["operator"], r["subtask"]) for r in rows] == [("op", 0), ("op", 1),
                                                                  ("op", 2)]
        assert "op.1" in inspector.format_live_table(rows)


# ---------------------------------------------------------------------------
# telemetry service loopback (two services wired in threads)
# ---------------------------------------------------------------------------


def _loopback(pkg, skew):
    """Two services of ``pkg`` in this process (distinct fake pids), process
    0's clock shifted by ``skew`` on the wire: its pong stamps carry
    ``t + skew``.  Returns what each side learned."""
    reg0 = _registry_with(pkg, "op.0", records=4)
    reg1 = _registry_with(pkg, "op.1", records=6)
    tr0, tr1 = pkg["tracer"](), pkg["tracer"]()
    fl1 = pkg["flight"].FlightRecorder()
    services = {}

    def send_from(idx):
        def _send(peer, message):
            if message[0] == "clock_pong":
                kind, seq, t_send, t_server = message
                message = (kind, seq, t_send, t_server + skew)
            services[peer].on_control(idx, message)
        return _send

    Service = pkg["telemetry"].CohortTelemetryService
    services[0] = Service(process_index=0, num_processes=2, pid=11111, send=send_from(0),
                          registry=reg0, tracer=tr0, interval_s=0.05)
    services[1] = Service(process_index=1, num_processes=2, pid=22222, send=send_from(1),
                          registry=reg1, tracer=tr1, flight=fl1, interval_s=0.05)
    try:
        services[0].start()
        services[1].start()
        assert services[1].synced.wait(10.0), "peer never clock-synced"
        deadline = time.monotonic() + 10.0
        while ((services[0].collector.pushes == 0 or 22222 not in tr0.clock_offsets)
               and time.monotonic() < deadline):
            time.sleep(0.01)
        est = services[1].estimator
        _, snap = services[0].collector.merged_snapshot()
        return {
            "ready": est.ready, "offset": est.offset_s, "bound": est.error_bound_s,
            "tr0": dict(tr0.clock_offsets), "tr1": dict(tr1.clock_offsets),
            "meta1": dict(tr1.cohort_meta), "collector1": services[1].collector,
            "snap": _counts(snap),
            "synced_event": [e[:2] + (sorted(e[5]),) for e in fl1.events()
                             if e[1] == "clock.synced"],
        }
    finally:
        services[0].stop()
        services[1].stop()


class TestTelemetryServiceLoopback:
    def test_sync_pushes_and_offsets(self):
        for name, pkg in PKGS.items():
            got = _loopback(pkg, 0.0)
            # One physical clock: the true offset is 0, within the bound.
            assert got["ready"], name
            assert abs(got["offset"]) <= got["bound"] + 1e-3, name
            assert 22222 in got["tr0"] and 11111 in got["tr1"], name
            assert got["meta1"]["process_index"] == 1
            assert got["collector1"] is None
            assert got["snap"]["op.0"]["records_in"]["count"] == 4
            assert got["snap"]["op.1"]["records_in"]["count"] == 6

    @pytest.mark.parametrize("skew", [3.7, -125.25])
    def test_injected_skew_is_recovered_within_the_bound(self, skew):
        jax, port = _loopback(PKGS["jax"], skew), _loopback(PKGS["port"], skew)
        for got in (jax, port):
            assert abs(got["offset"] - skew) <= got["bound"] + 1e-6
            # Process 0 maps the peer's stamps by +skew, the peer maps
            # process 0's by -skew, each within the estimate's bound.
            assert abs(got["tr0"][22222] - skew) <= got["bound"] + 1e-6
            assert abs(got["tr1"][11111] + skew) <= got["bound"] + 1e-6
            assert got["meta1"]["offset_to_proc0_s"] == got["offset"]
        assert canon(port["snap"]) == canon(jax["snap"])
        assert port["synced_event"] == jax["synced_event"] == [
            ("telemetry", "clock.synced", ["error_bound_s", "offset_to_proc0_s", "peers"])]

    def test_the_same_control_kinds_and_message_handling(self):
        assert cohort_telemetry.KINDS == jtelemetry.KINDS

        def run(pkg):
            sent = []
            svc = pkg["telemetry"].CohortTelemetryService(
                process_index=0, num_processes=3, pid=1, send=lambda p, m: sent.append((p, m)),
                registry=pkg["registry"](), interval_s=0.05)
            svc._dispatch(5.0, 1, ("clock_ping", 1, 2, 7, 4.0))
            svc._dispatch(6.0, 1, ("clock_report", 1, 2, 0.25, 0.01))
            svc._dispatch(6.0, 1, ("metrics_push", 1, 3, {"op.1": {"n": ("counter", 4)}}))
            svc._safe_send(0, ("clock_table", {}, {}))  # never to itself
            return sent, svc.collector.pushes, svc.handles("hb"), svc.handles("clock_ping")
        sent, pushes, hb, ping = twin(run)
        assert sent[0] == (1, ("clock_pong", 7, 4.0, 5.0))
        assert [p for p, m in sent[1:]] == [1, 2]
        assert pushes == 1 and not hb and ping

    def test_a_failing_send_never_stops_the_service(self):
        def boom(peer, message):
            raise ConnectionError("peer down")

        svc = cohort_telemetry.CohortTelemetryService(
            process_index=1, num_processes=2, pid=2, send=boom, registry=MetricRegistry(),
            interval_s=0.02, startup_pings=2)
        svc.start()
        time.sleep(0.2)
        assert svc._thread.is_alive()
        svc.stop()
        assert not svc._thread.is_alive()


# ---------------------------------------------------------------------------
# 2-process port cohort: offset-corrected stitching end to end
# ---------------------------------------------------------------------------


def _spawn(index, ports, trace, health=None, n=120, throttle=0.01):
    cmd = [sys.executable, _WORKER, "--index", str(index), "--ports",
           ",".join(map(str, ports)), "--n", str(n), "--throttle", str(throttle),
           "--telemetry-interval", "0.2", "--trace", trace]
    if health:
        cmd += ["--health", health]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO),
                                                       os.environ.get("PYTHONPATH", "")]))
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _wait(proc, timeout=120):
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        raise AssertionError(f"worker hung:\n{out.decode(errors='replace')}")
    return proc.returncode, out.decode(errors="replace")


class TestCohortStitching:
    @pytest.fixture(scope="class")
    def cohort_run(self, tmp_path_factory):
        """One real two-process traced port cohort with the health plane on
        process 0: its two trace files and process 0's health report."""
        tmp = tmp_path_factory.mktemp("cohort")
        for _ in range(3):
            ports = free_ports(2)
            trace, report = str(tmp / "t.json"), str(tmp / "health.json")
            procs = [_spawn(i, ports, trace, health=report) for i in range(2)]
            logs = [_wait(p) for p in procs]
            if any("Address already in use" in log for _, log in logs):
                continue
            for rc, log in logs:
                assert rc == 0, f"worker failed:\n{log}"
            break
        paths = [f"{tmp}/t.proc{i}.json" for i in range(2)]
        for p in paths:
            assert os.path.exists(p), f"missing per-process trace {p}"
        with open(report) as f:
            return paths, json.load(f)

    def test_per_process_files_carry_cohort_blocks(self, cohort_run):
        docs = [json.loads(pathlib.Path(p).read_text()) for p in cohort_run[0]]
        meta0, meta1 = (d["cohort"] for d in docs)
        assert meta0["process_index"] == 0 and meta0["offset_to_proc0_s"] == 0.0
        assert meta1["process_index"] == 1
        # The peer synced before export: a finite sub-second bound, not the
        # pre-sync infinity.
        assert np.isfinite(meta1["error_bound_s"]) and meta1["error_bound_s"] < 0.5
        assert set(meta0) == set(meta1) == {"process_index", "pid", "offset_to_proc0_s",
                                            "error_bound_s", "epoch_monotonic_s"}

    def test_merged_timeline_stitches_cross_process_records(self, cohort_run):
        merged = stitch.merge_cohort_trace_files(cohort_run[0])
        assert merged["cohort_merge"]["max_error_bound_s"] < 0.5
        names = {e.get("name") for e in merged["traceEvents"]}
        for span in ("emit", "serde", "wire", "wire.flush", "queue", "process"):
            assert span in names, f"{span} span missing from merged trace"
        stitched = stitch.cross_process_traces(merged)
        assert stitched == jstitch.cross_process_traces(merged)
        assert stitched, "no record's spans crossed the process boundary"
        # One host's processes share a clock, so the true offset is 0 and
        # a journey's order holds within the estimate's error bound.
        bound = merged["cohort_merge"]["max_error_bound_s"] + 1e-6
        crossing_queues = 0
        for spans in stitched.values():
            assert len({s[2] for s in spans}) == 2
            assert all(t1 >= t0 for t0, t1, *_ in spans)
            # Minted at the source on process 0, first up to the bound.
            (emit,) = [s for s in spans if s[4] == "emit"]
            assert emit[2] == 0 and emit[0] <= spans[0][0] + bound
            for t0, _t1, pidx, _track, name in spans:
                if name == "queue" and pidx != 0:
                    crossing_queues += 1
                    assert t0 >= emit[0] - bound
        assert crossing_queues > 0, "cross-process queue spans were suppressed"

    def test_merge_equals_the_jax_merge(self, cohort_run):
        assert stitch.merge_cohort_trace_files(cohort_run[0]) == \
            jstitch.merge_cohort_trace_files(cohort_run[0])

    def test_cohort_cli_merges_and_reports(self, cohort_run, tmp_path, capsys):
        from flink_tensorflow_tpu_torch.tracing.cli import main

        out = str(tmp_path / "merged.json")
        assert main(["--cohort", *cohort_run[0], "--out", out]) == 0
        assert "cross-process" in capsys.readouterr().out
        merged = json.loads(pathlib.Path(out).read_text())
        assert merged["cohort_merge"]["processes"][1]["process_index"] == 1

    def test_process_zero_evaluates_the_merged_cohort_snapshot(self, cohort_run):
        report = cohort_run[1]
        assert report["pushes"] > 0 and report["peers_reporting"] == [1]
        snap = report["snapshot"]
        # work.1 runs on process 1: its metrics reached process 0's feed.
        assert snap["work.1"]["records_in"]["count"] > 0
        assert report["health"]["ticks"] >= 1
        assert snap["health"]["job"] == 0 and report["health"]["job"] == "OK"

    def test_merge_refuses_non_cohort_files(self, tmp_path):
        p = tmp_path / "plain.json"
        p.write_text(json.dumps({"traceEvents": []}))

        def run(pkg):
            with pytest.raises(ValueError) as info:
                pkg["stitch"].merge_cohort_trace_files([str(p), str(p)])
            return str(info.value)
        assert "cohort" in twin(run)


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------


class TestFlightRecorder:
    def test_ring_is_bounded(self):
        def run(pkg):
            fr = pkg["flight"].FlightRecorder(capacity=8)
            for i in range(100):
                fr.record("t", f"e{i}")
            return [e[:3] + e[4:] for e in fr.events()]
        events = twin(run)
        assert len(events) == 8 and events[-1][1] == "e99"

    def test_metric_delta_is_per_active_scope(self):
        snap = {"op.0": {"records_in": {"count": 10}, "records_out": {"count": 9},
                         "queue_depth": 2},
                "idle.0": {"records_in": {"count": 0}, "records_out": {"count": 0}}}

        def run(pkg):
            fr = pkg["flight"].FlightRecorder()
            fr.metric_delta(snap)
            fr.metric_delta(snap)
            return [e[5] for e in fr.events() if e[1] == "metrics.delta"]
        assert twin(run) == [{"records_in": 10, "records_out": 9, "queue_depth": 2}]

    def test_dump_idempotent_per_reason(self, tmp_path):
        def run(pkg):
            fr = pkg["flight"].FlightRecorder()
            fr.record("job", "start")
            name = pkg["flight"].__name__.split(".")[0]
            path = str(tmp_path / f"{name}.f.json")
            return (fr.dump(path, "crash") == path, fr.dump(path, "crash"),
                    fr.dump(str(tmp_path / f"{name}.g.json"), "signal") is not None)
        assert twin(run) == (True, None, True)

    def test_crash_dumps_black_box(self, tmp_path):
        from flink_tensorflow_tpu_torch.core.runtime import JobFailure
        from flink_tensorflow_tpu_torch.tracing.cli import main

        def boom(x):
            if x >= 50:
                raise RuntimeError("synthetic crash")
            return x

        def dump_of(pkg):
            return str(tmp_path / f"{pkg['flight'].__name__.split('.')[0]}.flight.json")

        def run(pkg):
            env = pkg["env"]().configure(flight_path=dump_of(pkg))
            (env.from_collection(list(range(200))).map(boom, name="boom")
                .sink_to_callable(lambda v: None))
            with pytest.raises(Exception) as info:
                env.execute("t", timeout=60)
            doc = pkg["flight"].load_flight_dump(dump_of(pkg))
            failure = next(e for e in doc["events"] if e[1] == "failure")
            return (doc["reason"], type(info.value).__name__,
                    "synthetic crash" in failure[5]["error"],
                    {e[1] for e in doc["events"]} >= {"start", "failure"})
        assert twin(run) == ("crash", JobFailure.__name__, True, True)
        dump = dump_of(PKGS["port"])
        assert main(["--from-flight-dump", dump, "--out", str(tmp_path / "replay.json")]) == 0
        chrome = json.loads((tmp_path / "replay.json").read_text())
        assert any(e.get("name") == "failure" for e in chrome["traceEvents"])

    def test_cancel_dumps(self, tmp_path):
        dump = str(tmp_path / "flight.json")
        env = StreamExecutionEnvironment().configure(flight_path=dump, source_throttle_s=0.01)
        (env.from_collection(list(range(50_000))).map(lambda x: x, name="m")
            .sink_to_callable(lambda v: None))
        handle = env.execute_async("t")
        time.sleep(0.3)
        handle.cancel()
        assert flight.load_flight_dump(dump)["reason"] == "cancel"

    def test_sigterm_flushes_reporter_and_dumps(self, tmp_path):
        dump, jsonl = tmp_path / "flight.json", tmp_path / "reports.jsonl"
        script = f"""
import dataclasses, os, signal, time
from flink_tensorflow_tpu_torch import StreamExecutionEnvironment

env = StreamExecutionEnvironment().configure(flight_path={str(dump)!r},
                                             source_throttle_s=0.005)
env.configure(metrics=dataclasses.replace(env.config.metrics, report_interval_s=0.1,
                                          jsonl_path={str(jsonl)!r}))
(env.from_collection(list(range(100000))).map(lambda x: x, name="m")
    .sink_to_callable(lambda v: None))
handle = env.execute_async("sig")
time.sleep(1.0)
os.kill(os.getpid(), signal.SIGTERM)
time.sleep(30)
"""
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO),
                                                           os.environ.get("PYTHONPATH", "")]))
        proc = subprocess.run([sys.executable, "-c", script], env=env, timeout=120,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        assert proc.returncode == -signal.SIGTERM, proc.stdout.decode(errors="replace")
        assert flight.load_flight_dump(str(dump))["reason"] == "signal"
        reports = [json.loads(x) for x in jsonl.read_text().splitlines() if x]
        assert reports, "the reporter never flushed before death"
        scopes = reports[-1].get("metrics", reports[-1])
        assert any("records_in" in (v or {}) for v in scopes.values() if isinstance(v, dict))

    def test_shutdown_flusher_mechanics(self):
        def run(pkg):
            ran = []
            flusher = pkg["flight"].ShutdownFlusher([lambda: ran.append(1), lambda: 1 / 0,
                                                     lambda: ran.append(2)])
            flusher.flush()
            installed = flusher.install()
            try:
                again = flusher.install()
            finally:
                flusher.uninstall()
            results = []
            t = threading.Thread(
                target=lambda: results.append(pkg["flight"].ShutdownFlusher([]).install()))
            t.start()
            t.join()
            return ran, installed, again, results
        assert twin(run) == ([1, 2], True, False, [False])

    def test_off_path_is_zero_alloc(self):
        def build():
            env = StreamExecutionEnvironment().configure(flight_recorder=False, trace=False)
            out = []
            (env.from_collection(list(range(200))).map(lambda x: x + 1, name="inc")
                .sink_to_callable(out.append))
            return env, out

        warm_env, _ = build()
        warm_env.execute("warmup", timeout=60)
        env, out = build()
        tracemalloc.start()
        try:
            handle = env.execute_async("t")
            handle.wait(60)
            snap = tracemalloc.take_snapshot()
        finally:
            tracemalloc.stop()
        assert len(out) == 200 and handle.executor.flight is None
        pkg = str(REPO / "flink_tensorflow_tpu_torch" / "tracing")
        stats = snap.filter_traces(
            [tracemalloc.Filter(True, pkg + "/flight.py")]).statistics("filename")
        assert sum(s.size for s in stats) == 0, stats

    def test_default_on_and_env_override(self, monkeypatch):
        def run(pkg):
            env = pkg["env"]()
            (env.from_collection([1, 2, 3]).sink_to_callable(lambda v: None))
            handle = env.execute_async("t")
            handle.wait(60)
            return handle.executor.flight is not None, any(
                e[1] == "start" for e in handle.executor.flight.events())
        assert twin(run) == (True, True)
        monkeypatch.setenv("FLINK_TPU_FLIGHT", "0")
        env = StreamExecutionEnvironment()
        env.from_collection([1]).sink_to_callable(lambda v: None)
        handle = env.execute_async("t")
        handle.wait(60)
        assert handle.executor.flight is None


# ---------------------------------------------------------------------------
# reactor observability
# ---------------------------------------------------------------------------


class TestReactorObservability:
    def test_reactor_and_writer_gauges_registered(self):
        def run(pkg):
            sh = pkg["shuffle"]
            reg = pkg["registry"](seed=0)
            gate = pkg["gate"](2, capacity=64)
            server = sh.ShuffleServer("127.0.0.1", metrics=reg)
            server.register_gate("op", 1, gate)
            server.start()
            try:
                w = sh.RemoteChannelWriter("127.0.0.1", server.port, "op", 1, 1,
                                           connect_timeout_s=10.0, metrics=reg)
                for i in range(5):
                    w.write(pkg["el"].StreamRecord(i))
                w.write(pkg["el"].EndOfPartition())
                for _ in range(6):
                    assert gate.poll(timeout=10.0) is not None
                deadline = time.monotonic() + 5.0
                while (not reg.snapshot().get("reactor", {}).get("dispatches")
                       and time.monotonic() < deadline):
                    time.sleep(0.01)
                snap = reg.snapshot()
                w.close()
            finally:
                server.close()
            reactor = snap["reactor"]
            assert reactor["dispatches"] >= 1 and reactor["connections"] >= 1
            assert reactor["max_poll_to_dispatch_s"] >= reactor["poll_to_dispatch_s"] >= 0.0
            out, inn = snap["shuffle.out.op.1.ch1"], snap["shuffle.in.op.1.ch1"]
            return (sorted(reactor), out["send_queue_depth"], out["send_queue_bytes"],
                    inn["gate_paused"] >= 0, out["records"], inn["records"])
        assert twin(run)[1:] == (0, 0, True, 5, 5)

    def test_full_gate_pause_ticks_counter(self):
        def run(pkg):
            sh = pkg["shuffle"]
            reg = pkg["registry"](seed=0)
            gate = pkg["gate"](1, capacity=2)
            server = sh.ShuffleServer("127.0.0.1", metrics=reg)
            server.register_gate("op", 0, gate)
            server.start()
            try:
                w = sh.RemoteChannelWriter("127.0.0.1", server.port, "op", 0, 0,
                                           connect_timeout_s=10.0, flush_bytes=0)
                for i in range(64):
                    w.write(pkg["el"].StreamRecord(i))
                deadline = time.monotonic() + 10.0
                while ((reg.snapshot().get("shuffle.in.op.0.ch0", {}).get("gate_paused") or 0)
                       < 1 and time.monotonic() < deadline):
                    time.sleep(0.01)
                paused = reg.snapshot()["shuffle.in.op.0.ch0"]["gate_paused"] >= 1
                for _ in range(64):
                    if gate.poll(timeout=5.0) is None:
                        break
                w.close()
            finally:
                server.close()
            return paused
        assert twin(run) is True


# ---------------------------------------------------------------------------
# the record plane's spans
# ---------------------------------------------------------------------------


def _records(pkg, n, floats=16, seed=0):
    rng = np.random.RandomState(seed)
    return [pkg["value"]({"x": rng.rand(floats).astype(np.float32)}, {"i": i})
            for i in range(n)]


def _writer_spans(pkg, n, *, columnar=True, traced_records=False, **knobs):
    """``n`` records through a traced loopback writer of ``pkg``: the
    writer's spans as (track, name, args) and the records the gate got."""
    sh = pkg["shuffle"]
    tracer = pkg["tracer"](sample_rate=1.0, seed=0)
    gate = pkg["gate"](1, capacity=4096)
    server = sh.ShuffleServer("127.0.0.1")
    server.register_gate("op", 0, gate)
    server.start()
    got = []
    try:
        w = sh.RemoteChannelWriter("127.0.0.1", server.port, "op", 0, 0,
                                   connect_timeout_s=10.0, tracer=tracer, columnar=columnar,
                                   **knobs)
        for i, value in enumerate(_records(pkg, n)):
            ctx = pkg["tracer"].fork(TraceContextOf(pkg)(1000 + i, 4242), 12.5) \
                if traced_records else None
            w.write(pkg["el"].StreamRecord(value, None, ctx))
        w.write(pkg["el"].EndOfPartition())
        while True:
            item = gate.poll(timeout=10.0)
            assert item is not None
            if isinstance(item[1], pkg["el"].EndOfPartition):
                break
            got.append(item[1])
        w.close()
    finally:
        server.close()
    spans = [(e[0], e[1], e[5]) for e in tracer.events()]
    return spans, got


def TraceContextOf(pkg):
    from flink_tensorflow_tpu.tracing.tracer import TraceContext as JaxContext

    return JaxContext if pkg is PKGS["jax"] else TraceContext


class TestRecordPlaneSpans:
    #: Four records per frame by size, no timer flush.
    COALESCED = dict(flush_bytes=4 * (16 * 4 + 64), flush_ms=1e6)

    @pytest.mark.parametrize("n", [1, 10, 33])
    def test_coalesced_columnar_spans_equal_jax(self, n):
        def run(pkg):
            spans, got = _writer_spans(pkg, n, **self.COALESCED)
            return [(t, name, {k: v for k, v in a.items() if k != "bytes"})
                    for t, name, a in spans], len(got)
        spans, delivered = twin(run)
        assert delivered == n
        names = [s[1] for s in spans]
        frames = -(-n // 4)
        assert names == ["wire.flush", "serde", "wire"] * frames
        assert sum(s[2]["records"] for s in spans if s[1] == "serde") == n
        assert all(s[0] == "op.0" for s in spans)
        reasons = [s[2]["reason"] for s in spans if s[1] == "wire.flush"]
        assert reasons == ["size"] * (n // 4) + ["close"] * (frames - n // 4)

    def test_columnar_frames_carry_the_jax_bytes(self):
        """A coalesced columnar frame's ``serde`` bytes equal the JAX
        writer's but for the frame class's module path in the pickle."""
        def frame_bytes(pkg):
            spans, _ = _writer_spans(pkg, 8, **self.COALESCED)
            return [a["bytes"] for _, name, a in spans if name == "serde"]
        jax, port = frame_bytes(PKGS["jax"]), frame_bytes(PKGS["port"])
        extra = len("flink_tensorflow_tpu_torch") - len("flink_tensorflow_tpu")
        assert port == [b + extra for b in jax]

    def test_pickled_runs_and_lone_records_match_jax_but_for_bytes(self):
        """A frame of pickled records (``columnar=False``) and a frame per
        record (``flush_bytes=0``): the same span names, counts and args;
        the pickled bytes name each package's own classes."""
        def run(pkg):
            out = []
            for knobs in (dict(columnar=False, **self.COALESCED),
                          dict(flush_bytes=0, flush_ms=0.0)):
                spans, got = _writer_spans(pkg, 9, **knobs)
                out.append(([(t, n, {k: v for k, v in a.items() if k != "bytes"})
                             for t, n, a in spans], len(got)))
            return out
        (coalesced, n1), (lone, n2) = twin(run)
        assert n1 == n2 == 9
        assert [s[1] for s in lone] == ["serde", "wire"] * 9
        assert [s[1] for s in coalesced] == ["wire.flush", "serde", "wire"] * 3

    def test_trace_contexts_cross_in_every_frame_shape(self):
        """Records carrying contexts keep them through a columnar frame, a
        pickled run and a lone frame, as the JAX plane does."""
        for knobs in (self.COALESCED, dict(columnar=False, **self.COALESCED),
                      dict(flush_bytes=0, flush_ms=0.0)):
            def run(pkg, knobs=knobs):
                _, got = _writer_spans(pkg, 6, traced_records=True, **knobs)
                return [(r.trace.trace_id, r.trace.origin, r.trace.t_queue) for r in got]
            assert twin(run) == [(1000 + i, 4242, 12.5) for i in range(6)]

    def test_a_foreign_enqueue_stamp_is_offset_corrected_on_delivery(self):
        """The receiving subtask's queue span for a record minted on a peer:
        suppressed before the clock sync, offset-corrected after it."""
        def run(pkg):
            tracer = pkg["tracer"]()
            ctx = TraceContextOf(pkg)(7, 4242, 100.0)
            tracer.queue_span("op.0", ctx, 50.0)
            before = len(tracer.events())
            tracer.set_clock_offset(4242, -60.0, 0.001)
            tracer.queue_span("op.0", ctx, 50.0)
            tracer.queue_span("op.0", TraceContextOf(pkg)(8, 4242, 200.0), 50.0)
            return before, [(e[1], e[3], e[4], e[5]) for e in tracer.events()]
        before, events = twin(run)
        assert before == 0
        assert events == [("queue", 40.0, 10.0, {"trace": 7, "origin": 4242}),
                          ("queue", 50.0, 0.0, {"trace": 8, "origin": 4242})]

    def test_untraced_records_cross_without_contexts(self):
        """Records without contexts ride a columnar frame whose trace
        column is None, as the JAX frame's, and arrive without one."""
        def run(pkg):
            frame = pkg["shuffle"].ColumnarFrame(np.arange(4, dtype=np.uint8), None, None)
            sh = pkg["shuffle"]
            gate = pkg["gate"](1, capacity=64)
            server = sh.ShuffleServer("127.0.0.1")
            server.register_gate("op", 0, gate)
            server.start()
            try:
                w = sh.RemoteChannelWriter("127.0.0.1", server.port, "op", 0, 0,
                                           connect_timeout_s=10.0, **self.COALESCED)
                for value in _records(pkg, 8):
                    w.write(pkg["el"].StreamRecord(value))
                w.write(pkg["el"].EndOfPartition())
                got = [gate.poll(timeout=10.0)[1] for _ in range(9)]
                w.close()
            finally:
                server.close()
            return frame.__getstate__()[1:], [r.trace for r in got[:-1]]
        assert twin(run) == ((None, None), [None] * 8)

    def test_credit_waits_show_under_overload(self):
        """The reference bench's overload: credits on park the producer
        (``wire.credit_wait`` spans, a send queue under the window bound);
        off, the queue grows past it."""
        from flink_tensorflow_tpu_torch.core import overload_probe as probe

        on = probe.overload_arm(True, 600, stall_s=0.2)
        off = probe.overload_arm(False, 600, stall_s=0.2)
        assert on["records_delivered"] == off["records_delivered"] == 600
        assert on["trace_attribution"]["wire.credit_wait"]["count"] > 0
        assert "wire.credit_wait" not in off["trace_attribution"]
        assert on["peak_send_queue_bytes"] <= probe.credit_bound_bytes()
        assert off["peak_send_queue_bytes"] > on["peak_send_queue_bytes"]
        for arm in (on, off):
            table = arm["trace_attribution"]
            assert table["serde"]["count"] == table["wire"]["count"] == \
                table["wire.flush"]["count"]

    def test_trace_attribution_pass_counts_every_record(self):
        from flink_tensorflow_tpu_torch.core import overload_probe as probe

        coalesced = probe.trace_attribution(300, 64)
        lone = probe.trace_attribution(300, 64, flush_bytes=0)
        assert lone["serde"]["count"] == lone["wire"]["count"] == 300
        assert "wire.flush" not in lone
        assert coalesced["serde"]["count"] == coalesced["wire.flush"]["count"] < 300


# ---------------------------------------------------------------------------
# the pipe's spans and wire latency
# ---------------------------------------------------------------------------


def _pipe(pkg, n, *, offset=None, sink_kwargs=None):
    """``n`` records from a traced job through ``RemoteSink`` into a traced
    job's ``RemoteSource``: both tracers' events and what arrived.
    ``offset`` registers the sink process's clock offset on the source's
    tracer before it opens (the clock sync's job in a cohort)."""
    source = pkg["remote"].RemoteSource(bind="127.0.0.1")
    up = {}

    def upstream():
        env = pkg["env"](parallelism=1)
        env.configure(trace=True)
        (env.from_collection(_records(pkg, n))
            .add_sink(pkg["remote"].RemoteSink("127.0.0.1", source.port,
                                               **(sink_kwargs or {}))))
        handle = env.execute_async("up")
        handle.wait(60)
        up["tracer"] = handle.executor.tracer

    t = threading.Thread(target=upstream)
    t.start()
    env2 = pkg["env"](parallelism=1)
    env2.configure(trace=True)
    out = env2.from_source(source).sink_to_list()
    handle2 = env2.execute_async("down")
    if offset is not None:
        handle2.executor.tracer.set_clock_offset(os.getpid(), offset, 0.0005)
    handle2.wait(60)
    t.join()
    return up["tracer"].events(), handle2.executor.tracer.events(), out, handle2


def _ids(events, name, track):
    return sorted(e[5]["trace"] for e in events
                  if e[1] == name and e[0] == track and e[5] and "trace" in e[5])


class TestPipeSpans:
    def test_trace_ids_cross_the_pipe_as_in_jax(self):
        def run(pkg):
            up, down, out, _ = _pipe(pkg, 30, sink_kwargs=dict(flush_bytes=4 * 128,
                                                               flush_ms=1e6))
            up_ids = _ids(up, "emit", "collection.0")
            down_ids = _ids(down, "emit", "source.0")
            assert down_ids == up_ids and len(up_ids) == 30
            assert all("__trace__" not in r.meta for r in out)
            sink = [(e[1], {k: v for k, v in e[5].items() if k != "bytes"})
                    for e in up if e[1] in ("serde", "wire", "wire.flush")]
            source = [(e[1], e[5]["records"]) for e in down if e[1] == "serde"]
            return sink, sum(r for _, r in source), len(out)
        sink, received, delivered = twin(run)
        assert received == delivered == 30
        assert [n for n, _ in sink] == ["wire.flush", "serde", "wire"] * 8
        assert sum(a["records"] for n, a in sink if n == "serde") == 30
        assert all(a["columnar"] for n, a in sink if n == "serde")

    def test_wire_latency_needs_the_origins_offset(self):
        _, _, out, handle = _pipe(PKGS["port"], 20)
        snap = handle.metrics.snapshot()["source.0"]
        assert len(out) == 20
        assert snap["edge.wire_latency_s"]["count"] == 0.0
        assert snap["edge.wire_latency_err_s"] == 0.0
        _, _, out, handle = _pipe(PKGS["port"], 20, offset=0.0)
        snap = handle.metrics.snapshot()["source.0"]
        assert snap["edge.wire_latency_s"]["count"] > 0
        assert 0.0 <= snap["edge.wire_latency_s"]["p50"] < 5.0
        assert snap["edge.wire_latency_err_s"] == 0.0005

    def test_sink_credit_waits_are_spans(self):
        """A sink parked at zero credit behind a stalled source records
        ``wire.credit_wait`` spans with the credit mode, as the JAX sink."""
        def run(pkg):
            source = pkg["remote"].RemoteSource(bind="127.0.0.1", queue_capacity=2)
            stalled = threading.Event()

            def slow(v):
                if not stalled.is_set():
                    stalled.set()
                    time.sleep(0.3)
                return v

            up = {}

            def upstream():
                env = pkg["env"](parallelism=1)
                env.configure(trace=True)
                (env.from_collection(_records(pkg, 40))
                    .add_sink(pkg["remote"].RemoteSink("127.0.0.1", source.port,
                                                       flush_bytes=0, flow_control=True)))
                handle = env.execute_async("up")
                handle.wait(60)
                up["events"] = handle.executor.tracer.events()

            t = threading.Thread(target=upstream)
            t.start()
            env2 = pkg["env"](parallelism=1)
            out = env2.from_source(source).map(slow).sink_to_list()
            env2.execute("down", timeout=60)
            t.join()
            waits = [e for e in up["events"] if e[1] == "wire.credit_wait"]
            return len(out), bool(waits), {e[5]["mode"] for e in waits}
        assert twin(run) == (40, True, {"data"})


# ---------------------------------------------------------------------------
# the cohort executor's telemetry wiring
# ---------------------------------------------------------------------------


def _thread_cohort(build, *, timeout=60.0, **config):
    """Two executors of one cohort on threads of this process (one pid, so
    no offset is ever applied: the pre-sync identity stays); returns each
    process's handle.  A cohort whose bind lost a port race runs again."""
    for _ in range(3):
        peers = tuple(f"127.0.0.1:{p}" for p in free_ports(2))
        handles, errors = {}, []

        def run(proc):
            try:
                env = StreamExecutionEnvironment(parallelism=1)
                env.set_distributed(DistributedConfig(proc, 2, peers, connect_timeout_s=10.0,
                                                      **config))
                build(env, proc)
                handles[proc] = env.execute_async("cohort")
                handles[proc].wait(timeout)
            except BaseException as exc:  # noqa: BLE001 - reported below
                errors.append(exc)

        threads = [threading.Thread(target=run, args=(p,)) for p in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout + 30)
        if any("Address already in use" in repr(e) for e in errors):
            continue
        assert not errors, f"cohort failed: {errors!r}"
        return handles
    raise AssertionError("no free ports for the cohort")


def test_a_traced_cohort_writes_one_trace_per_process_with_pre_sync_bounds(tmp_path):
    trace = str(tmp_path / "t.json")

    def build(env, proc):
        env.configure(trace=True, trace_path=trace, sanitize=True)
        (env.from_collection(list(range(40)), parallelism=1)
            .map(lambda x: x + 1, name="work", parallelism=2)
            .sink_to_callable(lambda v: None, name="sink", parallelism=1))

    handles = _thread_cohort(build, telemetry_interval_s=0.0)
    for proc in (0, 1):
        executor = handles[proc].executor
        assert executor.trace_path == str(tmp_path / f"t.proc{proc}.json")
        meta = json.loads(pathlib.Path(executor.trace_path).read_text())["cohort"]
        assert meta["process_index"] == proc
        # Unsynced: a peer's bound is infinite, process 0's exact.
        want = float("inf") if proc else 0.0
        assert meta["error_bound_s"] == want
        assert executor.sanitizer.cohort_meta["error_bound_s"] == want
    assert handles[0].executor.cohort_collector is not None
    assert handles[1].executor.cohort_collector is None
    # A telemetry interval of 0 starts no service thread.
    assert handles[0].executor._telemetry._thread is None
    events = handles[0].executor.tracer.events() + handles[1].executor.tracer.events()
    assert {"wire.flush", "serde", "wire"} <= {e[1] for e in events}


def test_the_heartbeat_monitor_records_peer_lost(tmp_path):
    """A peer that never starts: process 0 fails the job after the connect
    window plus the heartbeat timeout, and its flight ring holds
    ``cohort/peer.lost`` as the JAX monitor records it."""
    from flink_tensorflow_tpu.core.distributed import DistributedConfig as JaxDist
    from flink_tensorflow_tpu_torch.core.runtime import JobFailure

    def run(pkg):
        Dist = JaxDist if pkg is PKGS["jax"] else DistributedConfig
        peers = tuple(f"127.0.0.1:{p}" for p in free_ports(2))
        env = pkg["env"](parallelism=1)
        env.configure(source_throttle_s=0.005)
        env.set_distributed(Dist(0, 2, peers, connect_timeout_s=0.5,
                                 heartbeat_timeout_s=0.3, telemetry_interval_s=0.0))
        (env.from_collection(list(range(4000)), parallelism=1)
            .sink_to_callable(lambda v: None, parallelism=1))
        handle = env.execute_async("lonely")
        with pytest.raises(Exception) as info:
            handle.wait(60)
        lost = [e for e in handle.executor.flight.events() if e[1] == "peer.lost"]
        return (type(info.value).__name__, "silent" in str(info.value),
                [(e[0], e[1], sorted(e[5]), e[5]["peer"], e[5]["epoch"]) for e in lost])
    exc, said, lost = twin(run)
    assert exc == JobFailure.__name__ and said
    assert lost == [("cohort", "peer.lost", ["epoch", "peer", "silent_s"], 1, 0)]


LIVE_PIPELINE = """
import sys

from flink_tensorflow_tpu_torch import DistributedConfig, StreamExecutionEnvironment


def main(argv):
    index, ports = int(argv[argv.index("--index") + 1]), argv[argv.index("--ports") + 1]
    env = StreamExecutionEnvironment(parallelism=1)
    env.configure(source_throttle_s=0.002)
    env.set_distributed(DistributedConfig(
        index, 2, tuple(f"127.0.0.1:{p}" for p in ports.split(",")), connect_timeout_s=30.0,
        telemetry_interval_s=0.1))
    (env.from_collection(list(range(600)), parallelism=1)
        .map(lambda x: x + 1, name="work", parallelism=2)
        .sink_to_callable(lambda v: None, name="sink", parallelism=1))
    env.execute("live-cohort", timeout=120)


if __name__ == "__main__":
    main(sys.argv[1:])
"""


def test_live_cohort_inspector_shows_the_merged_view(tmp_path):
    """``python -m flink_tensorflow_tpu_torch.metrics --live --cohort`` on
    process 0 of a two-process cohort renders rows for both processes'
    subtasks from the cohort collector."""
    script = tmp_path / "live_pipeline.py"
    script.write_text(LIVE_PIPELINE)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO),
                                                       os.environ.get("PYTHONPATH", "")]))
    for _ in range(3):
        ports = ",".join(map(str, free_ports(2)))
        args = f"--index 0 --ports {ports}"
        inspect = subprocess.Popen(
            [sys.executable, "-m", "flink_tensorflow_tpu_torch.metrics", str(script), "--live",
             "--cohort", "--live-interval", "0.2", "--job-args", args],
            env=env, cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        peer = subprocess.Popen([sys.executable, str(script), "--index", "1", "--ports", ports],
                                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        out, err = inspect.communicate(timeout=180)
        peer_out, _ = peer.communicate(timeout=60)
        if b"Address already in use" in err + peer_out:
            continue
        break
    assert inspect.returncode == 0, err.decode(errors="replace")
    assert peer.returncode == 0, peer_out.decode(errors="replace")
    text = out.decode()
    assert "cohort 2/2 procs" in text
    snap = json.loads(text.strip().splitlines()[-1])
    assert snap["cohort"]["peers_reporting"] == [1] and snap["cohort"]["pushes"] > 0
    rows = {(r["operator"], r["subtask"]): r for r in snap["subtasks"]}
    assert rows[("work", 1)]["records_in"] > 0  # process 1's subtask
    assert rows[("work", 0)]["records_in"] > 0
