"""The port's metric plane held to the JAX package's
(``flink_tensorflow_tpu/metrics``) on the same inputs: the repaired
registry (seeded reservoirs, gauges, timers, snapshots, exported state),
the reporters (the Prometheus exposition byte for byte), ``MetricConfig``
validation, the inspector's folds and tables, the runtime's per-subtask
catalogue and the two CLIs.  Pure functions are held exactly; the
catalogue by its metric names."""

import json
import os
import pathlib
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from flink_tensorflow_tpu import StreamExecutionEnvironment as JaxEnv
from flink_tensorflow_tpu.metrics import inspector as jinspector
from flink_tensorflow_tpu.metrics import registry as jregistry
from flink_tensorflow_tpu.metrics import reporters as jreporters
from flink_tensorflow_tpu.tracing import flight as jflight
from flink_tensorflow_tpu_torch import StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.core.runtime import JobFailure
from flink_tensorflow_tpu_torch.metrics import inspector, registry, reporters
from flink_tensorflow_tpu_torch.utils import profiling

REPO = pathlib.Path(__file__).resolve().parents[1]


# -- the registry ---------------------------------------------------------------------

@pytest.mark.parametrize("capacity,n", [(64, 50), (64, 1000), (65536, 70000)])
def test_reservoirs_and_summaries_equal_jax_for_the_same_seed(capacity, n):
    values = np.random.RandomState(1).lognormal(size=n).tolist()
    mine = registry.Histogram(capacity=capacity, seed=123)
    theirs = jregistry.Histogram(capacity=capacity, seed=123)
    for v in values:
        mine.record(v)
        theirs.record(v)
    assert mine.values == theirs._samples
    assert mine.summary() == theirs.summary()
    assert mine.count == theirs.count == n
    assert len(mine.values) == min(capacity, n)


def _fill_registry(mod, seed):
    reg = mod.MetricRegistry(seed=seed)
    rng = np.random.RandomState(2)
    for scope in ("op.0", "op.1", "sink.0"):
        grp = reg.group(scope)
        grp.counter("batches").inc(int(rng.randint(1, 9)))
        tm = grp.timer("process_latency_s")
        hist = grp.histogram("batch_latency_s")
        for _ in range(3000):
            tm.update(float(rng.rand()))
            hist.record(float(rng.rand()))
        grp.gauge("queue_depth", lambda s=scope: len(s))
        grp.gauge("broken", lambda: 1 / 0)
    return reg


def _without_rates(tree):
    """Meters' rates read the wall clock: drop them to compare."""
    return {scope: {name: ({k: v for k, v in val.items() if "rate" not in k}
                           if isinstance(val, dict) else val)
                    for name, val in metrics.items()}
            for scope, metrics in tree.items()}


@pytest.mark.parametrize("seed", [0, 7])
def test_registry_snapshot_and_export_state_equal_jax(seed):
    mine, theirs = _fill_registry(registry, seed), _fill_registry(jregistry, seed)
    assert mine.metric_seed("op.0", "x") == theirs.metric_seed("op.0", "x")
    assert mine.snapshot() == theirs.snapshot()
    assert mine.report() == theirs.report()
    assert mine.export_state(max_samples=100) == theirs.export_state(max_samples=100)
    assert mine.snapshot()["op.0"]["broken"] is None
    assert mine.groups() == ["op.0", "op.1", "sink.0"]


def test_meters_and_counters_keep_the_port_names():
    reg = registry.MetricRegistry()
    grp = reg.group("a.0")
    grp.counter("n").inc(3)
    assert grp.counter("n").count == grp.counter("n").value == 3
    m = grp.meter("m")
    m.mark(5)
    assert m.window_rate() > 0
    reg.reset_windows()
    assert m.count == 5 and m.window_rate() == 0.0
    assert set(reg.snapshot()["a.0"]["m"]) == {"count", "rate", "window_rate"}
    # A gauge re-registered re-points; one read without fn returns it.
    grp.gauge("g", lambda: 1)
    grp.gauge("g", lambda: 2)
    assert grp.gauge("g").value() == 2
    bare = registry.MetricGroup("bare.0")
    bare.counter("x").inc()
    assert bare.counter("x").count == 1


# -- reporters ------------------------------------------------------------------------

def _snapshot():
    return {
        "op.0": {"records_in": {"count": 10, "rate": 2.5, "window_rate": float("nan")},
                 "queue_depth": 3, "busy_s": 0.125, "flag": True, "name": "x",
                 "hbm_bytes_in_use": None, "lat": {"p50": 0.5, "p99": float("inf")}},
        "checkpoint": {"completed": 2, "last_checkpoint_id": 2},
        "weird scope/1": {"9lives": 1.0, "a-b": 2},
    }


def test_prometheus_exposition_is_byte_equal_to_jax():
    assert reporters.prometheus_exposition(_snapshot(), 1234.5) == \
        jreporters.prometheus_exposition(_snapshot(), 1234.5)
    assert reporters.json_safe(_snapshot()) == jreporters.json_safe(_snapshot())


@pytest.mark.parametrize("kwargs", [
    dict(report_interval_s=0), dict(report_interval_s=-1.0), dict(http_port=70000),
    dict(http_port=-1), dict(reporters=(object(),)),
])
def test_metric_config_raises_on_the_same_bad_inputs(kwargs):
    with pytest.raises(ValueError):
        reporters.MetricConfig(**kwargs).validate()
    with pytest.raises(ValueError):
        jreporters.MetricConfig(**kwargs).validate()


def test_file_http_console_and_latest_reporters(tmp_path):
    import io

    reg = _fill_registry(registry, 3)
    stream = io.StringIO()
    latest = reporters.LatestSnapshotReporter()
    cfg = reporters.MetricConfig(report_interval_s=0.05, jsonl_path=str(tmp_path / "m.jsonl"),
                                 prometheus_path=str(tmp_path / "m.prom"), http_port=0,
                                 reporters=(latest, reporters.ConsoleReporter(stream)))
    cfg.validate()
    sinks = cfg.build_reporters()
    recorder = jflight.FlightRecorder()
    thread = reporters.ReporterThread(reg, sinks, 0.05, flight=recorder)
    thread.start()
    time.sleep(0.3)
    http = next(s for s in sinks if isinstance(s, reporters.PrometheusHttpReporter))
    body = urllib.request.urlopen(f"http://127.0.0.1:{http.port}/metrics", timeout=5).read()
    thread.stop()
    lines = (tmp_path / "m.jsonl").read_text().splitlines()
    assert len(lines) >= 2
    assert json.loads(lines[-1])["metrics"]["op.0"]["batches"] > 0
    prom = (tmp_path / "m.prom").read_text()
    assert 'flink_tpu_batches{scope="op.0"}' in prom
    assert b"flink_tpu_process_latency_s_p50" in body
    assert latest.reports >= 2 and latest.latest()[1]["op.0"]["batches"] > 0
    assert "[metrics " in stream.getvalue()
    thread.stop()   # idempotent


# -- the runtime's catalogue and the reporter wiring ----------------------------------

CATALOGUE = {"records_in", "records_out", "process_latency_s", "idle_s", "busy_s",
             "backpressure_s", "queue_depth", "queue_high_watermark", "in_backpressure_s",
             "checkpoint_alignment_s"}


def _unchained_job(env, out):
    (env.from_collection(list(range(300)), name="src")
        .map(lambda x: x + 1, name="inc")
        .sink_to_callable(out.append, name="sink"))


def test_runtime_catalogue_names_match_jax(tmp_path):
    out, jout = [], []
    env = StreamExecutionEnvironment().configure(chaining=False)
    _unchained_job(env, out)
    env.execute("t", timeout=60)
    jenv = JaxEnv().configure(chaining=False)
    _unchained_job(jenv, jout)
    jenv.execute("t", timeout=60)
    mine, theirs = env.metric_registry.snapshot(), jenv.metric_registry.snapshot()
    for scope in ("inc.0", "sink.0"):
        assert CATALOGUE <= set(mine[scope])
        assert CATALOGUE <= set(theirs[scope])
        assert mine[scope]["records_in"]["count"] == theirs[scope]["records_in"]["count"] == 300
        assert mine[scope]["process_latency_s"]["count"] == 300
        assert mine[scope]["busy_s"] == pytest.approx(mine[scope]["process_latency_s"]["total_s"])
        assert 1 <= mine[scope]["queue_high_watermark"] <= 1024
    assert {"process_latency_s", "idle_s", "busy_s", "backpressure_s"} <= set(mine["src.0"])
    assert "queue_depth" not in mine["src.0"]
    # The inspector folds both snapshots into the same rows' keys.
    rows = inspector.build_rows(mine, 1.0)
    assert [r["operator"] for r in rows] == ["inc", "sink", "src"]
    assert rows[0].keys() == jinspector.build_rows(theirs, 1.0)[0].keys()


def test_backpressure_is_booked_on_the_writer_and_the_gate():
    out = []
    env = StreamExecutionEnvironment().configure(chaining=False, channel_capacity=4)

    def slow(x):
        time.sleep(0.002)
        return x

    (env.from_collection(list(range(60)), name="src").map(slow, name="slow")
        .sink_to_callable(out.append))
    env.execute("t", timeout=60)
    snap = env.metric_registry.snapshot()
    assert len(out) == 60
    assert snap["src.0"]["backpressure_s"] > 0
    assert snap["slow.0"]["in_backpressure_s"] > 0
    assert snap["slow.0"]["queue_high_watermark"] == 4


def test_reporter_thread_runs_with_the_job_and_flushes_at_a_crash(tmp_path):
    jsonl = tmp_path / "m.jsonl"
    env = StreamExecutionEnvironment().configure(
        metrics=reporters.MetricConfig(report_interval_s=30.0, jsonl_path=str(jsonl), seed=5),
        flight_path=str(tmp_path / "f.json"))

    def boom(x):
        if x == 40:
            raise RuntimeError("synthetic")
        return x

    (env.from_collection(list(range(100))).map(boom, name="boom")
        .sink_to_callable(lambda v: None))
    with pytest.raises(JobFailure):
        env.execute("t", timeout=60)
    # The 30 s interval never elapsed: both lines are the crash-time flush
    # and the final report at wait().
    lines = [json.loads(x) for x in jsonl.read_text().splitlines()]
    assert len(lines) == 2
    assert env.metric_registry.seed == 5
    dump = jflight.load_flight_dump(str(tmp_path / "f.json"))
    assert any(ev[1] == "metrics.delta" for ev in dump["events"]) or dump["reason"] == "crash"


def test_execute_report_interval_uses_the_console_without_sinks(capsys):
    env = StreamExecutionEnvironment()
    (env.from_collection(list(range(10))).map(lambda x: x, name="m")
        .sink_to_callable(lambda v: None))
    env.execute("t", timeout=60, report_interval_s=10.0)
    assert "[metrics " in capsys.readouterr().err


# -- the inspector --------------------------------------------------------------------

def _inspector_snapshot():
    rng = np.random.RandomState(6)
    snap = {"checkpoint": {"completed": 1}, "health": {"op": 1, "sink": 2}}
    for scope in ("op.0", "op.1", "src.0", "sink.0"):
        snap[scope] = {
            "records_in": {"count": int(rng.randint(100)), "window_rate": float(rng.rand() * 50)},
            "records_out": {"count": int(rng.randint(100)), "window_rate": float(rng.rand())},
            "process_latency_s": {"p50": float(rng.rand()), "p99": float(rng.rand()),
                                  "total_s": float(rng.rand() * 3)},
            "backpressure_s": float(rng.rand()), "queue_depth": int(rng.randint(5)),
            "queue_high_watermark": 9, "idle_s": float(rng.rand()),
            "watermark_lag_s": None if scope == "src.0" else float(rng.rand()),
            "roofline.mfu_pct": 0.0 if scope == "op.0" else None,
            "roofline.bound": 3 if scope == "op.0" else None,
        }
    return snap


def test_inspector_rows_and_tables_equal_jax():
    snap = _inspector_snapshot()
    for wall in (0.0, 2.5):
        assert inspector.build_rows(snap, wall) == jinspector.build_rows(snap, wall)
        assert inspector.format_table(inspector.build_rows(snap, wall)) == \
            jinspector.format_table(jinspector.build_rows(snap, wall))
    rows = inspector.build_live_rows(snap)
    assert rows == jinspector.build_live_rows(snap)
    assert inspector.format_live_table(rows) == jinspector.format_live_table(rows)
    assert {r["bound"] for r in rows} == {"host", None}
    assert {r["health"] for r in rows} == {"WARN", "BREACH", None}


PIPELINE = '''
from flink_tensorflow_tpu_torch import StreamExecutionEnvironment


def main(argv):
    env = StreamExecutionEnvironment()
    (env.from_collection(list(range(50))).map(lambda x: x + 1, name="inc")
        .sink_to_callable(lambda v: None))
    env.execute("cli")
'''


def test_inspector_cli_snapshot_only(tmp_path):
    script = tmp_path / "pipe.py"
    script.write_text(PIPELINE)
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    run = subprocess.run([sys.executable, "-m", "flink_tensorflow_tpu_torch.metrics",
                          str(script), "--snapshot-only", "--job-args", "",
                          "--jsonl", str(tmp_path / "m.jsonl"), "--interval", "0.05"],
                         capture_output=True, text=True, timeout=240, env=env, cwd=tmp_path)
    assert run.returncode == 0, run.stderr
    snap = json.loads(run.stdout.strip().splitlines()[-1])
    assert snap["chains"] == [["collection", "inc", "sink"]]
    inc = next(r for r in snap["subtasks"] if r["operator"] == "inc")
    assert inc["records_in"] == 50
    assert (tmp_path / "m.jsonl").read_text().strip()


def test_inspector_cli_reports_a_missing_script(tmp_path):
    assert inspector.main([str(tmp_path / "nope.py"), "--snapshot-only"]) == 2


# -- device memory ----------------------------------------------------------------------

def test_device_memory_stats_on_the_cpu_and_without_a_card(monkeypatch):
    assert profiling.device_memory_stats("cpu") == {}
    monkeypatch.setattr(profiling.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        profiling.device_memory_stats(None)
    with pytest.raises(RuntimeError):
        with profiling.trace(str(pathlib.Path(os.environ.get("TMPDIR", "/tmp")) / "x")):
            pass


def test_cpu_subtasks_publish_an_empty_hbm_gauge():
    env = StreamExecutionEnvironment()
    env.set_device_provider(lambda task, index: "cpu")
    (env.from_collection(list(range(5))).map(lambda x: x, name="m")
        .sink_to_callable(lambda v: None))
    env.execute("t", timeout=60)
    snap = env.metric_registry.snapshot()
    assert "hbm_bytes_in_use" in snap["m.0"] and snap["m.0"]["hbm_bytes_in_use"] is None


def test_annotate_batch_names_a_region():
    with profiling.annotate_batch("op.0", 3):
        x = sum(range(10))
    assert x == 45
    assert threading.current_thread() is threading.main_thread()
