"""The port's tracing plane held to the JAX package's
(``flink_tensorflow_tpu/tracing``) on the same inputs.

The pure functions are held exactly: the tracer's admission decisions
for the same ``(sample_rate, seed)``, attribution tables and their text
on the same events, Chrome exports (apart from ``ts``, which is relative
to each tracer's own epoch), flight dumps loaded across packages,
``OffsetEstimator`` estimates and ``merge_cohort_traces`` output.  The
pipelines are held by structure: the same span kinds per trace id and the
same stage counts for the same seeded job (twins of
``tests/test_tracing.py::TestPipelineTracing``), and the same
``decode.prefill`` bucket args as the JAX serving pipeline.  The off path
allocates nothing in ``tracing/`` or ``metrics/roofline.py``.
"""

import json
import os
import pathlib
import subprocess
import sys
import tracemalloc

import numpy as np
import pytest

from flink_tensorflow_tpu import StreamExecutionEnvironment as JaxEnv
from flink_tensorflow_tpu import tracing as jtracing
from flink_tensorflow_tpu.metrics.reporters import MetricConfig as JaxMetricConfig
from flink_tensorflow_tpu.tracing import clocksync as jclocksync
from flink_tensorflow_tpu.tracing import flight as jflight
from flink_tensorflow_tpu.tracing import stitch as jstitch
from flink_tensorflow_tpu_torch import StreamExecutionEnvironment
from flink_tensorflow_tpu_torch import tracing
from flink_tensorflow_tpu_torch.core import elements as el
from flink_tensorflow_tpu_torch.core.runtime import JobFailure
from flink_tensorflow_tpu_torch.metrics.reporters import MetricConfig
from flink_tensorflow_tpu_torch.tracing import clocksync, flight, stitch

REPO = pathlib.Path(__file__).resolve().parents[1]


def _synthetic_events(seed=0, n=60):
    """Event tuples over operator and job tracks, numpy-seeded."""
    rng = np.random.RandomState(seed)
    names = ["queue", "h2d", "compute", "d2h", "serde", "wire", "process", "emit", "align"]
    tracks = ["lenet.0", "lenet.1", "src.0", "sink.0", "checkpoint"]
    events = []
    t = 10.0
    for i in range(n):
        t += float(rng.rand()) * 1e-3
        track = tracks[rng.randint(len(tracks))]
        if rng.rand() < 0.15:
            name = ["h2d.elided", "d2h.elided", "barrier.inject"][rng.randint(3)]
            events.append((track, name, "i", t, 0.0, {"batch": int(rng.randint(8))}))
        else:
            name = names[rng.randint(len(names))]
            events.append((track, name, "X", t, float(rng.rand()) * 2e-3,
                           {"trace": i} if rng.rand() < 0.5 else None))
    return events


# -- tracer unit semantics, twin for twin ---------------------------------------------

@pytest.mark.parametrize("rate,seed", [(1.0, None), (0.5, 7), (0.25, 3), (0.1, 11)])
def test_admission_matches_jax_for_the_same_rate_and_seed(rate, seed):
    mine = tracing.Tracer(sample_rate=rate, seed=seed)
    theirs = jtracing.Tracer(sample_rate=rate, seed=seed)
    for track in ("src.0", "src.1"):
        a = [mine.admit(track, object()) is not None for _ in range(97)]
        b = [theirs.admit(track, object()) is not None for _ in range(97)]
        assert a == b


def test_invalid_sample_rates_raise_in_both():
    for bad in (0.0, -0.5, 1.5):
        with pytest.raises(ValueError):
            tracing.Tracer(sample_rate=bad)
        with pytest.raises(ValueError):
            jtracing.Tracer(sample_rate=bad)


def test_ring_bounds_and_drop_counts_match_jax():
    mine, theirs = tracing.Tracer(ring_capacity=16), jtracing.Tracer(ring_capacity=16)
    for tr in (mine, theirs):
        for i in range(100):
            tr.span("op.0", "x", float(i), float(i) + 1.0)
    assert mine.events() == theirs.events()
    assert mine.dropped() == theirs.dropped() == 84


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_attribution_tables_equal_jax_exactly(seed):
    events = _synthetic_events(seed)
    mine = tracing.attribution(events)
    theirs = jtracing.attribution(events)
    assert mine == theirs
    assert tracing.format_attribution_table(mine) == jtracing.format_attribution_table(theirs)


def _strip_ts(trace):
    return [{k: v for k, v in ev.items() if k != "ts"} for ev in trace["traceEvents"]]


@pytest.mark.parametrize("seed", [0, 3])
def test_chrome_exports_equal_jax_apart_from_ts(seed, tmp_path):
    events = _synthetic_events(seed, n=30)
    mine, theirs = tracing.Tracer(), jtracing.Tracer()
    for tr in (mine, theirs):
        for track, name, ph, t0, dur, args in events:
            if ph == "X":
                tr.span(track, name, t0, t0 + dur, args=args)
            else:
                tr.instant(track, name, ts=t0, args=args)
    a = json.loads(pathlib.Path(mine.export(str(tmp_path / "a.json"))).read_text())
    b = json.loads(pathlib.Path(theirs.export(str(tmp_path / "b.json"))).read_text())
    assert _strip_ts(a) == _strip_ts(b)
    # The same epoch gives the same ts too: the exporter is one function.
    assert tracing.events_to_chrome(events, epoch=5.0) == jtracing.events_to_chrome(events, epoch=5.0)
    # Round trip through the file: the same attribution as the events.
    assert tracing.attribution(tracing.events_from_chrome(a)) == jtracing.attribution(
        jtracing.events_from_chrome(b))


def test_queue_spans_with_clock_offsets_match_jax():
    mine, theirs = tracing.Tracer(), jtracing.Tracer()
    for tr, mod in ((mine, tracing), (theirs, jtracing)):
        tr.set_clock_offset(4242, 0.5, 1e-4)
        tr.queue_span("op.0", mod.TraceContext(1, 4242, 10.0), 11.0)
        tr.queue_span("op.0", mod.TraceContext(2, 4243, 10.0), 11.0)   # unsynced: dropped
        tr.queue_span("op.0", mod.TraceContext(3, 4242, 10.9), 11.0)   # clamped at now
    assert mine.events() == theirs.events()


# -- flight recorder ------------------------------------------------------------------

def _fill_flight(recorder):
    recorder.record("job", "start", {"subtasks": 3}, t0=1.0)
    recorder.record("faults", "kill", {"target": "src.0", "at": 7}, t0=1.5)
    recorder.record("checkpoint", "abort", {"checkpoint": 2, "why": "x"}, t0=2.0)
    recorder.record("job", "failure", {"subtask": "src.0", "error": "boom"}, t0=2.5, dur=0.1)
    recorder.metric_delta({"src.0": {"records_in": {"count": 5}, "records_out": {"count": 4},
                                     "queue_depth": 2}})


def test_each_package_loads_the_others_flight_dump(tmp_path):
    mine, theirs = flight.FlightRecorder(), jflight.FlightRecorder()
    _fill_flight(mine)
    _fill_flight(theirs)
    tr = tracing.Tracer()
    tr.span("op.0", "compute", 1.0, 1.25, args={"batch": 4})
    p_mine = mine.dump(str(tmp_path / "mine.json"), "crash", tracer=tr, extra={"k": 1})
    p_theirs = theirs.dump(str(tmp_path / "theirs.json"), "crash")
    assert mine.dump(str(tmp_path / "mine.json"), "crash") is None   # once per reason
    a = jflight.load_flight_dump(p_mine)      # the port's dump, the JAX loader
    b = flight.load_flight_dump(p_theirs)     # the JAX dump, the port's loader
    assert a["kind"] == b["kind"] == "flink-tpu-flight"
    strip = [ev for ev in a["events"] if ev[1] != "metrics.delta"]
    assert strip == [ev for ev in b["events"] if ev[1] != "metrics.delta"]
    assert [ev[5] for ev in a["events"] if ev[1] == "metrics.delta"] == \
        [ev[5] for ev in b["events"] if ev[1] == "metrics.delta"]
    assert a["tracer_events"] == [("op.0", "compute", "X", 1.0, 0.25, {"batch": 4})]
    assert a["extra"] == {"k": 1}
    # The same dump through both replays: equal Chrome traces.
    assert flight.flight_dump_to_chrome(a) == jflight.flight_dump_to_chrome(a)
    with pytest.raises(ValueError):
        (tmp_path / "bad.json").write_text(json.dumps({"kind": "other"}))
        flight.load_flight_dump(str(tmp_path / "bad.json"))


def test_flight_env_switches_match_jax(monkeypatch):
    for value, want in (("0", False), ("1", True), ("", None)):
        monkeypatch.setenv("FLINK_TPU_FLIGHT", value)
        assert flight.env_enabled() is jflight.env_enabled() is want
    monkeypatch.setenv("FLINK_TPU_FLIGHT_PATH", "/x/y.json")
    assert flight.env_flight_path() == jflight.env_flight_path() == "/x/y.json"
    monkeypatch.setenv("FLINK_TPU_TRACE", "yes")
    monkeypatch.setenv("FLINK_TPU_TRACE_SAMPLE", "0.125")
    assert tracing.env_enabled() and jtracing.env_enabled()
    assert tracing.env_sample_rate() == jtracing.env_sample_rate() == 0.125


def test_shutdown_flusher_refuses_off_the_main_thread():
    import threading

    got = []
    t = threading.Thread(target=lambda: got.append(flight.ShutdownFlusher([]).install()))
    t.start()
    t.join()
    assert got == [False]


# -- clock sync and cohort stitching --------------------------------------------------

def test_offset_estimator_gives_jax_floats():
    rng = np.random.RandomState(5)
    mine = clocksync.OffsetEstimator(max_age_s=5.0)
    theirs = jclocksync.OffsetEstimator(max_age_s=5.0)
    t = 0.0
    for _ in range(60):
        t += float(rng.rand() * 2.0)
        rtt = float(rng.rand() * 1e-3) * (1 if rng.rand() < 0.8 else -1)
        t_server = t + 0.37 + float(rng.rand()) * abs(rtt)
        got = [est.add_sample(t, t_server, t + rtt, now=t) for est in (mine, theirs)]
        assert got[0] == got[1]
        assert (mine.offset_s, mine.error_bound_s, mine.samples, mine.ready) == \
            (theirs.offset_s, theirs.error_bound_s, theirs.samples, theirs.ready)
    assert mine.ready


def _cohort_file(index, offset, seed):
    trace = jtracing.events_to_chrome(_synthetic_events(seed, n=12), epoch=9.0)
    trace["cohort"] = {"process_index": index, "pid": 1000 + index,
                       "offset_to_proc0_s": offset, "error_bound_s": 1e-5 * (index + 1),
                       "epoch_monotonic_s": 9.0 + index}
    return trace


def test_merge_cohort_traces_gives_jax_output(tmp_path):
    traces = [_cohort_file(0, 0.0, 1), _cohort_file(1, -0.25, 2), _cohort_file(2, 0.125, 3)]
    assert stitch.merge_cohort_traces(traces) == jstitch.merge_cohort_traces(traces)
    merged = stitch.merge_cohort_traces(traces)
    assert stitch.cross_process_traces(merged) == jstitch.cross_process_traces(merged)
    paths = []
    for i, t in enumerate(traces):
        p = tmp_path / f"t.proc{i}.json"
        p.write_text(json.dumps(t))
        paths.append(str(p))
    assert stitch.merge_cohort_trace_files(paths) == jstitch.merge_cohort_trace_files(paths)


# -- pipelines, twin for twin ---------------------------------------------------------

def _keyed_job(env, n=40, out=None):
    (env.from_collection(list(range(n)))
        .key_by(lambda x: x % 3)
        .reduce(lambda a, b: a + b, name="sum")
        .sink_to_callable((out if out is not None else []).append))


def _kinds_by_trace(events):
    kinds = {}
    for track, name, ph, _t0, _dur, args in events:
        if ph == "X" and args and "trace" in args:
            kinds.setdefault(args["trace"], set()).add((track, name))
    return {k: sorted(v) for k, v in kinds.items()}


def _stage_counts(events):
    return {op: {stage: row["count"] for stage, row in rows.items()}
            for op, rows in jtracing.attribution(events).items()}


@pytest.mark.parametrize("chaining", [True, False])
def test_traced_keyed_job_matches_jax_span_for_span(chaining, tmp_path):
    """``sample_rate=0.5, seed=7`` in both packages: the same records are
    admitted (the same trace ids), each trace has the same span kinds on
    the same tracks, and the attribution table has the same counts."""
    mine_out, theirs_out = [], []
    env = StreamExecutionEnvironment().configure(
        trace=True, trace_sample_rate=0.5, chaining=chaining,
        metrics=MetricConfig(seed=7), trace_path=str(tmp_path / "mine.json"))
    _keyed_job(env, out=mine_out)
    handle = env.execute_async("t")
    handle.wait(60)
    jenv = JaxEnv().configure(trace=True, trace_sample_rate=0.5, chaining=chaining,
                              metrics=JaxMetricConfig(seed=7))
    _keyed_job(jenv, out=theirs_out)
    jhandle = jenv.execute_async("t")
    jhandle.wait(60)
    assert sorted(mine_out) == sorted(theirs_out) and len(mine_out) == 40
    mine_ev, theirs_ev = handle.executor.tracer.events(), jhandle.executor.tracer.events()
    # The trace ids are (pid << 24) | n: equal across packages in one process.
    assert _kinds_by_trace(mine_ev) == _kinds_by_trace(theirs_ev)
    assert len(_kinds_by_trace(mine_ev)) == 20
    assert _stage_counts(mine_ev) == _stage_counts(theirs_ev)
    assert handle.executor.tracer.dropped() == 0
    # The exported file round-trips to the same counts.
    trace = json.loads((tmp_path / "mine.json").read_text())
    assert _stage_counts(tracing.events_from_chrome(trace)) == _stage_counts(mine_ev)


def test_checkpointed_traced_job_matches_jax(tmp_path):
    """Count-based checkpoints every 5 records, unchained: the same
    ``barrier.inject``, ``align``, ``snapshot`` and ``checkpoint``
    events per checkpoint id as the JAX job."""
    def lifecycle(events):
        out = {}
        for track, name, ph, _t0, _dur, args in events:
            if args and "checkpoint" in args:
                out.setdefault(args["checkpoint"], []).append((track, name, ph))
        return {k: sorted(v) for k, v in out.items()}

    env = StreamExecutionEnvironment().configure(trace=True, chaining=False)
    env.enable_checkpointing(str(tmp_path / "a"), every_n_records=5)
    (env.from_collection(list(range(20))).map(lambda x: x + 1, name="inc")
        .sink_to_callable(lambda v: None))
    handle = env.execute_async("t")
    handle.wait(60)
    jenv = JaxEnv().configure(trace=True, chaining=False)
    jenv.enable_checkpointing(str(tmp_path / "b"), every_n_records=5)
    (jenv.from_collection(list(range(20))).map(lambda x: x + 1, name="inc")
        .sink_to_callable(lambda v: None))
    jhandle = jenv.execute_async("t")
    jhandle.wait(60)
    mine = lifecycle(handle.executor.tracer.events())
    assert mine == lifecycle(jhandle.executor.tracer.events())
    assert sorted(mine) == [1, 2, 3, 4]


def test_split_source_lifecycle_matches_jax():
    from flink_tensorflow_tpu.sources import ReplaySplitSource as JaxReplay
    from flink_tensorflow_tpu_torch.sources import ReplaySplitSource

    def run(env_cls, source_cls):
        env = env_cls().configure(trace=True)
        out = []
        (env.from_source(source_cls(list(range(24)), num_splits=4), name="replay",
                         parallelism=2).sink_to_callable(out.append))
        handle = env.execute_async("t")
        handle.wait(60)
        assert sorted(out) == list(range(24))
        events = handle.executor.tracer.events()
        return (sorted((e[5] or {}).get("split") for e in events if e[1] == "split.read"),
                sorted((e[5] or {}).get("split") for e in events if e[1] == "split.assign"),
                sum(1 for e in events if e[1] == "emit"))

    assert run(StreamExecutionEnvironment, ReplaySplitSource) == run(JaxEnv, JaxReplay)


def test_trace_written_on_failure_with_the_failure_instant(tmp_path):
    env = StreamExecutionEnvironment().configure(
        trace=True, trace_path=str(tmp_path / "trace.json"),
        flight_path=str(tmp_path / "flight.json"))

    def boom(x):
        if x >= 5:
            raise RuntimeError("synthetic failure")
        return x

    (env.from_collection(list(range(20))).map(boom, name="boom")
        .sink_to_callable(lambda v: None))
    with pytest.raises(JobFailure):
        env.execute("t", timeout=60)
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert "failure" in {e["name"] for e in trace["traceEvents"]}
    dump = jflight.load_flight_dump(str(tmp_path / "flight.json"))
    names = {(ev[0], ev[1]) for ev in dump["events"]}
    assert {("job", "start"), ("job", "failure")} <= names
    assert dump["reason"] == "crash" and dump["tracer_events"]


def test_a_restarted_attempt_records_restart_attempt_and_fault_kills(tmp_path):
    from flink_tensorflow_tpu_torch import RestartStrategy

    out = []
    env = StreamExecutionEnvironment().configure(
        flight_path=str(tmp_path / "flight.json"),
        faults="kill:src.0@12;kill:src.0@30#1")
    env.enable_checkpointing(str(tmp_path / "chk"), every_n_records=5)
    (env.from_collection(list(range(40)), name="src").map(lambda x: x, name="m")
        .sink_to_callable(out.append))
    result = env.execute("t", timeout=60, restart_strategy=RestartStrategy(max_restarts=2))
    assert result.restarts == 2
    # Each attempt's recorder dumps at its crash; the last is epoch 1's.
    dump = flight.load_flight_dump(str(tmp_path / "flight.json"))
    names = {(ev[0], ev[1]) for ev in dump["events"]}
    assert {("faults", "kill"), ("job", "failure"), ("job", "restart.attempt")} <= names


# -- serving: the decode spans against the JAX pipeline -------------------------------

def test_traced_serving_prefill_buckets_match_jax():
    import jax

    from flink_tensorflow_tpu import serving as jax_serving
    from flink_tensorflow_tpu.models import get_model_def as jax_model_def
    from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
    from flink_tensorflow_tpu_torch.serving import (
        GenerateRequest,
        ServingConfig,
        continuous_batching,
    )

    cfg = dict(vocab_size=48, embed_dim=32, num_heads=2, num_layers=2, capacity=40)
    serving_cfg = dict(max_active_seqs=3, token_budget=80, capacity=40)
    jdef = jax_model_def("char_transformer", **cfg)
    params = jdef.init_params(jax.random.PRNGKey(0))
    port_model = get_model_def("char_transformer", **cfg).to_model(
        jax.tree.map(np.asarray, params))

    def requests(cls):
        rng = np.random.RandomState(4)
        return [cls(session_id=f"s{i}", prompt=rng.randint(1, 48, (int(rng.randint(4, 10)),)),
                    max_new_tokens=5) for i in range(7)]

    def decode_spans(events):
        prefill = [tuple(a["bucket"]) + (a["batch"],) for _t, n, ph, _0, _d, a in events
                   if n == "decode.prefill"]
        steps = sum(1 for e in events if e[1] == "decode.step")
        return sorted(prefill), steps

    env = StreamExecutionEnvironment().configure(trace=True)
    env.set_device_provider(lambda task, index: "cpu")
    continuous_batching(env.from_collection(requests(GenerateRequest)).key_by(
        lambda r: r.session_id), port_model, config=ServingConfig(**serving_cfg)).sink_to_list()
    handle = env.execute_async("serve")
    handle.wait(300)
    jenv = JaxEnv().configure(trace=True)
    jax_serving.continuous_batching(
        jenv.from_collection(requests(jax_serving.GenerateRequest)).key_by(
            lambda r: r.session_id),
        jdef.to_model(params), config=jax_serving.ServingConfig(**serving_cfg)).sink_to_list()
    jhandle = jenv.execute_async("serve")
    jhandle.wait(300)
    mine = decode_spans(handle.executor.tracer.events())
    assert mine == decode_spans(jhandle.executor.tracer.events())
    assert mine[0] and mine[1] > 0
    # One decode.step span per decode_step_s sample, and the prefill spans'
    # buckets give the runner's prefill H2D bytes exactly (tokens [b, t],
    # lengths and slots [b], int32; each padded step ships [S] tokens and
    # lengths, int32, and an [S] bool mask).
    grp = env.metric_registry.group("continuous_batching.0")
    assert grp.histogram("decode_step_s").count == mine[1]
    prefill_h2d = sum(b * t * 4 + b * 8 for b, t, _ in mine[0])
    h2d = grp.report()["continuous_batching.0.step_h2d_bytes"]
    assert prefill_h2d == h2d - mine[1] * serving_cfg["max_active_seqs"] * 9


# -- the off path ---------------------------------------------------------------------

def _assert_off_path_allocates_nothing(env, n_out, out, wait=60):
    """Run ``env``'s job untraced under tracemalloc: ``tracing/`` and
    ``metrics/roofline.py`` allocate nothing."""
    import flink_tensorflow_tpu_torch.metrics.roofline  # noqa: F401
    import flink_tensorflow_tpu_torch.tracing.attribution  # noqa: F401
    import flink_tensorflow_tpu_torch.tracing.device_clock  # noqa: F401
    import flink_tensorflow_tpu_torch.tracing.tracer  # noqa: F401

    tracemalloc.start()
    try:
        handle = env.execute_async("t")
        handle.wait(wait)
        snap = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    assert len(out) == n_out
    assert handle.executor.tracer is None and handle.executor.flight is None
    assert handle.executor.roofline is None
    pkg = REPO / "flink_tensorflow_tpu_torch"
    stats = snap.filter_traces([
        tracemalloc.Filter(True, str(pkg / "tracing") + "/*"),
        tracemalloc.Filter(True, str(pkg / "metrics" / "roofline.py")),
    ]).statistics("filename")
    assert sum(s.size for s in stats) == 0, stats


def test_off_path_allocates_nothing_in_tracing_or_roofline():
    env = StreamExecutionEnvironment().configure(flight_recorder=False)
    out = []
    (env.from_collection(list(range(200))).map(lambda x: x + 1, name="inc")
        .sink_to_callable(out.append))
    _assert_off_path_allocates_nothing(env, 200, out)


@pytest.mark.parametrize("job", ["runner", "gang"])
def test_off_path_allocates_nothing_in_tracing_or_roofline_for_the_runner_and_the_gang(job):
    """The same for a model window job (the ring, the lanes, the fetch
    thread and the emit) and for a data-parallel gang's train steps:
    untraced, their hooks of the device timing and the step spans are
    one ``is None`` test each."""
    from flink_tensorflow_tpu_torch.functions import DPTrainWindowFunction, ModelWindowFunction
    from flink_tensorflow_tpu_torch.models import lenet_cell
    from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
    from flink_tensorflow_tpu_torch.parallel import optim
    from flink_tensorflow_tpu_torch.parallel.mesh import make_mesh
    from flink_tensorflow_tpu_torch.tensors.batching import BucketPolicy
    from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, spec
    from flink_tensorflow_tpu_torch.tensors.value import TensorValue

    env = StreamExecutionEnvironment(parallelism=1).configure(flight_recorder=False)
    if job == "runner":
        _, model, _, records = lenet_cell.lenet_cell(0, records=64)
        env.set_device_provider(lambda task, index: "cpu")
        out = (env.from_collection(records).count_window(16)
               .apply(ModelWindowFunction(model, policy=BucketPolicy(fixed_batch=16),
                                          outputs=("label",)), name="infer")
               .sink_to_list())
        n_out = 64
    else:
        cfg = dict(num_classes=4, image_size=32, width=8, stage_sizes=(1, 1))
        rng = np.random.RandomState(0)
        recs = [TensorValue({"image": rng.rand(32, 32, 3).astype(np.float32),
                             "label": np.int32(i % 4)}) for i in range(24)]
        env.set_mesh(make_mesh({"data": 1}, devices=["cpu"]))
        schema = RecordSchema({"image": spec((32, 32, 3)), "label": spec((), np.int32)})
        out = (env.from_collection(recs).count_window(8)
               .apply(DPTrainWindowFunction(get_model_def("resnet50", **cfg), optim.adam(1e-2),
                                            train_schema=schema, global_batch=8),
                      name="dp_train")
               .sink_to_list())
        n_out = 3
    _assert_off_path_allocates_nothing(env, n_out, out, wait=300)


def test_untraced_records_carry_no_context_and_frames_stay_jax_bytes():
    """A record with ``trace=None`` (every record of an untraced job)
    leaves the columnar frame byte-equal to the JAX writer's."""
    from flink_tensorflow_tpu.core import elements as jel
    from flink_tensorflow_tpu.core.shuffle import RemoteChannelWriter as JaxWriter
    from flink_tensorflow_tpu.tensors.value import TensorValue as JaxTensorValue
    from flink_tensorflow_tpu_torch.core.shuffle import RemoteChannelWriter
    from flink_tensorflow_tpu_torch.tensors.value import TensorValue

    rng = np.random.RandomState(9)
    raw = [{"x": rng.randn(4).astype(np.float32), "i": np.int64(i)} for i in range(5)]
    recs = [el.StreamRecord(TensorValue(f), 0.5 * i) for i, f in enumerate(raw)]
    assert all(r.trace is None for r in recs)
    mine = RemoteChannelWriter("127.0.0.1", 1, "op", 0, 0)._coalesce(recs)
    theirs = JaxWriter("127.0.0.1", 1, "op", 0, 0)._coalesce(
        [jel.StreamRecord(JaxTensorValue(f), 0.5 * i) for i, f in enumerate(raw)])
    assert mine.payload.tobytes() == theirs.payload.tobytes()
    assert mine.timestamps == theirs.timestamps


# -- the CLI --------------------------------------------------------------------------

PIPELINE = '''
from flink_tensorflow_tpu_torch import StreamExecutionEnvironment


def main(argv):
    env = StreamExecutionEnvironment()
    (env.from_collection(list(range(30))).key_by(lambda x: x % 2)
        .reduce(lambda a, b: a + b, name="inc").sink_to_callable(lambda v: None))
    env.execute("cli")
'''


def _cli(*args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "flink_tensorflow_tpu_torch.tracing", *args],
                          capture_output=True, text=True, timeout=240, cwd=cwd, env=env)


def test_cli_traces_a_port_pipeline_and_replays_files(tmp_path):
    script = tmp_path / "pipe.py"
    script.write_text(PIPELINE)
    out = str(tmp_path / "pipe.trace.json")
    run = _cli(str(script), "--out", out, "--job-args", "", cwd=tmp_path)
    assert run.returncode == 0, run.stderr
    summary = json.loads(run.stdout.strip().splitlines()[-1])
    assert summary["dropped"] == 0 and summary["attribution"]["inc"]["process"]["count"] == 30
    again = _cli("--from-file", out, cwd=tmp_path)
    assert again.returncode == 0, again.stderr
    assert json.loads(again.stdout.strip().splitlines()[-1])["attribution"] == \
        summary["attribution"]
    # A JAX flight dump replays through the port's CLI.
    rec = jflight.FlightRecorder()
    _fill_flight(rec)
    dump = rec.dump(str(tmp_path / "f.json"), "crash")
    replay = _cli("--from-flight-dump", dump, "--out", str(tmp_path / "f.trace.json"),
                  cwd=tmp_path)
    assert replay.returncode == 0, replay.stderr
    assert json.loads(replay.stdout.strip().splitlines()[-1])["reason"] == "crash"
    # --cohort merges files as the JAX stitcher does.
    for i, t in enumerate([_cohort_file(0, 0.0, 1), _cohort_file(1, 0.5, 2)]):
        (tmp_path / f"c.proc{i}.json").write_text(json.dumps(t))
    merged = _cli("--cohort", str(tmp_path / "c"), "--out", str(tmp_path / "m.json"),
                  cwd=tmp_path)
    assert merged.returncode == 0, merged.stderr
    want = jstitch.merge_cohort_trace_files(
        [str(tmp_path / "c.proc0.json"), str(tmp_path / "c.proc1.json")])
    assert json.loads((tmp_path / "m.json").read_text()) == want
