"""Event time in the port held to the JAX package: watermarks, tumbling,
sliding and session windows, late side outputs, allowed lateness, the
watermark merge across channels, checkpoint, restore and a 2 -> 3
rescale of open windows and sessions, and model functions on event-time
windows (twins of ``tests/test_event_time.py`` and the time and session
cases of ``tests/test_windows_extended.py``).

Each job is built through both packages' ``StreamExecutionEnvironment``
on the same inputs.  Outputs are compared exactly, as lists where the
JAX package fixes the order (one subtask) and as multisets where it
does not.  A ``stamped`` process function downstream of a window records
the event time each result carries.

The model twins run LeNet and Inception-v3 at 75 px through keyed time
windows, the JAX package at ``pipeline_depth=1`` (where its stamps are
right) and the port at depth 3.  Logits are held within the bf16
tolerance of ``tests/test_torch_model_window.py`` (3e-2 of the largest
|logit|), labels equal where the JAX job's top-1/top-2 gap exceeds twice
that, and stamps, windows and ids exactly.
"""

import collections
import importlib.util

import numpy as np
import pytest

import flink_tensorflow_tpu as jax_pkg
from flink_tensorflow_tpu.checkpoint import store as jax_store
from flink_tensorflow_tpu.core import functions as jax_fn
from flink_tensorflow_tpu.core.environment import RestartStrategy as JaxRestart
from flink_tensorflow_tpu.core.runtime import JobFailure as JaxJobFailure
from flink_tensorflow_tpu.core.windows import WindowBuffer as JaxWindowBuffer
from flink_tensorflow_tpu.core.windows import restore_buffers as jax_restore_buffers
from flink_tensorflow_tpu.core.windows import snapshot_buffers as jax_snapshot_buffers
from flink_tensorflow_tpu_torch.checkpoint import store as torch_store
from flink_tensorflow_tpu_torch.core import functions as torch_fn
from flink_tensorflow_tpu_torch.core.environment import RestartStrategy
from flink_tensorflow_tpu_torch.core.environment import StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.core.runtime import JobFailure
from flink_tensorflow_tpu_torch.core.windows import WindowBuffer, restore_buffers, snapshot_buffers

PACKAGES = {
    "jax": (jax_pkg.StreamExecutionEnvironment, jax_fn, jax_store, JaxRestart, JaxJobFailure),
    "torch": (StreamExecutionEnvironment, torch_fn, torch_store, RestartStrategy, JobFailure),
}
BF16_TOL = 3e-2


def run_both(build, parallelism=1, timeout=30):
    """``build(env, fn_module)`` returns the sink list (or a tuple of
    them); each package's job runs once.  Returns ``{package: sinks}``."""
    out = {}
    for name, (env_cls, fn_mod, *_rest) in PACKAGES.items():
        env = env_cls(parallelism=parallelism)
        sinks = build(env, fn_mod)
        env.execute(timeout=timeout)
        out[name] = sinks
    return out


def collect(f):
    """Each fired window as ``(key, start, end, elements)``."""
    class Collect(f.WindowFunction):
        def process_window(self, key, window, elements, out):
            out.collect((key, window.start, window.end, list(elements)))

    return Collect()


def stamped(f):
    """``(value, its event time)`` for every record."""
    class Stamped(f.ProcessFunction):
        def process_element(self, value, ctx, out):
            out.collect((value, ctx.timestamp))

    return Stamped()


def hashable(x):
    if isinstance(x, dict):
        return tuple(sorted((k, hashable(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(hashable(v) for v in x)
    return x


def multiset(xs):
    return collections.Counter(hashable(x) for x in xs)


# -- tumbling windows (tests/test_event_time.py) ---------------------------

def test_keyed_tumbling_windows_and_their_stamps():
    events = [("a", 0.5), ("b", 0.7), ("b", 0.2), ("a", 1.2), ("a", 0.9), ("b", 2.1), ("a", 2.6)]
    out = run_both(lambda env, f: env.from_collection(events)
                   .assign_timestamps(lambda e: e[1], out_of_orderness_s=1.0)
                   .key_by(lambda e: e[0]).time_window(1.0).apply(collect(f))
                   .process(stamped(f)).sink_to_list(), parallelism=2)
    assert multiset(out["torch"]) == multiset(out["jax"])
    got = {(v[0], v[1]): sorted(t for _, t in v[3]) for v, _ in out["torch"]}
    assert got == {("a", 0.0): [0.5, 0.9], ("a", 1.0): [1.2], ("a", 2.0): [2.6],
                   ("b", 0.0): [0.2, 0.7], ("b", 2.0): [2.1]}
    assert all(ts == v[2] for v, ts in out["torch"])  # stamped with the window end


def test_late_records_beyond_slack_dropped():
    events = [("a", 0.1), ("a", 5.0), ("a", 0.2)]
    out = run_both(lambda env, f: env.from_collection(events)
                   .assign_timestamps(lambda e: e[1], watermark_every=1)
                   .key_by(lambda e: e[0]).time_window(1.0).apply(collect(f)).sink_to_list())
    assert out["torch"] == out["jax"]
    seen = [t for *_, elems in out["torch"] for _, t in elems]
    assert 0.2 not in seen and 0.1 in seen and 5.0 in seen


def test_global_time_window():
    out = run_both(lambda env, f: env.from_collection([(i, float(i)) for i in range(10)])
                   .assign_timestamps(lambda e: e[1]).time_window_all(4.0)
                   .apply(collect(f)).sink_to_list())
    assert out["torch"] == out["jax"]
    assert [len(w[3]) for w in out["torch"]] == [4, 4, 2]


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_missing_timestamps_fail_loud(package):
    env_cls, f, _, _, failure = PACKAGES[package]
    env = env_cls(parallelism=1)
    env.from_collection([1, 2, 3]).key_by(lambda x: x).time_window(1.0) \
        .apply(collect(f)).sink_to_list()
    with pytest.raises(failure, match="without a timestamp"):
        env.execute(timeout=30)


def test_window_boundaries_in_integer_nanoseconds():
    # 0.3 / 0.1 floors to 2 in floats: 0.3 would land in [0.2, 0.3).
    ts = [0.1, 0.2, 0.3, 0.7, 1.0]
    out = run_both(lambda env, f: env.from_collection(ts).assign_timestamps(lambda t: t)
                   .time_window_all(0.3, slide_s=0.1).apply(collect(f)).sink_to_list())
    assert out["torch"] == out["jax"]
    assert (None, 0.3, 0.6, [0.3]) in out["torch"]


# -- sliding windows (tests/test_windows_extended.py) ----------------------

def test_sliding_time_windows_overlap():
    records = [{"t": float(i), "v": i} for i in range(6)]
    out = run_both(lambda env, f: env.from_collection(records)
                   .assign_timestamps(lambda r: r["t"], watermark_every=1)
                   .time_window_all(2.0, slide_s=1.0).apply(collect(f)).sink_to_list())
    assert out["torch"] == out["jax"]
    assert [[r["v"] for r in w[3]] for w in out["torch"]] == \
        [[0], [0, 1], [1, 2], [2, 3], [3, 4], [4, 5], [5]]


def test_keyed_sliding_time_windows():
    records = [{"k": i % 2, "t": float(i), "v": i} for i in range(6)]
    out = run_both(lambda env, f: env.from_collection(records)
                   .assign_timestamps(lambda r: r["t"], watermark_every=1)
                   .key_by(lambda r: r["k"]).time_window(4.0, slide_s=2.0)
                   .apply(collect(f), parallelism=2).sink_to_list())
    assert multiset(out["torch"]) == multiset(out["jax"])
    by_key = collections.defaultdict(list)
    for key, start, _, elems in sorted(out["torch"], key=lambda w: (w[0], w[1])):
        by_key[key].append(sorted(r["v"] for r in elems))
    assert by_key[0] == [[0], [0, 2], [2, 4], [4]]
    assert by_key[1] == [[1], [1, 3], [3, 5], [5]]


def test_hopping_gap_records_are_dropped_not_late():
    # size 1, slide 2: t = 1.5 lies in no window.
    records = [0.5, 1.5, 2.5, 8.5]
    out = run_both(lambda env, f: _late_job(env, f, records, lambda s: s.time_window_all(
        1.0, slide_s=2.0), {}))
    assert out["torch"] == out["jax"]
    main, late = out["torch"]
    assert [w[3] for w in main] == [[0.5], [2.5], [8.5]] and late == []


# -- sessions --------------------------------------------------------------

def test_sessions_split_on_gap():
    records = ([{"k": "a", "t": 0.0}, {"k": "b", "t": 0.2}]
               + [{"k": "a", "t": t} for t in (0.5, 1.0)]
               + [{"k": "a", "t": t} for t in (10.0, 10.4)])
    out = run_both(lambda env, f: env.from_collection(records)
                   .assign_timestamps(lambda r: r["t"], watermark_every=1)
                   .key_by(lambda r: r["k"]).session_window(2.0).apply(collect(f))
                   .process(stamped(f)).sink_to_list())
    assert out["torch"] == out["jax"]
    got = sorted((v[0], [r["t"] for r in v[3]], ts) for v, ts in out["torch"])
    assert got == [("a", [0.0, 0.5, 1.0], 3.0), ("a", [10.0, 10.4], 12.4), ("b", [0.2], 2.2)]


@pytest.mark.parametrize("records,slack,gap,want", [
    ([0.0, 3.0, 1.5], 5.0, 2.0, [[0.0, 1.5, 3.0]]),     # 1.5 bridges two sessions
    ([0.0, 2.0], 0.0, 2.0, [[0.0, 2.0]]),               # touching sessions merge
    ([10.0, 12.0, 6.0], 0.0, 5.0, [[6.0, 10.0, 12.0]]),  # late alone, merges into open
], ids=["out_of_order_merge", "touching", "late_merges_into_open"])
def test_session_merges(records, slack, gap, want):
    out = run_both(lambda env, f: env.from_collection(records)
                   .assign_timestamps(lambda t: t, out_of_orderness_s=slack, watermark_every=1)
                   .session_window_all(gap).apply(collect(f)).sink_to_list())
    assert out["torch"] == out["jax"]
    assert [w[3] for w in out["torch"]] == want


# -- late side outputs and allowed lateness --------------------------------

def _late_job(env, f, records, window, apply_kw):
    result = (window(env.from_collection(records)
                     .assign_timestamps(lambda t: t, watermark_every=1))
              .apply(collect(f), late_tag="late", **apply_kw))
    return result.sink_to_list(), result.side_output("late").sink_to_list()


@pytest.mark.parametrize("records,window,apply_kw,want_main,want_late", [
    ([1.0, 10.0, 0.5], lambda s: s.time_window_all(2.0), {}, [[1.0], [10.0]], [0.5]),
    ([10.0, 20.0, 0.5], lambda s: s.session_window_all(2.0), {}, [[10.0], [20.0]], [0.5]),
    ([1.0, 10.0, 0.5, 20.0], lambda s: s.time_window_all(2.0), {"allowed_lateness_s": 3.0},
     [[1.0], [10.0], [20.0]], [0.5]),
    ([1.0, 5.0, 1.5, 20.0], lambda s: s.time_window_all(2.0), {"allowed_lateness_s": 10.0},
     [[1.0], [1.0, 1.5], [5.0], [20.0]], []),
    ([1.0, 5.0, 1.5, 20.0], lambda s: s.time_window_all(2.0), {}, [[1.0], [5.0], [20.0]],
     [1.5]),
], ids=["time_window", "session", "past_lateness_horizon", "late_refire", "zero_lateness"])
def test_late_records(records, window, apply_kw, want_main, want_late):
    out = run_both(lambda env, f: _late_job(env, f, records, window, apply_kw))
    assert out["torch"] == out["jax"]
    main, late = out["torch"]
    assert [sorted(w[3]) for w in main] == want_main
    assert late == want_late


def test_fired_flag_survives_snapshot_roundtrip():
    for buffer_cls, snap, restore in ((WindowBuffer, snapshot_buffers, restore_buffers),
                                      (JaxWindowBuffer, jax_snapshot_buffers,
                                       jax_restore_buffers)):
        buf = buffer_cls(window=("w", 0.0), fired=True)
        buf.add("a", 0.5)
        assert restore(snap({("k", 0.0): buf}))[("k", 0.0)].fired is True
        legacy = {("k", 0.0): (("w", 0.0), ["a"], [0.5])}
        assert restore(legacy)[("k", 0.0)].fired is False
    # One layout: a port snapshot restores through the JAX package's reader.
    buf = WindowBuffer(window=("w", 0.0), retained=1, fired=True)
    buf.add("a", 0.5)
    back = jax_restore_buffers(snapshot_buffers({"k": buf}))["k"]
    assert (back.elements, back.timestamps, back.retained, back.fired) == (["a"], [0.5], 1, True)


# -- the watermark merge across channels -----------------------------------

def test_watermark_is_the_minimum_over_live_channels():
    """Two timestamped streams at different paces into one window: a
    window fires only once both channels passed its end, and the faster
    stream's finished channel stops holding the watermark back."""
    fast = [float(i) for i in range(0, 40)]
    slow = [float(i) + 0.5 for i in range(0, 8)]

    def build(env, f):
        a = env.from_collection(fast, name="fast").assign_timestamps(lambda t: t,
                                                                     watermark_every=1)
        b = env.from_collection(slow, name="slow").assign_timestamps(lambda t: t,
                                                                     watermark_every=1)
        return a.union(b).time_window_all(4.0).apply(collect(f)).sink_to_list()

    out = run_both(build)
    assert multiset(out["torch"]) == multiset(out["jax"])
    got = {start: sorted(elems) for _, start, _, elems in out["torch"]}
    assert got[0.0] == [0.0, 0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 3.5]   # nothing of slow was late
    assert sum(len(v) for v in got.values()) == len(fast) + len(slow)


def test_parallel_assigners_into_one_window():
    records = [float(i) * 0.25 for i in range(64)]
    out = run_both(lambda env, f: env.from_collection(records, parallelism=4)
                   .assign_timestamps(lambda t: t, watermark_every=2)
                   .time_window_all(1.0, ).apply(collect(f), parallelism=1)
                   .process(stamped(f)).sink_to_list(), parallelism=4)
    assert multiset(out["torch"]) == multiset(out["jax"])
    assert sorted((v[1], len(v[3]), ts) for v, ts in out["torch"]) == \
        [(float(s), 4, float(s) + 1.0) for s in range(16)]


# -- checkpoint, restore and rescale ---------------------------------------

def crash_once(at, store, directory, checkpoint=1):
    """Raises once at the ``at``-th record, after checkpoint
    ``checkpoint`` is durable in ``directory``; one instance serves every
    subtask and attempt.  Passing the last checkpoint cut before ``at``
    leaves none pending at the crash: the JAX coordinator would complete
    a pending one with the cancelled subtasks' state (``ROADMAP.md``
    queue 3), and a restart would restore it."""
    import time

    class CrashOnce:
        def __init__(self):
            self.seen, self.crashed = 0, False

        def __call__(self, value):
            self.seen += 1
            if not self.crashed and self.seen >= at:
                deadline = time.monotonic() + 20
                while (store.latest_checkpoint_id(directory) or 0) < checkpoint:
                    assert time.monotonic() < deadline, "no checkpoint landed"
                    time.sleep(0.01)
                self.crashed = True
                raise RuntimeError("injected crash")
            return value

    return CrashOnce()


def crash_map(f, crash):
    class Tap(f.MapFunction):
        def clone(self):
            return self

        def map(self, value):
            return crash(value)

    return Tap()


def keyed_sessions(env, f, tap, parallelism=2):
    records = [{"k": i % 3, "t": float(i)} for i in range(60)]
    stream = env.from_collection(records).assign_timestamps(lambda r: r["t"], watermark_every=4)
    if tap is not None:
        stream = stream.map(tap)
    return (stream.key_by(lambda r: r["k"]).session_window(4.0)
            .apply(collect(f), name="sessions", parallelism=parallelism).sink_to_list())


def keyed_windows(env, f, tap, parallelism=2):
    records = [{"k": i % 5, "t": i * 0.1} for i in range(120)]
    stream = env.from_collection(records).assign_timestamps(lambda r: r["t"], watermark_every=3)
    if tap is not None:
        stream = stream.map(tap)
    return (stream.key_by(lambda r: r["k"]).time_window(1.0, slide_s=0.5)
            .apply(collect(f), name="windows", parallelism=parallelism).sink_to_list())


@pytest.mark.parametrize("job", [keyed_sessions, keyed_windows], ids=["sessions", "windows"])
def test_crash_and_restart_keeps_windows_exactly_once(job, tmp_path):
    """Count-based checkpoints every 16 records and one crash after
    checkpoint 2, under ``RestartStrategy(max_restarts=1)``: the set of
    fired windows equals an uninterrupted run's, in both packages."""
    results = {}
    for name, (env_cls, f, store, restart, _) in PACKAGES.items():
        env = env_cls(parallelism=1)
        clean = job(env, f, None)
        env.execute(timeout=30)
        d = str(tmp_path / name)
        env = env_cls(parallelism=1)
        env.enable_checkpointing(d, every_n_records=16)
        out = job(env, f, crash_map(f, crash_once(40, store, d, checkpoint=2)))
        result = env.execute(timeout=60, restart_strategy=restart(max_restarts=1))
        assert result.restarts == 1
        assert set(multiset(out)) == set(multiset(clean)), name
        results[name] = multiset(clean)
    assert results["torch"] == results["jax"]


@pytest.mark.parametrize("job", [keyed_sessions, keyed_windows], ids=["sessions", "windows"])
def test_rescale_open_windows_two_to_three(job, tmp_path):
    """Crash at parallelism 2 after checkpoint 1, restore it at 3: every
    window of the restored run is one of an uninterrupted run's (none
    lost the records buffered at the checkpoint), and both runs together
    fire them all."""
    got = {}
    for name, (env_cls, f, store, _, failure) in PACKAGES.items():
        env = env_cls(parallelism=1)
        clean = job(env, f, None)
        env.execute(timeout=30)
        d = str(tmp_path / name)
        env = env_cls(parallelism=1)
        env.enable_checkpointing(d, every_n_records=16)
        before = job(env, f, crash_map(f, crash_once(40, store, d, checkpoint=2)))
        with pytest.raises(failure):
            env.execute(timeout=60)
        env = env_cls(parallelism=1)
        env.enable_checkpointing(d, every_n_records=16)
        after = job(env, f, None, parallelism=3)
        env.execute(timeout=60, restore_from=d, restore_checkpoint_id=1)
        # A window restored without its buffered records would fire short.
        assert set(multiset(after)) <= set(multiset(clean)), name
        assert set(multiset(before + after)) == set(multiset(clean)), name
        got[name] = set(multiset(after))
    assert got["torch"] == got["jax"]


# -- model functions on event-time windows ---------------------------------

class _Recording:
    """An operator output that records records and watermarks in order."""

    def __init__(self):
        self.events = []

    def emit(self, value, timestamp=None):
        self.events.append(("record", int(value.meta["id"]), timestamp))

    def broadcast_element(self, element):
        self.events.append(("watermark", element.timestamp))


@pytest.mark.parametrize("kind", ["count", "time"])
def test_window_operators_drain_the_model_before_a_watermark(kind):
    """A count or event-time window with a pipelined model function emits
    every in-flight result before it forwards a watermark (the JAX
    package's count ``WindowOperator`` forwards it with batches still in
    flight), and serves the function's timers."""
    from flink_tensorflow_tpu_torch.core import elements as el
    from flink_tensorflow_tpu_torch.core.event_time import EventTimeWindowOperator
    from flink_tensorflow_tpu_torch.core.operators import WindowOperator
    from flink_tensorflow_tpu_torch.core.runtime_context import RuntimeContext
    from flink_tensorflow_tpu_torch.core.state import KeyedStateStore
    from flink_tensorflow_tpu_torch.core.windows import CountTrigger
    from flink_tensorflow_tpu_torch.functions.model_function import ModelWindowFunction
    from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
    from flink_tensorflow_tpu_torch.tensors.value import TensorValue

    mdef = get_model_def("lenet")
    fn = ModelWindowFunction(mdef.to_model(mdef.init_params(0)), pipeline_depth=3)
    if kind == "count":
        op = WindowOperator("w", fn, CountTrigger(2))
    else:
        op = EventTimeWindowOperator("w", fn, 1.0)
    out = _Recording()
    op.setup(RuntimeContext("w", device="cpu"), out, KeyedStateStore())
    op.open()
    try:
        assert op.uses_timers
        rng = np.random.RandomState(0)
        for i in range(6):
            op.process_record(el.StreamRecord(
                TensorValue({"image": rng.rand(28, 28, 1).astype(np.float32)}, {"id": i}),
                i / 8))
        op.process_watermark(el.Watermark(1.0))
        assert out.events[-1] == ("watermark", 1.0)
        assert sorted(e[1] for e in out.events[:-1]) == list(range(6))
        stamp = None if kind == "count" else 1.0
        assert all(e[2] == stamp for e in out.events[:-1])
    finally:
        op.close()



# The reference models are flax modules: where flax is absent (a GPU
# machine without it) the model twins skip, and the rest of the file runs.
needs_flax = pytest.mark.skipif(importlib.util.find_spec("flax") is None,
                                reason="the JAX package's models need flax")


def model_packages():
    import jax

    from flink_tensorflow_tpu.functions import ModelMapFunction as JaxModelMapFunction
    from flink_tensorflow_tpu.functions import ModelWindowFunction as JaxModelWindowFunction
    from flink_tensorflow_tpu.models import get_model_def as jax_model_def
    from flink_tensorflow_tpu.tensors import TensorValue as JaxTensorValue
    from flink_tensorflow_tpu_torch.functions.model_function import (
        ModelMapFunction,
        ModelWindowFunction,
    )
    from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
    from flink_tensorflow_tpu_torch.tensors.value import TensorValue

    return jax, {
        "jax": (jax_pkg.StreamExecutionEnvironment, jax_fn, JaxTensorValue, jax_model_def,
                JaxModelWindowFunction, JaxModelMapFunction),
        "torch": (StreamExecutionEnvironment, torch_fn, TensorValue, get_model_def,
                  ModelWindowFunction, ModelMapFunction),
    }


@pytest.fixture(scope="module")
def models():
    return model_packages()[1]


@pytest.fixture(scope="module")
def lenet_variables():
    jax, packages = model_packages()
    jdef = packages["jax"][3]("lenet")
    return jax.tree.map(np.asarray, jax.jit(jdef.init_fn)(jax.random.key(0)))


@pytest.fixture(scope="module")
def frames():
    """40 MNIST-sized frames from 2 cameras, 0.25 s apart per camera."""
    rng = np.random.RandomState(3)
    return [(rng.rand(28, 28, 1).astype(np.float32), {"id": i, "cam": i % 2, "t": (i // 2) / 4})
            for i in range(40)]


def model_env(models, package):
    env_cls = models[package][0]
    env = env_cls(parallelism=1)
    if package == "torch":
        env.set_device_provider(lambda task, index: "cpu")
    return env


def model_job(models, package, variables, frames, window_fn_kw=None, *, arch="lenet",
              cfg=None, field="image", downstream=False, watermark_every=4):
    """``assign_timestamps -> key_by(cam) -> time_window(1.0) ->
    ModelWindowFunction`` (with ``downstream``: then ``time_window_all(1.0)``
    counting results, late ones to a side output).  Returns ``(stamped
    results, downstream windows, late records)``."""
    _, f, value_cls, model_def, window_fn, _ = models[package]
    env = model_env(models, package)
    model = model_def(arch, **(cfg or {})).to_model(variables)
    records = [value_cls({field: x}, meta) for x, meta in frames]
    results = (env.from_collection(records)
               .assign_timestamps(lambda r: r.meta["t"], watermark_every=watermark_every)
               .key_by(lambda r: r.meta["cam"]).time_window(1.0)
               .apply(window_fn(model, **(window_fn_kw or {})), name="model"))
    out = results.process(stamped(f)).sink_to_list()
    windows = late = None
    if downstream:
        counted = (results.time_window_all(1.0)
                   .apply(collect(f), late_tag="late", name="count"))
        windows = counted.sink_to_list()
        late = counted.side_output("late").sink_to_list()
    env.execute(timeout=120)
    return out, windows, late


def own_window_end(record) -> float:
    return float(np.floor(record.meta["t"])) + 1.0


@needs_flax
def test_reference_misstamps_pipelined_results_and_the_port_does_not(models, lenet_variables,
                                                                      frames):
    """The JAX package at ``pipeline_depth=3`` drains earlier windows'
    results into a later window's end-stamped collector and hands end of
    input an unstamped one: results carry the wrong end, and a downstream
    event-time window fails on a record without a timestamp.  The port
    stamps each result with its own window's end, and the downstream
    window sees every result on time.  With a watermark every 16 records
    one watermark closes windows of two seconds at once, so batches of
    windows with different ends are in flight together."""
    jax_out, _, _ = model_job(models, "jax", lenet_variables, frames, {"pipeline_depth": 3})
    assert any(ts != own_window_end(r) for r, ts in jax_out)
    with pytest.raises(JaxJobFailure, match="without a timestamp"):
        model_job(models, "jax", lenet_variables, frames, {"pipeline_depth": 3}, downstream=True)

    for every in (4, 16):
        out, windows, late = model_job(models, "torch", lenet_variables, frames,
                                       {"pipeline_depth": 3}, downstream=True,
                                       watermark_every=every)
        assert sorted(r.meta["id"] for r, _ in out) == list(range(40))
        assert all(ts == own_window_end(r) for r, ts in out)
        assert late == []
        # Window [s, s + 1)'s results carry s + 1, so they land in [s + 1, s + 2).
        assert [(w[1], len(w[3])) for w in windows] == [(float(s), 8) for s in range(1, 6)]


def assert_model_twin(got, want):
    """Same ids, stamps and windows; logits within BF16_TOL of the largest
    |logit|; labels equal where the JAX job's top-2 gap is clear."""
    g = {r.meta["id"]: (r, ts) for r, ts in got}
    w = {r.meta["id"]: (r, ts) for r, ts in want}
    assert sorted(g) == sorted(w) and len(g) == len(got)
    assert {i: ts for i, (_, ts) in g.items()} == {i: ts for i, (_, ts) in w.items()}
    ids = sorted(w)
    gl = np.stack([np.asarray(g[i][0]["logits"], np.float32) for i in ids])
    wl = np.stack([np.asarray(w[i][0]["logits"], np.float32) for i in ids])
    scale = np.abs(wl).max()
    assert np.abs(gl - wl).max() <= BF16_TOL * scale
    top2 = np.sort(wl, -1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * BF16_TOL * scale
    assert clear.any()
    assert np.array_equal(gl.argmax(-1)[clear], wl.argmax(-1)[clear])


@needs_flax
def test_lenet_on_keyed_time_windows_matches_jax(models, lenet_variables, frames):
    want, _, _ = model_job(models, "jax", lenet_variables, frames, {"pipeline_depth": 1})
    got, _, _ = model_job(models, "torch", lenet_variables, frames, {"pipeline_depth": 3})
    assert_model_twin(got, want)
    assert all(ts == own_window_end(r) for r, ts in got)


@needs_flax
def test_inception_on_keyed_time_windows_matches_jax(models):
    from test_torch_inception import CLASSES, SIZE, flax_variables

    cfg = dict(num_classes=CLASSES, image_size=SIZE, uint8_input=True)
    variables = flax_variables(models["jax"][3]("inception_v3", **cfg), 0)
    rng = np.random.RandomState(7)
    frames = [(rng.randint(0, 256, (SIZE, SIZE, 3)).astype(np.uint8),
               {"id": i, "cam": i % 2, "t": (i // 2) * 0.5}) for i in range(8)]
    kw = dict(arch="inception_v3", cfg=cfg)
    want, _, _ = model_job(models, "jax", variables, frames, {"pipeline_depth": 1}, **kw)
    got, _, _ = model_job(models, "torch", variables, frames, {"pipeline_depth": 3}, **kw)
    assert_model_twin(got, want)


@needs_flax
def test_model_map_feeding_an_event_time_window(models, lenet_variables, frames):
    """``assign_timestamps -> map(ModelMapFunction) -> key_by(cam) ->
    time_window``: each result keeps its record's event time, so every
    window holds its own 4 frames and nothing is late."""
    got = {}
    for package, (_, f, value_cls, model_def, _, map_fn) in models.items():
        env = model_env(models, package)
        model = model_def("lenet").to_model(lenet_variables)
        windows = (env.from_collection([value_cls({"image": x}, m) for x, m in frames])
                   .assign_timestamps(lambda r: r.meta["t"], watermark_every=4)
                   .map(map_fn(model, micro_batch=8, idle_flush_s=1.0))
                   .key_by(lambda r: r.meta["cam"]).time_window(1.0)
                   .apply(collect(f), late_tag="late"))
        out = windows.sink_to_list()
        late = windows.side_output("late").sink_to_list()
        env.execute(timeout=120)
        assert late == []
        got[package] = sorted((k, s, sorted(r.meta["id"] for r in elems))
                              for k, s, _, elems in out)
    assert got["torch"] == got["jax"]
    assert [len(ids) for *_, ids in got["torch"]] == [4] * 10
