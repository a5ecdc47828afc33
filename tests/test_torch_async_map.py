"""The per-record model map (``stream.map(ModelMapFunction(...))``) and
model bundles through the port on the CPU, held to the JAX package.

Twins of ``tests/test_async_map.py`` (FIFO micro-batching, strict
per-record mode, the partial batch's bucket, the idle flush, the flush
before a snapshot), ``tests/test_model_functions.py::test_bundle_path_source``
and ``::test_per_record_inference``, and
``tests/test_round5_review_regressions.py::TestBackgroundFetch::test_completion_wake_does_not_flush_partial_microbatch``.
The model is LeNet with the JAX package's initial weights carried over by
``models/convert.py:lenet_from_flax``.  Each record's logits must be
within ``test_torch_lenet``'s bf16 tolerance of the JAX serve's on the
same image, and its label equal wherever the JAX top-1/top-2 gap exceeds
twice that (9 of the 10 images).

``test_completion_wakes_do_not_push_out_the_idle_deadline`` is the
port's repair of the reference: a fire that only drains a completed
batch must leave the idle (or poll) deadline where it was.
"""

import threading
import time

import numpy as np
import pytest
import torch

pytest.importorskip("flax")

import jax
import jax.numpy as jnp

from flink_tensorflow_tpu.models import get_model_def as jax_model_def
from flink_tensorflow_tpu.models import save_bundle as jax_save_bundle
from flink_tensorflow_tpu_torch.core import functions as fn
from flink_tensorflow_tpu_torch.core.elements import StreamRecord
from flink_tensorflow_tpu_torch.core.environment import StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.core.operators import MapOperator
from flink_tensorflow_tpu_torch.core.runtime import KeyedSubtask
from flink_tensorflow_tpu_torch.functions.model_function import (
    ModelMapFunction,
    ModelWindowFunction,
)
from flink_tensorflow_tpu_torch.models.base import Model, ModelMethod
from flink_tensorflow_tpu_torch.models.loaders import SavedModelLoader, save_bundle
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, spec
from flink_tensorflow_tpu_torch.tensors.value import TensorValue
from test_torch_lenet import BF16_TOL


class CpuCtx:
    """The runtime context a function gets outside a job, on the CPU."""

    subtask_index = 0
    parallelism = 1
    metrics = None
    device = "cpu"


@pytest.fixture(scope="module")
def variables():
    mdef = jax_model_def("lenet")
    return jax.tree.map(np.asarray, jax.jit(mdef.init_fn)(jax.random.key(0)))


@pytest.fixture(scope="module")
def model(variables):
    return get_model_def("lenet").to_model(variables)


@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(7)
    return [TensorValue({"image": rng.rand(28, 28, 1).astype(np.float32)}, {"i": i})
            for i in range(10)]


@pytest.fixture(scope="module")
def expected(variables, images):
    """The JAX serve's logits per image, and where its label is clear."""
    mdef = jax_model_def("lenet")
    batch = jnp.stack([jnp.asarray(r["image"]) for r in images])
    logits = np.asarray(jax.jit(mdef.methods["serve"].fn)(variables, {"image": batch})["logits"])
    top2 = np.sort(logits, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * BF16_TOL * np.abs(logits).max()
    assert clear.sum() >= 9
    return logits, clear


def assert_matches(results, expected):
    """Each result against the JAX serve on its own image (by ``i``)."""
    logits, clear = expected
    ids = [r.meta["i"] for r in results]
    got = np.stack([r["logits"] for r in results])
    assert np.abs(got - logits[ids]).max() <= BF16_TOL * np.abs(logits).max()
    labels = np.array([int(r["label"]) for r in results])
    np.testing.assert_array_equal(labels[clear[ids]], np.argmax(logits[ids], -1)[clear[ids]])


def run_map(model_source, images, **kw):
    env = StreamExecutionEnvironment(parallelism=1)
    env.set_device_provider(lambda task, index: "cpu")
    results = (env.from_collection(images, parallelism=1)
               .map(ModelMapFunction(model_source, **kw), name="map")
               .sink_to_list())
    job = env.execute(timeout=120)
    return results, job


def test_map_is_async_function(model):
    assert isinstance(ModelMapFunction(model), fn.AsyncMapFunction)


@pytest.mark.parametrize("kw", [{"micro_batch": 4}, {"micro_batch": 1, "pipeline_depth": 4}],
                         ids=["micro_batch_4", "strict_per_record"])
def test_micro_batched_map_correct_and_ordered(model, images, expected, kw):
    """micro_batch 4: two full batches and an end-of-input flush of 2;
    micro_batch 1: batch-of-1 dispatches, still pipelined.  The JAX
    answers, arrival order kept."""
    # No idle flush within the run (the source never pauses for 5 s), so
    # the batch count does not depend on the machine's load.
    results, job = run_map(model, images, idle_flush_s=5.0, **kw)
    assert [r.meta["i"] for r in results] == list(range(10))
    assert_matches(results, expected)
    assert job.metrics["map.0.batches"] == (3 if kw["micro_batch"] == 4 else 10)


def test_per_record_inference(model, images, expected):
    results, _ = run_map(model, images[:3])
    assert [r.meta["i"] for r in results] == [0, 1, 2]
    assert_matches(results, expected)


def test_partial_batch_uses_smaller_bucket(model, images):
    """The default ladder (1, 2, 4, ..., micro_batch) pads a flush of 3
    to 4, not to micro_batch: the wire carries the flush's size."""
    f = ModelMapFunction(model, micro_batch=8)
    assert f._policy.batch.sizes == [1, 2, 4, 8]
    assert f._policy.batch_bucket(3) == 4
    assert ModelMapFunction(model, micro_batch=6)._policy.batch.sizes == [1, 2, 4, 6]
    _, job = run_map(model, images[:3], micro_batch=8, idle_flush_s=5.0)
    assert job.metrics["map.0.batches"] == 1
    assert job.metrics["map.0.padded_records"] == 1
    assert job.metrics["map.0.h2d_bytes"] == 4 * 28 * 28 * 4


def test_idle_flush_bounds_latency(model, images):
    """A lull mid-stream must flush the partial batch after idle_flush_s:
    the first 3 results surface before the source sends the rest."""
    got3 = threading.Event()
    arrivals = {}

    def sink(r):
        arrivals[r.meta["i"]] = time.monotonic()
        if len(arrivals) >= 3:
            got3.set()

    class GappedSource(fn.SourceFunction):
        """Holds the stream open after 3 records until their results
        surface: with micro_batch 8 and no end of input, only the idle
        flush can emit them."""

        def __init__(self, records):
            self.records = records
            self.flushed_during_lull = None

        def clone(self):
            return self

        def run(self):
            yield from self.records[:3]
            self.flushed_during_lull = got3.wait(timeout=60.0)
            yield from self.records[3:]

    src = GappedSource(images)
    env = StreamExecutionEnvironment(parallelism=1)
    env.set_device_provider(lambda task, index: "cpu")
    (env.from_source(src, name="gapped", parallelism=1)
     .map(ModelMapFunction(model, micro_batch=8, idle_flush_s=0.05))
     .sink_to_callable(sink))
    env.execute(timeout=180)
    assert sorted(arrivals) == list(range(10))
    assert src.flushed_during_lull, "records 0-2 never flushed while the stream idled"


def test_snapshot_flushes_in_flight(model, images, monkeypatch):
    """Before the barrier's snapshot the operator emits the buffered
    partial and the in-flight micro-batches; the function's own snapshot
    then holds nothing (the operator owns the flush)."""
    seen = []
    original = ModelMapFunction.snapshot_state

    def snapshot_state(self):
        seen.append(len([e for e in sub._sink.elements if hasattr(e, "timestamp")]))
        return original(self)

    monkeypatch.setattr(ModelMapFunction, "snapshot_state", snapshot_state)
    op = MapOperator("map", ModelMapFunction(model, micro_batch=2, idle_flush_s=5.0))
    sub = KeyedSubtask(op)
    sub.ctx.device = "cpu"
    sub.open()
    try:
        for k, r in enumerate(images[:5]):
            op.process_record(StreamRecord(r, float(k)))
        assert op.function.runner.in_flight or op.function._buf
        snap = sub.snapshot(1)
        assert seen == [5]                      # all 5 out before the function's snapshot
        assert snap["function"] is None
        assert not op.function._buf and not op.function.runner.in_flight
    finally:
        sub.close()


def test_operator_flushes_before_a_barrier_and_keeps_timestamps(model, images):
    """MapOperator's async branch: the snapshot hook flushes first, and
    each result leaves with its own record's timestamp."""
    op = MapOperator("map", ModelMapFunction(model, micro_batch=8))
    assert op.uses_timers
    sub = KeyedSubtask(op)
    sub.ctx.device = "cpu"
    sub.open()
    try:
        for k, r in enumerate(images[:5]):
            op.process_record(StreamRecord(r, 100.0 + k))
        snap = sub.snapshot(1)
        assert snap["function"] is None and snap["operator"] is None
        records = [e for e in sub._sink.elements if hasattr(e, "timestamp")]
        assert [e.value.meta["i"] for e in records] == [0, 1, 2, 3, 4]
        assert [e.timestamp for e in records] == [100.0, 101.0, 102.0, 103.0, 104.0]
    finally:
        sub.close()


def test_bundle_path_source(model, variables, images, expected, tmp_path):
    """A bundle path as the model source, loaded by each subtask at
    open(): the window function and the map give the JAX labels."""
    mdef = get_model_def("lenet")
    path = str(tmp_path / "bundle")
    save_bundle(mdef, model.params, path)
    assert not (tmp_path / "bundle.exporting").exists()
    loaded = SavedModelLoader(path).load()
    for k, v in model.params.state_dict().items():
        assert torch.equal(loaded.params.state_dict()[k], v)

    env = StreamExecutionEnvironment(parallelism=1)
    env.set_device_provider(lambda task, index: "cpu")
    results = (env.from_collection(images[:4]).count_window(4)
               .apply(ModelWindowFunction(path)).sink_to_list())
    env.execute(timeout=120)
    assert [r.meta["i"] for r in results] == [0, 1, 2, 3]
    assert_matches(results, expected)

    for source in (path, SavedModelLoader(path), lambda: SavedModelLoader(path).load()):
        env = StreamExecutionEnvironment(parallelism=2)
        env.set_device_provider(lambda task, index: "cpu")
        results = (env.from_collection(images, parallelism=1).rebalance()
                   .map(ModelMapFunction(source, micro_batch=2), parallelism=2)
                   .sink_to_list())
        env.execute(timeout=120)
        assert sorted(r.meta["i"] for r in results) == list(range(10))
        assert_matches(results, expected)


def test_jax_bundle_is_refused_with_the_bridge_named(variables, tmp_path):
    path = str(tmp_path / "jax_bundle")
    jax_save_bundle(jax_model_def("lenet"), variables, path)
    with pytest.raises(ValueError, match="convert"):
        SavedModelLoader(path).load()


def _gated_model(events):
    """A model whose batch waits for ``events[v]``, v the batch's first
    value, before it computes: batches can be held in flight."""
    schema = RecordSchema({"x": spec((1,), np.float32)})

    def serve(module, inputs):
        x = inputs["x"]
        gate = events.get(int(x[0, 0]))
        if gate is not None:
            assert gate.wait(timeout=30)
        return {"y": x * 2}

    return Model("gated", torch.nn.Identity(), {"serve": ModelMethod(
        "serve", schema, ("y",), serve)})


def _rec(v, i):
    return TensorValue({"x": np.array([v], np.float32)}, {"i": i})


def test_completion_wake_does_not_flush_partial_microbatch(model, images):
    """A completion-driven fire (deadline 0.0) drains results but does not
    dispatch the partial micro-batch; only the idle deadline proper does."""
    f = ModelMapFunction(model, micro_batch=8, idle_flush_s=0.5)
    emitted = []
    out = fn.Collector(lambda v, ts=None: emitted.append(v))
    f.open(CpuCtx())
    try:
        for r in images[:8]:     # fills the micro-batch: dispatches
            f.map_async(r, out)
        for r in images[8:]:     # partial: stays buffered
            f.map_async(r, out)
        assert len(f._buf) == 2
        deadline = time.monotonic() + 10.0
        while not f.runner.has_completed() and time.monotonic() < deadline:
            time.sleep(0.002)
        f.fire_due(time.monotonic())            # completion wake
        assert len(emitted) == 8 and len(f._buf) == 2
        f.fire_due(time.monotonic() + f._idle_flush_s + 0.01)   # idle deadline passed
        assert not f._buf
        f.flush(out)
        assert [r.meta["i"] for r in emitted] == list(range(10))
    finally:
        f.close()


@pytest.mark.parametrize("kind", ["map", "window"])
def test_completion_wakes_do_not_push_out_the_idle_deadline(kind):
    """A lull with a batch in flight: batch A completes and its completion
    wake drains it, while batch B is still in flight (and, for the map, a
    partial micro-batch is buffered).  The wake must leave the deadline
    where it was: idle_flush_s after the last record (map) or the last
    dispatch (window).  A wake that restarts the timer, as the reference
    does, would push the partial's dispatch out by idle_flush_s per
    completed batch."""
    idle = 0.5
    events = {1: threading.Event(), 2: threading.Event()}
    model = _gated_model(events)
    emitted = []
    out = fn.Collector(lambda v, ts=None: emitted.append(v))
    f = (ModelMapFunction(model, micro_batch=2, pipeline_depth=3, idle_flush_s=idle)
         if kind == "map" else ModelWindowFunction(model, pipeline_depth=3, idle_flush_s=idle))
    f.open(CpuCtx())
    try:
        a, b = [_rec(1, 0), _rec(1, 1)], [_rec(2, 2), _rec(2, 3)]
        if kind == "map":
            for r in (*a, *b, _rec(0, 4)):
                f.map_async(r, out)
            assert len(f._buf) == 1
            base = f._last_activity
        else:
            f.process_window(None, None, a, out)
            f.process_window(None, None, b, out)
            base = f._last_dispatch
        assert f.next_deadline() == pytest.approx(base + idle)
        events[1].set()                               # A completes; B stays in flight
        deadline = time.monotonic() + 10.0
        while not f.runner.has_completed() and time.monotonic() < deadline:
            time.sleep(0.002)
        assert f.next_deadline() == 0.0
        f.fire_due(base + 0.6 * idle)                 # the completion wake
        assert [r.meta["i"] for r in emitted] == [0, 1]
        assert f.runner.in_flight == 1
        assert f.next_deadline() == pytest.approx(base + idle)
        if kind == "map":
            assert len(f._buf) == 1                   # the wake dispatched nothing
            f.fire_due(base + idle)                   # the idle deadline proper
            assert not f._buf
        events[2].set()
        if kind == "map":
            f.flush(out)
        else:
            f.on_finish(out)
        assert [r.meta["i"] for r in emitted] == list(range(5 if kind == "map" else 4))
    finally:
        for e in events.values():
            e.set()
        f.close()
