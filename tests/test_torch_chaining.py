"""Operator chaining in the port, on the CPU, held to the JAX package.

Twins of ``tests/test_chaining.py``: the chain plans of the port's
``analysis/chaining.py`` equal the JAX package's on the same graphs (the
same chain grouping, the same cut reasons, the same ``->`` / ``=>``
print), and chained execution keeps the layout's contract: one thread per
chain and no queue on a fused edge, outputs equal to the unchained
layout's, per-logical-operator metrics, barriers that snapshot every
member head to tail, exactly-once restore in either layout, failover, and
the idle flush of a model fused behind a worker head.
"""

import threading
import time
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import flink_tensorflow_tpu as jax_pkg
from flink_tensorflow_tpu.analysis.chaining import compute_chains as jax_compute_chains
from flink_tensorflow_tpu.core import functions as jax_fn
from flink_tensorflow_tpu.functions import DeviceMapFunction as JaxDeviceMap
from flink_tensorflow_tpu.functions import ModelMapFunction as JaxModelMap
from flink_tensorflow_tpu.functions import ModelWindowFunction as JaxModelWindow
from flink_tensorflow_tpu.models.base import Model as JaxModel
from flink_tensorflow_tpu.models.base import ModelMethod as JaxMethod
from flink_tensorflow_tpu.tensors import RecordSchema as JaxSchema
from flink_tensorflow_tpu.tensors import spec as jax_spec
from flink_tensorflow_tpu_torch import RestartStrategy, StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.analysis.chaining import (
    TIMER_CUT_REASON,
    compute_chains,
    sharding_axes_of,
    sharding_fusion_conflict,
)
from flink_tensorflow_tpu_torch.core import functions as fn
from flink_tensorflow_tpu_torch.functions.model_function import (
    DeviceMapFunction,
    ModelMapFunction,
    ModelWindowFunction,
)
from flink_tensorflow_tpu_torch.functions.training_function import DPTrainWindowFunction
from flink_tensorflow_tpu_torch.models.base import Model, ModelMethod
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, spec
from flink_tensorflow_tpu_torch.tensors.value import TensorValue


def _functions(f):
    """Plain user functions of one package's ``core.functions``."""

    class GangMap(f.MapFunction):
        is_gang = True

        def map(self, value):
            return value

    class ShardedMap(f.MapFunction):
        def __init__(self, axes):
            self.sharding_axes = axes

        def map(self, value):
            return value

    class KeyedNoop(f.ProcessFunction):
        def process_element(self, value, ctx, out):
            out.collect(value)

    class SumWindow(f.WindowFunction):
        def process_window(self, key, window, elements, out):
            out.collect(sum(elements))

    return types.SimpleNamespace(GangMap=GangMap, ShardedMap=ShardedMap,
                                 KeyedNoop=KeyedNoop, SumWindow=SumWindow)


def _jax_model():
    schema = JaxSchema({"x": jax_spec((4,))})
    return JaxModel("m", {"w": jnp.eye(4)}, {"serve": JaxMethod(
        "serve", schema, ("x",), lambda p, i: {"x": i["x"] @ p["w"]})})


def _port_model():
    schema = RecordSchema({"x": spec((4,), np.float32)})
    return Model("m", torch.nn.Identity(), {"serve": ModelMethod(
        "serve", schema, ("x",), lambda m, i: {"x": i["x"]})})


PORT = types.SimpleNamespace(
    Env=StreamExecutionEnvironment, fns=_functions(fn), chains=compute_chains,
    model=_port_model, ModelMap=ModelMapFunction, ModelWindow=ModelWindowFunction,
    DeviceMap=DeviceMapFunction)
JAX = types.SimpleNamespace(
    Env=jax_pkg.StreamExecutionEnvironment, fns=_functions(jax_fn), chains=jax_compute_chains,
    model=_jax_model, ModelMap=JaxModelMap, ModelWindow=JaxModelWindow,
    DeviceMap=JaxDeviceMap)


def _linear(p, env):
    env.from_collection(range(8), parallelism=2) \
        .map(lambda x: x, name="a", parallelism=2) \
        .filter(lambda x: True, name="b", parallelism=2) \
        .sink_to_list(name="c", parallelism=2)


def _keyed_and_rebalance(p, env):
    s = env.from_collection(range(8), parallelism=2)
    s.key_by(lambda x: x).process(p.fns.KeyedNoop(), name="keyed", parallelism=2) \
        .rebalance().map(lambda x: x, name="rebal", parallelism=2) \
        .map(lambda x: x, name="after", parallelism=2)


def _parallelism_and_fanout(p, env):
    m = env.from_collection(range(8), parallelism=1).map(lambda x: x, name="wide", parallelism=2)
    m.map(lambda x: x, name="t1", parallelism=2)
    m.map(lambda x: x, name="t2", parallelism=2)


def _escape_hatches(p, env):
    env.from_collection(range(8), parallelism=1) \
        .map(lambda x: x, name="a", parallelism=1) \
        .map(lambda x: x, name="b", parallelism=1).start_new_chain() \
        .map(lambda x: x, name="c", parallelism=1).disable_chaining() \
        .map(lambda x: x, name="d", parallelism=1)


def _gang(p, env):
    env.from_collection(range(8), parallelism=1) \
        .map(lambda x: x, name="pre", parallelism=1) \
        .map(p.fns.GangMap(), name="gang", parallelism=1) \
        .map(lambda x: x, name="post", parallelism=1)


def _sharding(p, env):
    env.from_collection(range(8), parallelism=1) \
        .map(p.fns.ShardedMap(("data",)), name="d1", parallelism=1) \
        .map(p.fns.ShardedMap(("model",)), name="m1", parallelism=1) \
        .map(p.fns.ShardedMap(("model",)), name="m2", parallelism=1)


def _timed_window(p, env):
    env.from_collection(range(32), parallelism=1) \
        .map(lambda x: x, name="pre", parallelism=1) \
        .count_window(4, timeout_s=1.0) \
        .apply(p.fns.SumWindow(), name="timed", parallelism=1) \
        .map(lambda x: x, name="post", parallelism=1)


def _counted_window(p, env):
    env.from_collection(range(32), parallelism=1) \
        .count_window(4).apply(p.fns.SumWindow(), name="counted", parallelism=1) \
        .sink_to_list()


def _keyed_process_behind_worker(p, env):
    env.from_collection(range(8), parallelism=1).rebalance() \
        .map(lambda x: x, name="head", parallelism=2) \
        .map(lambda x: x, name="mid", parallelism=2) \
        .sink_to_list(parallelism=2)


def _model_chain(p, env):
    """The device-resident shapes: model => device map => model -> sink,
    and a model window (which never takes device batches) behind them."""
    env.from_collection(range(8), parallelism=1) \
        .map(p.ModelMap(p.model(), micro_batch=4), name="m1") \
        .map(p.DeviceMap(lambda a: a), name="scale") \
        .map(p.ModelMap(p.model(), micro_batch=4), name="m2") \
        .count_window(4).apply(p.ModelWindow(p.model()), name="win") \
        .sink_to_list()


def _model_after_source(p, env):
    """An async model map is timer-driven: cut from the source, and the
    sink fuses behind it (the inception-map chain)."""
    env.from_collection(range(8), parallelism=1) \
        .map(p.ModelMap(p.model(), micro_batch=4, idle_flush_s=1.0), name="imap") \
        .sink_to_list()


GRAPHS = {
    "linear": _linear, "keyed_and_rebalance": _keyed_and_rebalance,
    "parallelism_and_fanout": _parallelism_and_fanout, "escape_hatches": _escape_hatches,
    "gang": _gang, "sharding": _sharding, "timed_window": _timed_window,
    "counted_window": _counted_window, "worker_head": _keyed_process_behind_worker,
    "model_chain": _model_chain, "model_after_source": _model_after_source,
}


def _plan(p, build, **kw):
    env = p.Env(parallelism=1)
    build(p, env)
    plan = p.chains(env.graph, **kw)
    by_id = {t.id: t.name for t in env.graph.transformations}
    reasons = {(by_id[u], by_id[d]): r for (u, d), r in plan.unchained_reasons.items()}
    device = sorted((by_id[u], by_id[d]) for u, d in plan.device_resident_edges)
    return plan, reasons, device


@pytest.mark.parametrize("enabled", [True, False], ids=["chaining", "chaining_off"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_chain_plan_equals_jax(graph, enabled):
    """Same graph in both packages: same chains, same cut reasons, same
    device-resident edges, same printed plan."""
    port, port_reasons, port_device = _plan(PORT, GRAPHS[graph], enabled=enabled)
    ref, ref_reasons, ref_device = _plan(JAX, GRAPHS[graph], enabled=enabled)
    assert port.names() == ref.names()
    assert port_reasons == ref_reasons
    assert port_device == ref_device
    assert port.chained_edge_count == ref.chained_edge_count
    assert port.describe() == ref.format_topology()


def test_linear_forward_pipeline_fuses_completely():
    plan, _, _ = _plan(PORT, _linear)
    assert plan.names() == [["collection", "a", "b", "c"]]


def test_keyed_and_rebalance_edges_never_fuse():
    plan, reasons, _ = _plan(PORT, _keyed_and_rebalance)
    assert plan.names() == [["collection"], ["keyed"], ["rebal", "after"]]
    assert reasons == {}   # re-routing edges are not forward candidates


def test_parallelism_change_and_fanout_break_chains():
    plan, reasons, _ = _plan(PORT, _parallelism_and_fanout)
    assert plan.names() == [["collection"], ["wide"], ["t1"], ["t2"]]
    # 1 -> 2 makes the first edge a rebalance: not a forward candidate.
    assert reasons == {("wide", "t1"): "upstream fans out to several edges",
                       ("wide", "t2"): "upstream fans out to several edges"}


def test_escape_hatches_respected():
    plan, reasons, _ = _plan(PORT, _escape_hatches)
    assert plan.names() == [["collection", "a"], ["b"], ["c"], ["d"]]
    assert reasons[("a", "b")] == "b starts a new chain"
    assert reasons[("b", "c")] == "c has chaining disabled"
    assert reasons[("c", "d")] == "c has chaining disabled"


def test_gang_operators_never_fuse():
    plan, reasons, _ = _plan(PORT, _gang)
    assert plan.names() == [["collection", "pre"], ["gang"], ["post"]]
    assert "gang operator" in reasons[("pre", "gang")]
    assert sharding_axes_of(PORT.fns.GangMap()) == ("data",)
    assert sharding_axes_of(None) is None
    op = types.SimpleNamespace
    assert sharding_fusion_conflict(op(function=PORT.fns.GangMap()), op(function=None))
    assert sharding_fusion_conflict(op(function=None), op(function=None)) is None


def test_dp_train_window_is_a_gang_and_is_cut():
    """The port's DPTrainWindowFunction carries the gang marker the JAX
    chaining pass reads: a count window into it never fuses, nor does the
    sink behind it, as in the JAX package."""
    mdef = get_model_def("resnet50", num_classes=4, image_size=32, width=8, stage_sizes=(1, 1))
    schema = RecordSchema({"image": spec((32, 32, 3)), "label": spec((), np.int32)})
    f = DPTrainWindowFunction(mdef, train_schema=schema, global_batch=8)
    assert f.is_gang and f.clone().is_gang
    env = StreamExecutionEnvironment(parallelism=1)
    env.from_collection(range(8)).map(lambda x: x, name="pre") \
        .count_window(8).apply(f, name="dp_train").sink_to_list()
    plan = compute_chains(env.graph)
    assert plan.names() == [["collection", "pre"], ["dp_train"], ["collect"]]
    by_id = {t.id: t.name for t in env.graph.transformations}
    reasons = {(by_id[u], by_id[d]): r for (u, d), r in plan.unchained_reasons.items()}
    assert reasons[("pre", "dp_train")] == "gang operator owns the device mesh and never chains"
    assert reasons[("dp_train", "collect")] == reasons[("pre", "dp_train")]


def test_timer_operator_never_chains_into_source_loop():
    plan, reasons, _ = _plan(PORT, _timed_window)
    assert plan.names() == [["collection", "pre"], ["timed", "post"]]
    assert reasons[("pre", "timed")] == TIMER_CUT_REASON
    assert _plan(PORT, _counted_window)[0].names() == [["collection", "counted", "collect"]]
    plan, reasons, _ = _plan(PORT, _model_after_source)
    assert plan.names() == [["collection"], ["imap", "collect"]]
    assert reasons[("collection", "imap")] == TIMER_CUT_REASON


def test_device_resident_edges_and_print():
    plan, _, device = _plan(PORT, _model_chain)
    assert device == [("m1", "scale"), ("scale", "m2")]
    assert plan.describe().splitlines() == [
        "chain [x1]: collection",
        "chain [x1, 4 fused edge(s)]: m1 => scale => m2 -> win -> collect"]


def test_disabled_chaining_mode_degenerates():
    plan, reasons, _ = _plan(PORT, _linear, enabled=False)
    assert plan.names() == [["collection"], ["a"], ["b"], ["c"]]
    assert plan.chained_edge_count == 0 and reasons == {}


def test_job_config_defaults_and_validation():
    from flink_tensorflow_tpu.core.config import JobConfig as JaxJobConfig
    from flink_tensorflow_tpu_torch.core.config import JobConfig

    assert JobConfig().chaining is JaxJobConfig().chaining is True
    assert JobConfig().device_resident is JaxJobConfig().device_resident is False
    with pytest.raises(ValueError, match="chaining"):
        JobConfig(chaining=1).validate()
    with pytest.raises(ValueError, match="device_resident"):
        JobConfig(device_resident="yes").validate()


# -- chained execution -------------------------------------------------------

class CountingMap(fn.MapFunction):
    """Counts the records through it; the count is its state.  ``box``
    (shared by the clones) shows the last count and the snapshot order."""

    def __init__(self, box=None, name=""):
        self.count = 0
        self.name = name
        self.box = box if box is not None else {"count": 0, "order": []}

    def clone(self):
        return CountingMap(self.box, self.name)

    def map(self, value):
        self.count += 1
        self.box["count"] = self.count
        return value

    def snapshot_state(self):
        self.box["order"].append(self.name)
        return {"count": self.count}

    def restore_state(self, state):
        self.count = state["count"]
        self.box["count"] = self.count


def _forward_job(chaining, n=50, box=None):
    env = StreamExecutionEnvironment(parallelism=1)
    env.configure(chaining=chaining)
    out = (env.from_collection(list(range(n)))
           .map(lambda x: x * 2, name="dbl")
           .filter(lambda x: x % 4 == 0, name="quad")
           .sink_to_list())
    return env, out


def test_one_thread_per_chain_zero_queue_traffic():
    env, out = _forward_job(True)
    handle = env.execute_async()
    ex = handle.executor
    assert len(ex.subtasks) == 1       # one thread for the chain
    assert ex.total_subtasks == 4      # four logical operators
    assert ex._gates == []             # no queue anywhere
    report = handle.wait(timeout=60).metrics
    assert sorted(out) == [x * 2 for x in range(50) if x * 2 % 4 == 0]
    assert not [k for k in report if "_queue_puts" in k]
    assert report["dbl.0.chained_edges"] == 3


def test_unchained_comparison_has_queue_traffic():
    env, out = _forward_job(False)
    handle = env.execute_async()
    assert len(handle.executor.subtasks) == 4 and len(handle.executor._gates) == 3
    report = handle.wait(timeout=60).metrics
    assert len(out) == 25
    # 50 records and one end of partition down each of the first two edges.
    assert report["dbl.0.edge0_collection_queue_puts"] == 51
    assert report["quad.0.edge0_dbl_queue_puts"] == 51
    assert report["collect.0.edge0_quad_queue_puts"] == 26
    assert report["dbl.0.chained_edges"] == 0


class _Tally(fn.ProcessFunction):
    """Keyed running count per key: keyed state behind a chain."""

    def process_element(self, value, ctx, out):
        from flink_tensorflow_tpu_torch.core.state import StateDescriptor

        state = ctx.state(StateDescriptor("n", lambda: 0))
        state.update(state.value() + 1)
        out.collect((ctx.current_key, value, state.value()))


def test_chaining_on_off_parity():
    def run(chaining):
        env = StreamExecutionEnvironment(parallelism=2)
        env.configure(chaining=chaining)
        out = (env.from_collection(list(range(60)), parallelism=2)
               .map(lambda x: x + 1, name="inc", parallelism=2)
               .key_by(lambda x: x % 5).process(_Tally(), name="tally", parallelism=2)
               .map(lambda t: t, name="post", parallelism=2)
               .sink_to_list(parallelism=2))
        handle = env.execute_async()
        threads = len(handle.executor.subtasks)
        handle.wait(timeout=60)
        return sorted(out), threads

    (on, on_threads), (off, off_threads) = run(True), run(False)
    assert on == off and len(on) == 60
    assert (on_threads, off_threads) == (4, 10)


def test_per_logical_operator_metrics_preserved():
    env = StreamExecutionEnvironment(parallelism=1)
    env.from_collection(list(range(30))).map(lambda x: x, name="ident") \
        .filter(lambda x: x % 3 == 0, name="third").sink_to_list(name="sink")
    rep = env.execute(timeout=60).metrics
    assert rep["collection.0.records_out"]["count"] == 30
    assert rep["ident.0.records_in"]["count"] == 30
    assert rep["ident.0.records_out"]["count"] == 30
    assert rep["third.0.records_in"]["count"] == 30
    assert rep["third.0.records_out"]["count"] == 10
    assert rep["sink.0.records_in"]["count"] == 10
    assert [rep[f"{s}.0.chained_edges"] for s in ("collection", "ident", "third", "sink")] \
        == [3, 3, 3, 3]


def _counted_job(ckpt, box, chaining=True, n=200, throttle=0.005):
    env = StreamExecutionEnvironment(parallelism=1)
    env.configure(chaining=chaining)
    if ckpt is not None:
        env.enable_checkpointing(ckpt)
    env.source_throttle_s = throttle
    out = (env.from_collection(list(range(n)))
           .map(CountingMap(box, "first"), name="first")
           .map(CountingMap(box, "second"), name="second")
           .sink_to_list())
    return env, out


def test_barrier_snapshots_every_chained_operator_in_order(tmp_path):
    box = {"count": 0, "order": []}
    env, _ = _counted_job(str(tmp_path / "c"), box)
    handle = env.execute_async()
    assert len(handle.executor.subtasks) == 1
    time.sleep(0.25)
    snaps = handle.trigger_checkpoint(timeout=30)
    assert set(snaps) >= {"collection", "first", "second", "collect"}
    offset = snaps["collection"][0]["operator"]["offset"]
    assert 0 < offset < 200, "the checkpoint should cut the stream mid-way"
    # The chain is synchronous: both maps counted exactly the records the
    # source emitted before the barrier, and snapshotted head to tail.
    assert snaps["first"][0]["function"]["count"] == offset
    assert snaps["second"][0]["function"]["count"] == offset
    assert box["order"][:2] == ["first", "second"]
    handle.cancel()
    handle.wait(timeout=30)


@pytest.mark.parametrize("layouts", [(True, True), (False, True), (True, False)],
                         ids=["chained", "unchained_to_chained", "chained_to_unchained"])
def test_restore_is_exactly_once_across_layouts(tmp_path, layouts):
    """A snapshot of logical operators restores whatever the layout of
    either run: every record counted once by each map."""
    ckpt = str(tmp_path / "c")
    env1, _ = _counted_job(ckpt, None, chaining=layouts[0])
    handle = env1.execute_async()
    time.sleep(0.25)
    snaps = handle.trigger_checkpoint(timeout=30)
    handle.cancel()
    handle.wait(timeout=30)
    offset = snaps["collection"][0]["operator"]["offset"]
    assert 0 < offset < 200
    assert snaps["second"][0]["function"]["count"] <= offset

    box = {"count": 0, "order": []}
    env2, out = _counted_job(ckpt, box, chaining=layouts[1], throttle=0.0)
    handle = env2.execute_async(restore_from=ckpt)
    assert len(handle.executor.subtasks) == (1 if layouts[1] else 4)
    handle.wait(timeout=60)
    assert box["count"] == 200
    assert sorted(out) == list(range(offset, 200))


def test_failover_restart_of_chained_job(tmp_path):
    crashed = [False]

    class FailingMap(fn.MapFunction):
        def __init__(self, count=0):
            self.count = count

        def clone(self):
            return FailingMap(self.count)

        def map(self, value):
            self.count += 1
            if not crashed[0] and self.count >= 60:
                crashed[0] = True
                raise RuntimeError("injected chain failure")
            return value

        def snapshot_state(self):
            return {"count": self.count}

        def restore_state(self, state):
            self.count = state["count"]

    env = StreamExecutionEnvironment(parallelism=1)
    env.enable_checkpointing(str(tmp_path / "c"), every_n_records=16)
    out = (env.from_collection(list(range(150)))
           .map(FailingMap(), name="fragile").sink_to_list())
    result = env.execute(timeout=120, restart_strategy=RestartStrategy(max_restarts=2))
    assert crashed[0] and result.restarts == 1
    # The records after checkpoint 3 (48 records) replay: at-least-once
    # sink, exactly-once state.
    assert set(out) == set(range(150))
    assert sorted(out) == sorted(list(range(150)) + list(range(48, 59)))


def _gated_model(events):
    """A model whose batch waits for ``events[v]``, v its first value."""
    schema = RecordSchema({"x": spec((1,), np.float32)})

    def serve(module, inputs):
        gate = events.get(int(inputs["x"][0, 0]))
        if gate is not None:
            assert gate.wait(timeout=30)
        return {"y": inputs["x"] * 2}

    return Model("gated", torch.nn.Identity(), {"serve": ModelMethod(
        "serve", schema, ("y",), serve)})


@pytest.mark.parametrize("chaining", [True, False], ids=["chained", "unchained"])
def test_idle_flush_of_a_model_fused_behind_a_worker_head(chaining):
    """``source -> rebalance -> map(head) -> ModelMapFunction -> sink``:
    chained, the model runs on its head's thread and its fetch thread
    wakes the head's gate.  In a lull with batch A completing and batch B
    in flight, the buffered partial (record 4) must dispatch idle_flush_s
    after its arrival: the completion wake neither dispatches it nor
    pushes its deadline out."""
    idle = 0.6
    events = {1: threading.Event(), 2: threading.Event()}
    lull = threading.Event()
    dispatched = {}

    class LullSource(fn.SourceFunction):
        def clone(self):
            return self

        def run(self):
            for v, i in ((1, 0), (1, 1), (2, 2), (2, 3), (0, 4)):
                yield TensorValue({"x": np.array([v], np.float32)}, {"i": i})
            dispatched["last_arrival"] = time.monotonic()
            assert lull.wait(timeout=30)

    model = _gated_model(events)
    serve = model.method("serve").fn

    def timed_serve(module, inputs):
        if int(inputs["x"][0, 0]) == 0:
            dispatched["partial"] = time.monotonic()
        return serve(module, inputs)

    model = Model("gated", torch.nn.Identity(), {"serve": ModelMethod(
        "serve", model.method("serve").input_schema, ("y",), timed_serve)})
    arrivals = {}
    env = StreamExecutionEnvironment(parallelism=1)
    env.configure(chaining=chaining)
    env.set_device_provider(lambda task, index: "cpu")
    (env.from_source(LullSource(), name="lull").rebalance()
     .map(lambda r: r, name="head")
     .map(ModelMapFunction(model, micro_batch=2, pipeline_depth=3, idle_flush_s=idle),
          name="model")
     .sink_to_callable(lambda r: arrivals.setdefault(r.meta["i"], time.monotonic())))
    handle = env.execute_async()
    assert len(handle.executor.subtasks) == (2 if chaining else 4)
    try:
        deadline = time.monotonic() + 10
        while "last_arrival" not in dispatched and time.monotonic() < deadline:
            time.sleep(0.005)
        time.sleep(0.3 * idle)
        events[1].set()                                  # A completes mid-lull
        while len(arrivals) < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert sorted(arrivals) == [0, 1]                # drained by the wake
        while "partial" not in dispatched and time.monotonic() < deadline:
            time.sleep(0.005)
        waited = dispatched["partial"] - dispatched["last_arrival"]
        assert idle * 0.9 <= waited < idle + 0.25, waited
    finally:
        events[2].set()
        lull.set()
        handle.wait(timeout=60)
    assert sorted(arrivals) == [0, 1, 2, 3, 4]
