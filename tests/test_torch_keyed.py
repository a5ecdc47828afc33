"""Keyed streams in the port, held to the JAX package: the same key lands
in the same key group and subtask in both (a checkpoint's key groups mean
the same thing in each), and ``key_by().process()`` keyed counts route and
count the same records on the same subtasks at parallelism 1, 2 and 3."""

import numpy as np
import pytest

import flink_tensorflow_tpu as jax_pkg
from flink_tensorflow_tpu.core import functions as jax_fn
from flink_tensorflow_tpu.core import partitioning as jax_part
from flink_tensorflow_tpu.core.state import StateDescriptor as JaxDescriptor
from flink_tensorflow_tpu_torch import StateDescriptor, StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.core import functions as torch_fn
from flink_tensorflow_tpu_torch.core import partitioning as port_part

MAXP = port_part.DEFAULT_MAX_PARALLELISM


def draw_keys(kind: str, n: int = 200, seed: int = 0):
    rng = np.random.RandomState(seed)
    if kind == "int":
        return [int(x) for x in rng.randint(-2**62, 2**62, n, dtype=np.int64)]
    if kind == "np_int":
        return list(rng.randint(0, 2**31, n).astype(np.int32)) + \
            list(rng.randint(-2**40, 2**40, n, dtype=np.int64))
    if kind == "str":
        return ["".join(chr(c) for c in rng.randint(32, 0x3000, rng.randint(0, 12)))
                for _ in range(n)]
    if kind == "bytes":
        return [bytes(rng.randint(0, 256, rng.randint(0, 16)).astype(np.uint8)) for _ in range(n)]
    if kind == "tuple":
        return [(int(rng.randint(0, 1000)), f"u{rng.randint(0, 50)}", float(rng.rand()))
                for _ in range(n)]
    raise ValueError(kind)


@pytest.mark.parametrize("parallelism", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("kind", ["int", "np_int", "str", "bytes", "tuple"])
def test_key_groups_and_subtasks_equal_jax(kind, parallelism):
    assert port_part.DEFAULT_MAX_PARALLELISM == jax_part.DEFAULT_MAX_PARALLELISM == 128
    keys = draw_keys(kind, seed=parallelism)
    for key in keys:
        assert port_part._stable_hash(key) == jax_part._stable_hash(key), key
        assert port_part.key_group(key, MAXP) == jax_part.key_group(key, MAXP), key
        want = jax_part.subtask_for_key(key, parallelism, MAXP)
        assert port_part.subtask_for_key(key, parallelism, MAXP) == want, key
        assert port_part.HashPartitioner(lambda k: k).select(key, parallelism) == (want,)
    owners = [port_part.subtask_for_key_group(g, parallelism, MAXP) for g in range(MAXP)]
    assert owners == sorted(owners) and set(owners) == set(range(parallelism))


def keyed_counter(fn_mod, descriptor_cls):
    count = descriptor_cls("count", default_factory=lambda: 0)

    class KeyedCounter(fn_mod.ProcessFunction):
        def open(self, ctx):
            self.index = ctx.subtask_index

        def process_element(self, value, ctx, out):
            state = ctx.state(count)
            n = state.value() + 1
            state.update(n)
            out.collect((ctx.current_key, n, self.index))

    return KeyedCounter()


@pytest.mark.parametrize("parallelism", [1, 2, 3])
def test_keyed_process_counts_equal_jax(parallelism):
    records = [f"user-{i % 7}" if i % 3 else i % 11 for i in range(240)]
    out = {}
    for name, env_cls, function in (
            ("jax", jax_pkg.StreamExecutionEnvironment, keyed_counter(jax_fn, JaxDescriptor)),
            ("torch", StreamExecutionEnvironment, keyed_counter(torch_fn, StateDescriptor))):
        env = env_cls(parallelism=parallelism)
        sink = (env.from_collection(records).key_by(lambda r: r)
                .process(function, parallelism=parallelism).sink_to_list())
        env.execute(timeout=60)
        out[name] = sorted(sink, key=repr)
    assert out["torch"] == out["jax"]
    finals = {}
    for key, n, _ in out["torch"]:
        finals[key] = max(finals.get(key, 0), n)
    assert finals == {k: records.count(k) for k in set(records)}


def keyed_timer_function(fn_mod, descriptor_cls):
    count = descriptor_cls("count", default_factory=lambda: 0)

    class KeyedTimers(fn_mod.ProcessFunction):
        def process_element(self, value, ctx, out):
            state = ctx.state(count)
            n = state.value() + 1
            state.update(n)
            # A timestamp long past: the timer fires on the next loop turn.
            ctx.register_timer(float(n))

        def on_timer(self, timestamp, ctx, out):
            out.collect((ctx.current_key, timestamp, ctx.state(count).value()))

    return KeyedTimers()


@pytest.mark.parametrize("parallelism", [1, 3])
def test_keyed_timers_fire_per_key_equal_jax(parallelism):
    records = [i % 5 for i in range(40)]
    out = {}
    for name, env_cls, function in (
            ("jax", jax_pkg.StreamExecutionEnvironment,
             keyed_timer_function(jax_fn, JaxDescriptor)),
            ("torch", StreamExecutionEnvironment,
             keyed_timer_function(torch_fn, StateDescriptor))):
        env = env_cls(parallelism=parallelism)
        sink = (env.from_collection(records).key_by(lambda r: r)
                .process(function, parallelism=parallelism).sink_to_list())
        env.execute(timeout=60)
        # Which count a timer sees depends on thread timing; the timers
        # that fire do not.
        out[name] = sorted((key, ts) for key, ts, _ in sink)
    assert out["torch"] == out["jax"]
    assert out["torch"] == sorted((k, float(n)) for k in range(5) for n in range(1, 9))


def test_runtime_context_state_and_with_key_equal_jax():
    from flink_tensorflow_tpu.core.runtime_context import RuntimeContext as JaxContext
    from flink_tensorflow_tpu.core.state import KeyedStateStore as JaxStore
    from flink_tensorflow_tpu.metrics.registry import MetricRegistry as JaxRegistry
    from flink_tensorflow_tpu_torch.core.runtime_context import RuntimeContext
    from flink_tensorflow_tpu_torch.core.state import KeyedStateStore

    def drive(ctx, store, descriptor):
        seen = []
        for key in ("a", "b", "a", 3):
            store.current_key = key
            state = ctx.state(descriptor)
            state.update((state.value() or 0) + 1)
        store.current_key = "b"
        with ctx.with_key("a"):
            seen.append(ctx.state(descriptor).value())
            ctx.state(descriptor).clear()
            seen.append(ctx.state(descriptor).value())
        seen.append((store.current_key, ctx.state(descriptor).value()))
        return seen, store.snapshot()

    jax_store = JaxStore()
    want = drive(JaxContext("t", 0, 1, jax_store, JaxRegistry().group("t.0")), jax_store,
                 JaxDescriptor("n"))
    store = KeyedStateStore()
    got = drive(RuntimeContext("t", keyed_state=store), store, StateDescriptor("n"))
    assert got == want == ([2, None, ("b", 1)], {"n": {"b": 1, 3: 1}})
