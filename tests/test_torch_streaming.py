"""The port's streaming runtime held to the JAX runtime: the same bounded
job built through both packages' ``StreamExecutionEnvironment`` gives
the same outputs (twins of ``tests/test_core_streaming.py``).  Exact
equality throughout: no device math runs here."""

import collections
import time

import pytest

import flink_tensorflow_tpu as jax_pkg
from flink_tensorflow_tpu.core import functions as jax_fn
from flink_tensorflow_tpu.core.runtime import JobFailure as JaxJobFailure
from flink_tensorflow_tpu_torch.core import functions as torch_fn
from flink_tensorflow_tpu_torch.core.environment import StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.core.runtime import JobFailure

PACKAGES = {
    "jax": (jax_pkg.StreamExecutionEnvironment, jax_fn),
    "torch": (StreamExecutionEnvironment, torch_fn),
}


def run_both(build, parallelism=1, throttle=0.0):
    """Build the job in each package with ``build(env, fn_module)`` (it
    returns the sink list) and run it; returns ``{package: outputs}``."""
    out = {}
    for name, (env_cls, fn_mod) in PACKAGES.items():
        env = env_cls(parallelism=parallelism)
        if throttle:
            env.source_throttle_s = throttle
        sink = build(env, fn_mod)
        env.execute(timeout=30)
        out[name] = sink
    return out


def batch_sum(fn_mod):
    class BatchSum(fn_mod.WindowFunction):
        def process_window(self, key, window, elements, out):
            out.collect((key, len(elements), sum(elements)))

    return BatchSum()


def test_map_filter_pipeline():
    out = run_both(lambda env, f: env.from_collection(list(range(100)))
                   .map(lambda x: x * 2).filter(lambda x: x % 4 == 0).sink_to_list(),
                   parallelism=2)
    assert sorted(out["torch"]) == sorted(out["jax"])
    assert sorted(out["torch"]) == [x * 2 for x in range(100) if (x * 2) % 4 == 0]


def test_parallel_source_emits_exactly_once():
    out = run_both(lambda env, f: env.from_collection(list(range(1000)), parallelism=4)
                   .sink_to_list(), parallelism=4)
    assert sorted(out["torch"]) == sorted(out["jax"]) == list(range(1000))


def test_count_window_micro_batch():
    out = run_both(lambda env, f: env.from_collection(list(range(10))).count_window(4)
                   .apply(batch_sum(f), parallelism=1).sink_to_list())
    # 4 + 4 + the end-of-input flush of 2, in order on one subtask.
    assert out["torch"] == out["jax"] == [(None, 4, 6), (None, 4, 22), (None, 2, 17)]


def test_count_or_timeout_window_flushes_partial_batch():
    start = time.monotonic()
    out = run_both(lambda env, f: env.from_collection(list(range(5)))
                   .count_window(100, timeout_s=0.03).apply(batch_sum(f), parallelism=1)
                   .sink_to_list(), throttle=0.06)
    assert time.monotonic() - start < 20
    for got in out.values():
        # The timeout, not the count of 100 nor only the end-of-input
        # flush, cut the windows: 5 records 60 ms apart cannot share one.
        assert sum(n for _, n, _ in got) == 5 and sum(s for _, _, s in got) == 10
        assert len(got) >= 2, got


def test_rebalance_distributes_records():
    def build(env, f):
        class Tag(f.MapFunction):
            def open(self, ctx):
                self.idx = ctx.subtask_index

            def map(self, value):
                return self.idx

        return (env.from_collection(list(range(64))).rebalance()
                .map(Tag(), parallelism=4).sink_to_list())

    out = run_both(build, parallelism=4)
    counts = {k: collections.Counter(v) for k, v in out.items()}
    assert counts["torch"] == counts["jax"] == {i: 16 for i in range(4)}


def test_sink_to_callable_sees_every_record():
    def build(env, f):
        got = []
        env.from_collection(list(range(20))).map(lambda x: x + 1, parallelism=2) \
            .sink_to_callable(got.append)
        return got

    out = run_both(build, parallelism=2)
    assert sorted(out["torch"]) == sorted(out["jax"]) == list(range(1, 21))


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_error_propagates(package):
    env_cls, _ = PACKAGES[package]
    env = env_cls(parallelism=1)

    def boom(x):
        raise ValueError("boom")

    env.from_collection([1]).map(boom).sink_to_list()
    with pytest.raises(JaxJobFailure if package == "jax" else JobFailure) as info:
        env.execute(timeout=30)
    assert isinstance(info.value.__cause__, ValueError)
