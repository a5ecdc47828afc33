"""The open-loop path of the port, held to the JAX package on the CPU.

- ``AdaptiveLatencyTrigger``: fire decisions and deadlines equal the JAX
  package's on a seeded arrival sequence with injected clock times, with
  and without service-time feedback (exact: the same float operations).
- ``PacedSource``: offsets, scheduled times and heartbeats equal, and
  after ``seek`` too; a restored source operator seeks instead of
  sleeping through the skipped records; ``GeneratorSource`` and
  ``ThrottledSource`` emit what the JAX ones emit.
- ``SOURCE_IDLE`` lets a sparse source serve a checkpoint barrier.
- ``count_window(latency_budget_s=...)`` builds the trigger (validated as
  the JAX package validates), and the chain plan keeps its window out of
  the source chain.
- Stage stamps: the keys of ``meta["__stages__"]`` and ``__arrive_ts__``
  equal the JAX package's.
- The open-loop Inception cell at 75 px: every id once, labels equal to
  direct calls.
"""

import time

import numpy as np
import pytest
import torch

pytest.importorskip("flax")

import jax

from flink_tensorflow_tpu import StreamExecutionEnvironment as JaxEnv
from flink_tensorflow_tpu.core import elements as jax_elements
from flink_tensorflow_tpu.core.operators import SourceOperator as JaxSourceOperator
from flink_tensorflow_tpu.core.windows import AdaptiveLatencyTrigger as JaxTrigger
from flink_tensorflow_tpu.core.windows import WindowBuffer as JaxWindowBuffer
from flink_tensorflow_tpu.functions import ModelWindowFunction as JaxModelWindowFunction
from flink_tensorflow_tpu.io import sources as jax_sources
from flink_tensorflow_tpu.models import get_model_def as jax_model_def
from flink_tensorflow_tpu.tensors import BucketPolicy as JaxBucketPolicy
from flink_tensorflow_tpu.tensors.value import TensorValue as JaxTensorValue
from flink_tensorflow_tpu_torch import StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.core import elements
from flink_tensorflow_tpu_torch.core import functions as fn
from flink_tensorflow_tpu_torch.core.operators import SourceOperator
from flink_tensorflow_tpu_torch.core.windows import AdaptiveLatencyTrigger, WindowBuffer
from flink_tensorflow_tpu_torch.functions.model_function import ModelWindowFunction
from flink_tensorflow_tpu_torch.io import sources
from flink_tensorflow_tpu_torch.models import inception_cell
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.tensors.batching import BucketPolicy
from flink_tensorflow_tpu_torch.tensors.value import TensorValue

CPU = lambda task, index: "cpu"  # noqa: E731


class FakeClock:
    """``time.monotonic`` and ``time.sleep`` on a clock the test moves."""

    def __init__(self, t=1000.0):
        self.t = t

    def monotonic(self):
        return self.t

    def sleep(self, s):
        self.t += s


def trigger_trace(trigger, buffer_cls, arrivals, service):
    """Per arrival: ``(fired, deadline before the fire)``, and the fires'
    window sizes."""
    out, sizes = [], []
    buf = buffer_cls(window=None)
    clock = FakeClock(arrivals[0])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(time, "monotonic", clock.monotonic)
        for i, t in enumerate(arrivals):
            clock.t = t
            if service is not None and i % 5 == 4:
                trigger.observe_service_time(service[i])
            buf.add(i, None)
            fired = trigger.on_element(buf)
            out.append((fired, trigger.deadline(buf)))
            if fired:
                sizes.append(len(buf.elements))
                buf = buffer_cls(window=None)
    return out, sizes


@pytest.mark.parametrize("feedback", [False, True])
@pytest.mark.parametrize("rate", [5.0, 60.0, 400.0])
def test_adaptive_trigger_decides_as_the_jax_one(feedback, rate):
    rng = np.random.RandomState(3)
    gaps = rng.exponential(1.0 / rate, 300)
    gaps[100:110] = 1e-4            # a burst
    gaps[200] = 2.0                 # a lull
    arrivals = list(1000.0 + np.cumsum(gaps))
    service = list(rng.uniform(0.005, 0.2, 300)) if feedback else None
    got = trigger_trace(AdaptiveLatencyTrigger(16, 0.3), WindowBuffer, arrivals, service)
    want = trigger_trace(JaxTrigger(16, 0.3), JaxWindowBuffer, arrivals, service)
    assert got == want
    assert 0 < len(got[1]) < 300     # partial and full windows both fire


def test_adaptive_trigger_validation_and_clone():
    for args in ((0, 0.3), (4, 0.0), (4, 0.3, 0.0)):
        with pytest.raises(ValueError):
            AdaptiveLatencyTrigger(*args[:2], **({"ewma_alpha": args[2]} if len(args) > 2 else {}))
    t = AdaptiveLatencyTrigger(4, 0.3)
    t.observe_service_time(0.1)
    c = t.clone()
    assert c is not t and c._service_ewma is None and c.count == 4
    assert t.has_deadlines()


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_count_window_budget_validation(package):
    env = JaxEnv(parallelism=1) if package == "jax" else StreamExecutionEnvironment(parallelism=1)
    s = env.from_collection([1, 2])
    with pytest.raises(ValueError, match="sliding"):
        s.count_window(4, slide=2, latency_budget_s=0.1)
    with pytest.raises(ValueError, match="not both"):
        s.count_window(4, timeout_s=1.0, latency_budget_s=0.1)


class _Sum(fn.WindowFunction):
    def process_window(self, key, window, elements, out):
        out.collect(sum(elements))


def test_the_budget_window_is_cut_from_the_source_chain():
    env = StreamExecutionEnvironment(parallelism=1)
    env.from_collection(list(range(8))).count_window(4, latency_budget_s=0.1) \
        .apply(_Sum(), name="w").sink_to_list()
    handle = env.execute_async()
    handle.wait(60)
    plan = handle.executor.chain_plan
    assert len(plan.chains) == 2 and [t.name for t in plan.chains[1]][0] == "w"


def test_a_budget_window_fires_partial_windows_in_a_job():
    env = StreamExecutionEnvironment(parallelism=1)
    out = (env.from_source(sources.PacedSource(list(range(12)), 40.0, jitter="none"))
           .count_window(100, latency_budget_s=0.05).apply(_Sum(), name="w").sink_to_list())
    env.execute(timeout=60)
    assert sum(out) == sum(range(12)) and len(out) > 1


def paced_trace(module_time, source, ctx_cls, idle_cls, seek=None):
    clock = FakeClock()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module_time, "monotonic", clock.monotonic)
        mp.setattr(module_time, "sleep", clock.sleep)
        source.open(ctx_cls())
        if seek is not None:
            source.seek(seek)
        t0 = clock.t
        out = []
        for v in source.run():
            if isinstance(v, idle_cls):
                out.append(("idle", round(clock.t - t0, 9)))
            else:
                out.append((v.meta["id"], round(v.meta["sched_ts"] - t0, 9)))
    return out


class _Ctx:
    subtask_index = 0
    parallelism = 1


@pytest.mark.parametrize("jitter", ["poisson", "none"])
@pytest.mark.parametrize("seek", [None, 7])
def test_paced_source_schedule_equals_the_jax_one(jitter, seek):
    data = [TensorValue({"x": np.float32(i)}, {"id": i}) for i in range(20)]
    jdata = [JaxTensorValue({"x": np.float32(i)}, {"id": i}) for i in range(20)]
    mine = sources.PacedSource(data, 3.0, jitter=jitter, seed=5, start_delay_s=0.25)
    ref = jax_sources.PacedSource(jdata, 3.0, jitter=jitter, seed=5, start_delay_s=0.25)
    assert np.array_equal(mine._offsets(20), ref._offsets(20))
    got = paced_trace(time, mine, _Ctx, elements.SourceIdle, seek)
    want = paced_trace(time, ref, _Ctx, jax_elements.SourceIdle, seek)
    assert got == want
    assert [x[0] for x in got if x[0] != "idle"] == list(range(seek or 0, 20))
    assert any(x[0] == "idle" for x in got)


def test_a_restored_source_operator_seeks_instead_of_sleeping():
    got = {}
    for name, op_cls, src_mod, tv in (("torch", SourceOperator, sources, TensorValue),
                                      ("jax", JaxSourceOperator, jax_sources, JaxTensorValue)):
        recs = [tv({"x": np.float32(i)}, {"id": i}) for i in range(6)]
        op = op_cls("s", src_mod.PacedSource(recs, 2.0, jitter="none"))
        op._operator_restore({"offset": 5})
        op.function.open(_Ctx())
        t0 = time.monotonic()
        ids = [v.meta["id"] for v in op.iterate() if hasattr(v, "meta")]
        got[name] = (ids, time.monotonic() - t0)
    assert got["torch"][0] == got["jax"][0] == [5]
    assert got["torch"][1] < 1.0     # one gap (0.5 s), not the skipped 2.5 s


def test_generator_and_throttled_sources_equal_the_jax_ones():
    def factory(i, p):
        return iter(range(i, 9, p))

    env = StreamExecutionEnvironment(parallelism=1)
    a = env.from_source(sources.GeneratorSource(factory), parallelism=2).sink_to_list()
    b = env.from_source(sources.ThrottledSource(sources.GeneratorSource(factory), 0.001)) \
        .sink_to_list()
    env.execute(timeout=60)
    jenv = JaxEnv(parallelism=1)
    ja = jenv.from_source(jax_sources.GeneratorSource(factory), parallelism=2).sink_to_list()
    jb = jenv.from_source(jax_sources.ThrottledSource(jax_sources.GeneratorSource(factory),
                                                      0.001)).sink_to_list()
    jenv.execute("g", timeout=60)
    assert sorted(a) == sorted(ja) == list(range(9))
    assert b == jb == list(range(9))


def test_a_sparse_source_serves_a_barrier_while_it_waits(tmp_path):
    env = StreamExecutionEnvironment(parallelism=1)
    env.enable_checkpointing(str(tmp_path))
    data = [TensorValue({"x": np.float32(i)}, {"id": i}) for i in range(2)]
    out = env.from_source(sources.PacedSource(data, 0.5, jitter="none")).sink_to_list()
    handle = env.execute_async()
    time.sleep(0.3)
    t0 = time.monotonic()
    handle.trigger_checkpoint(timeout=5.0)      # records are due at 2 s and 4 s
    served = time.monotonic() - t0
    handle.cancel()
    assert served < 1.0 and out == []


def test_stage_stamp_keys_equal_the_jax_ones():
    jdef = jax_model_def("lenet")
    variables = jax.tree.map(np.asarray, jax.jit(jdef.init_fn)(jax.random.key(0)))
    images = np.random.RandomState(0).rand(6, 28, 28, 1).astype(np.float32)
    jenv = JaxEnv(parallelism=1)
    want = (jenv.from_collection([JaxTensorValue({"image": im}, {"id": i})
                                  for i, im in enumerate(images)], parallelism=1)
            .count_window(4, timeout_s=0.05)
            .apply(JaxModelWindowFunction(jdef.to_model(variables),
                                          policy=JaxBucketPolicy(fixed_batch=4),
                                          stamp_stages=True), name="m")
            .sink_to_list())
    jenv.execute("stamps", timeout=600)
    env = StreamExecutionEnvironment(parallelism=1)
    env.set_device_provider(CPU)
    got = (env.from_collection([TensorValue({"image": im}, {"id": i})
                                for i, im in enumerate(images)])
           .count_window(4, timeout_s=0.05)
           .apply(ModelWindowFunction(get_model_def("lenet").to_model(variables),
                                      policy=BucketPolicy(fixed_batch=4), stamp_stages=True),
                  name="m")
           .sink_to_list())
    env.execute(timeout=60)
    assert set(got[0].meta) == set(want[0].meta) == {"id", "__arrive_ts__", "__stages__"}
    assert set(got[0].meta["__stages__"]) == set(want[0].meta["__stages__"])
    for r in got:
        st = r.meta["__stages__"]
        assert (r.meta["__arrive_ts__"] <= st["t0"] <= st["t_lane_start"] <= st["t_dispatched"]
                <= st["t_fetch_start"] <= st["t_done"])
        assert st["batch_n"] == (4 if r.meta["id"] < 4 else 2)


def test_the_open_loop_cell_at_75px():
    # f32: the paced windows' sizes vary between runs, and f32 labels do
    # not move with the batch a record shares.
    mdef = get_model_def("inception_v3", num_classes=4, image_size=75, uint8_input=True,
                         compute_dtype="float32")
    model = mdef.to_model(mdef.init_params(0))
    pixels = np.random.RandomState(0).randint(0, 256, (24, 75, 75, 3), dtype=np.uint8)
    records = [TensorValue({"image": pixels[i]}, {"id": i}) for i in range(24)]
    capacity, cal = inception_cell.calibrate(model, records, device_provider=CPU, lanes=2)
    assert capacity > 0 and sorted(r.meta["id"] for r in cal.results) == list(range(24))
    rtt = inception_cell.one_record_round_trip(model, records[0], device="cpu", repeats=2)
    budget = max(inception_cell.BUDGET_S, 1.5 * rtt)
    run = inception_cell.run_open_loop(model, records[:16], 0.5 * capacity, budget,
                                       device_provider=CPU, lanes=2, start_delay_s=0.2)
    assert sorted(r.meta["id"] for r in run.results) == list(range(16))
    with torch.inference_mode():
        want = mdef.methods["serve"].fn(model.params, {"image": torch.from_numpy(pixels[:16])})
    for r in run.results:
        assert int(r["label"]) == int(want["label"][r.meta["id"]])
    summary = inception_cell.open_loop_summary(run, 0.5 * capacity)
    assert summary["p50_ms"] <= summary["p95_ms"] <= summary["p99_ms"]
    assert set(summary["stage_p50_ms"]) == set(inception_cell.STAGES)
    assert sum(n * c for n, c in summary["windows_by_size"].items()) == 16
