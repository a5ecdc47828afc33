"""The tracing plane on the card (``cuda``-marked; they skip without an
NVIDIA GPU).  This file imports neither flax nor the JAX package, so it
collects on a machine that has neither.

- ``utils/profiling.device_memory_stats`` reads the allocator under the
  reference's keys, and ``profiling.trace`` writes a trace with device
  activity.
- A traced ``CompiledMethodRunner`` batch on ``cuda:0`` records exactly
  one ``lane_wait``, ``h2d``, ``compute`` and ``d2h`` span, tiling the
  batch from dispatch to results, and one ``device`` span from its own
  CUDA events on ``<track>.device``; its outputs equal the untraced
  runner's, and the roofline plane's busy time is the device spans'.
- One clock with the device trace: a span around a known launch holds
  the profiler's kernel within 1 ms in the merged ``trace.json``, which
  holds the device rows and the tracer's tracks, each traced batch's
  kernels inside its ``device`` span.
- A traced gang on the card: one ``device`` span per step and a
  ``step_gap_s`` value for each step after the first.
"""

import json
import time

import numpy as np
import pytest
import torch

from flink_tensorflow_tpu_torch import StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.core.runtime_context import RuntimeContext
from flink_tensorflow_tpu_torch.functions import DPTrainWindowFunction
from flink_tensorflow_tpu_torch.functions.runner import CompiledMethodRunner
from flink_tensorflow_tpu_torch.metrics.registry import MetricRegistry
from flink_tensorflow_tpu_torch.metrics.roofline import RooflineConfig, RooflinePlane
from flink_tensorflow_tpu_torch.models import lenet_cell
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.parallel import optim
from flink_tensorflow_tpu_torch.parallel.mesh import make_mesh
from flink_tensorflow_tpu_torch.tensors.batching import BucketLadder, BucketPolicy
from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, spec
from flink_tensorflow_tpu_torch.tensors.value import TensorValue
from flink_tensorflow_tpu_torch.tracing import Tracer
from flink_tensorflow_tpu_torch.utils import profiling


def needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_device_memory_stats_and_the_profiler_trace(tmp_path):
    needs_cuda()
    x = torch.ones((1024, 1024), device="cuda:0")
    stats = profiling.device_memory_stats("cuda:0")
    assert stats["bytes_in_use"] >= x.numel() * 4
    assert stats["peak_bytes_in_use"] >= stats["bytes_in_use"]
    assert stats["bytes_limit"] > stats["bytes_in_use"]
    assert profiling.device_memory_stats(None)["bytes_in_use"] == stats["bytes_in_use"]
    with profiling.trace(str(tmp_path)):
        with profiling.annotate_batch("op.0", 1):
            (x @ x).sum().item()
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(ev.get("cat") == "kernel" for ev in trace["traceEvents"])


def _run(model, records, *, traced, tracer=None):
    grp = MetricRegistry().group("lenet.0")
    ctx = RuntimeContext("lenet", 0, metric_group=grp, device="cuda:0")
    tracer = (tracer or Tracer()) if traced else None
    ctx.tracer = tracer
    ctx.roofline = RooflinePlane(RooflineConfig()) if traced else None
    runner = CompiledMethodRunner(model, policy=BucketPolicy(batch=BucketLadder.up_to(32)))
    runner.open(ctx)
    try:
        runner.warmup([32])
        runner.dispatch(records[:32])
        runner.dispatch(records[32:64])
        out = runner.flush()
    finally:
        runner.close()
    return out, tracer, grp


@pytest.mark.cuda
def test_a_traced_batch_has_one_span_of_each_stage():
    needs_cuda()
    _, model, _, records = lenet_cell.lenet_cell(0, records=64)
    plain, _, _ = _run(model, records, traced=False)
    traced, tracer, grp = _run(model, records, traced=True)
    for a, b in zip(plain, traced):
        for name in a.fields:
            np.testing.assert_array_equal(a.fields[name], b.fields[name])
    events = tracer.events()
    spans = [e for e in events if e[0] == "lenet.0" and e[2] == "X"]
    by_name = {}
    for e in spans:
        by_name.setdefault(e[1], []).append(e)
    assert {k: len(v) for k, v in by_name.items()} == {
        "jit_warmup_compile": 1, "lane_wait": 2, "h2d": 2, "compute": 2, "d2h": 2}
    # Consecutive stages meet: each batch's stage starts where its previous
    # one ended.  Two lanes may take the two batches in either order, so
    # the ends and starts are matched by value, not by position.
    stages = ("lane_wait", "h2d", "compute", "d2h")
    for before, after in zip(stages, stages[1:]):
        ends = sorted(e[3] + e[4] for e in by_name[before])
        starts = sorted(e[3] for e in by_name[after])
        assert ends == pytest.approx(starts, abs=1e-6), (before, after)
    assert all(e[5]["bytes"] > 0 for e in by_name["h2d"])
    assert all(e[5]["batch"] == 32 for e in by_name["d2h"])
    # The h2d span splits at the H2D's end, and gives the lane's CPU time.
    for e in by_name["h2d"]:
        assert e[5]["h2d_s"] + e[5]["launch_s"] == pytest.approx(e[4], abs=2e-6)
        assert 0 <= e[5]["cpu_s"]
    # The device track: one ``device`` span per batch, from its events.
    device = [e for e in events if e[0] == "lenet.0.device"]
    census = {}
    for e in device:
        census[e[1]] = census.get(e[1], 0) + 1
    assert census.get("device") == 2 and set(census) <= {"device", "device.idle"}, census
    for e in device:
        if e[1] == "device.idle":
            assert e[5]["host"] in ("window", "lane_wait", "h2d", "launch")
    assert tracer.dropped() == 0
    snap = grp._registry.snapshot()["lenet.0"]
    assert snap["roofline.busy_s"] > 0 and snap["roofline.compile_events"] == 1
    # The roofline's busy time is the union of the batches' device spans
    # (two lanes' batches may overlap on the stream).
    union, end = 0.0, None
    for t0, dur in sorted((e[3], e[4]) for e in device if e[1] == "device"):
        t1 = t0 + dur
        if end is None or t0 >= end:
            union += dur
        elif t1 > end:
            union += t1 - end
        end = t1 if end is None else max(end, t1)
    assert snap["roofline.busy_s"] == pytest.approx(union, rel=1e-4)
    assert grp.histogram("device_gap_s").count == 1
    assert grp.histogram("dispatch_cpu_s").count == 2


def _kernels(trace):
    return [e for e in trace["traceEvents"] if e.get("ph") == "X" and e.get("cat") == "kernel"]


@pytest.mark.cuda
def test_a_span_around_a_launch_holds_the_profilers_kernel(tmp_path):
    needs_cuda()
    x = torch.randn((2048, 2048), device="cuda:0")
    (x @ x).sum().item()        # warm: cuBLAS's handle and plans
    tracer = Tracer()
    with profiling.trace(str(tmp_path), tracer=tracer):
        torch.cuda.synchronize()
        time.sleep(0.02)
        t0 = time.monotonic()
        y = x @ x
        torch.cuda.synchronize()
        t1 = time.monotonic()
        tracer.span("test.0", "matmul", t0, t1)
        time.sleep(0.02)
        del y
    trace = json.loads((tmp_path / "trace.json").read_text())
    (span,) = [e for e in trace["traceEvents"] if e.get("name") == "matmul" and e["ph"] == "X"]
    kernels = [k for k in _kernels(trace) if k["ts"] > span["ts"] - 20_000
               and k["ts"] < span["ts"] + span["dur"] + 20_000]
    assert kernels, "no kernel within 20 ms of the span"
    for k in kernels:
        assert span["ts"] - 1000 <= k["ts"] and k["ts"] + k["dur"] <= span["ts"] + span["dur"] + 1000
    assert trace["clock"]["anchor_unix_ns"] == tracer.clock[1]


@pytest.mark.cuda
def test_the_merged_trace_holds_device_rows_and_the_tracers_tracks(tmp_path):
    needs_cuda()
    _, model, _, records = lenet_cell.lenet_cell(0, records=64)
    tracer = Tracer()
    with profiling.trace(str(tmp_path), tracer=tracer):
        _run(model, records, traced=True, tracer=tracer)
    trace = json.loads((tmp_path / "trace.json").read_text())
    kernels = _kernels(trace)
    assert kernels
    names = {e["args"]["name"] for e in trace["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert {"lenet.0", "lenet.0.device"} <= names
    device = [e for e in trace["traceEvents"] if e.get("name") == "device" and e["ph"] == "X"]
    assert len(device) == 2
    lo = min(d["ts"] for d in device)
    hi = max(d["ts"] + d["dur"] for d in device)
    live = [k for k in kernels if lo - 1000 <= k["ts"] <= hi + 1000]
    assert live, "no kernel of the traced batches"
    for k in live:      # each live batch's kernels lie in its device span, within 1 ms
        assert any(d["ts"] - 1000 <= k["ts"] and k["ts"] + k["dur"] <= d["ts"] + d["dur"] + 1000
                   for d in device), k["name"]
    for d in device:
        assert any(d["ts"] <= k["ts"] <= d["ts"] + d["dur"] for k in live)


@pytest.mark.cuda
def test_a_traced_gang_times_each_step_on_the_card():
    needs_cuda()
    cfg = dict(num_classes=4, image_size=32, width=8, stage_sizes=(1, 1))
    rng = np.random.RandomState(0)
    recs = [TensorValue({"image": rng.rand(32, 32, 3).astype(np.float32),
                         "label": np.int32(i % 4)}) for i in range(40)]
    env = StreamExecutionEnvironment(parallelism=1).configure(trace=True, flight_recorder=False)
    env.set_mesh(make_mesh({"data": 1}))
    schema = RecordSchema({"image": spec((32, 32, 3)), "label": spec((), np.int32)})
    out = (env.from_collection(recs).count_window(8)
           .apply(DPTrainWindowFunction(get_model_def("resnet50", **cfg), optim.adam(1e-2),
                                        train_schema=schema, global_batch=8), name="dp")
           .sink_to_list())
    handle = env.execute_async("gang")
    handle.wait(300)
    assert len(out) == 5
    events = handle.executor.tracer.events()
    device = [e for e in events if e[0] == "dp.0.device" and e[1] == "device"]
    assert sorted(e[5]["step"] for e in device) == [1, 2, 3, 4, 5]
    device.sort(key=lambda e: e[3])
    for a, b in zip(device, device[1:]):     # one stream: the steps follow each other
        assert a[3] + a[4] <= b[3] + 1e-3
    for e in events:
        if e[1] == "device.idle":
            assert e[5]["host"] in ("window", "train.assemble", "train.ship", "train.launch",
                                    "train.drain", "train.emit")
    grp = env.metric_registry.group("dp.0")
    assert grp.histogram("step_gap_s").count == 4
    assert grp.histogram("loss_wait_s").count == 5
