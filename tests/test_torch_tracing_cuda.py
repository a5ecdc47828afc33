"""The tracing plane on the card (``cuda``-marked; they skip without an
NVIDIA GPU).  This file imports neither flax nor the JAX package, so it
collects on a machine that has neither.

- ``utils/profiling.device_memory_stats`` reads the allocator under the
  reference's keys, and ``profiling.trace`` writes a trace with device
  activity.
- A traced ``CompiledMethodRunner`` batch on ``cuda:0`` records exactly
  one ``lane_wait``, ``h2d``, ``compute`` and ``d2h`` span, tiling the
  batch from dispatch to results, and its outputs equal the untraced
  runner's.
"""

import json

import numpy as np
import pytest
import torch

from flink_tensorflow_tpu_torch.core.runtime_context import RuntimeContext
from flink_tensorflow_tpu_torch.functions.runner import CompiledMethodRunner
from flink_tensorflow_tpu_torch.metrics.registry import MetricRegistry
from flink_tensorflow_tpu_torch.metrics.roofline import RooflineConfig, RooflinePlane
from flink_tensorflow_tpu_torch.models import lenet_cell
from flink_tensorflow_tpu_torch.tensors.batching import BucketLadder, BucketPolicy
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


def _run(model, records, *, traced):
    grp = MetricRegistry().group("lenet.0")
    ctx = RuntimeContext("lenet", 0, metric_group=grp, device="cuda:0")
    tracer = Tracer() if traced else None
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
    assert tracer.dropped() == 0
    snap = grp._registry.snapshot()["lenet.0"]
    assert snap["roofline.busy_s"] > 0 and snap["roofline.compile_events"] == 1
