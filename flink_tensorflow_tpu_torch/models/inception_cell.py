"""The Inception-v3 streaming cell the port is measured on.

The JAX package's own Inception bench (``bench.py:bench_inception``,
``:771-835``), at its full size: 2048 uint8 299x299x3 records from
``np.random.RandomState(0)``, each with its own bytes, through
``from_collection -> count_window(128, timeout_s=5.0) ->
ModelWindowFunction(fixed_batch=128, warmup_batches=(128,),
outputs=("label", "score"), transfer_lanes=6, pipeline_depth=6) ->
sink_to_callable``, at parallelism 1, Inception-v3 with 1000 classes in
bf16.  Weights are the port's initialiser's, from ``torch.Generator``
seed ``seed``.  The window function takes the ring, as the reference's
does by default (``use_ring=False`` in :func:`run_cell_job` takes the
list path).

The bench's open-loop pass (``bench.py:1040-1330``) on the same model:
:func:`calibrate` measures the service capacity at windows of 2 over 24
windows, and :func:`run_open_loop` offers a Poisson ``PacedSource`` at a
share of it into ``count_window(16, latency_budget_s=...) ->
ModelWindowFunction(BucketLadder.up_to(16), pipeline_depth=3,
idle_flush_s=0.002, stamp_stages=True)``; :func:`open_loop_summary`
reads latency from each record's scheduled arrival (coordinated-omission
free), keeps the records scheduled after the first result (warmup out),
and splits it into the bench's stages.
"""

from __future__ import annotations

import dataclasses
import time
import typing

import numpy as np

from flink_tensorflow_tpu_torch.core.environment import StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.functions.model_function import GraphWindowFunction, ModelWindowFunction
from flink_tensorflow_tpu_torch.functions.runner import CompiledMethodRunner
from flink_tensorflow_tpu_torch.io.sources import PacedSource
from flink_tensorflow_tpu_torch.models.stream_cell import run_job
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.tensors.batching import BucketLadder, BucketPolicy
from flink_tensorflow_tpu_torch.tensors.value import TensorValue

RECORDS = 2048
BATCH = 128
DEPTH = 6
#: ``bench.py --lanes`` (``:4174``).
LANES = 6
CLASSES = 1000
IMAGE = 299
TIMEOUT_S = 5.0

# The open-loop pass (bench.py:1040-1330).
OL_RECORDS = 512
OL_BATCH = 16
OL_DEPTH = 3
OL_IDLE_FLUSH_S = 0.002
CAL_WINDOW = 2
CAL_WINDOWS = 24
RATE_FRACTION = 0.5
#: The budget floor of the bench (``:1180``), raised to 1.5 x the one-record round trip.
BUDGET_S = 0.3
#: Seconds the paced schedule waits for the window function's open() and warmup.
START_DELAY_S = 2.0
STAGES = ("queue_wait", "trigger_hold", "lane_wait", "h2d_dispatch", "ready_wait",
          "fetch", "emit")


def inception_cell(seed: int = 0, records: int = RECORDS):
    """``(model_def, model, pixels [records, 299, 299, 3] uint8, records)``."""
    mdef = get_model_def("inception_v3", num_classes=CLASSES, image_size=IMAGE,
                         uint8_input=True)
    model = mdef.to_model(mdef.init_params(seed))
    pixels = np.random.RandomState(0).randint(0, 256, (records, IMAGE, IMAGE, 3),
                                              dtype=np.uint8)
    # Read-only: each TensorValue shares its row instead of copying it.
    pixels.setflags(write=False)
    values = [TensorValue({"image": pixels[i]}, {"id": i}) for i in range(records)]
    return mdef, model, pixels, values


def run_cell(model, records: typing.Sequence[TensorValue], *, device_provider=None,
             warmup: bool = True, timeout: float = 600.0):
    """Run the cell's job once in the default layout.  Returns
    ``(results, sink arrival times, metric report, seconds of
    execute())``; :func:`run_cell_job` returns the whole ``CellRun`` and
    picks the layout."""
    run = run_cell_job(model, records, device_provider=device_provider, warmup=warmup,
                       timeout=timeout)
    return run.results, run.arrivals, run.metrics, run.seconds


def run_cell_job(model, records: typing.Sequence[TensorValue], *, device_provider=None,
                 warmup: bool = True, timeout: float = 600.0, chaining: bool = True,
                 lanes: int = LANES, use_ring: typing.Optional[bool] = None, batch: int = BATCH,
                 config: typing.Optional[typing.Dict[str, typing.Any]] = None,
                 on_start: typing.Optional[typing.Callable[[typing.Any], None]] = None,
                 validate: bool = False):
    """Run the cell's job once (``chaining=False``: one thread per
    operator; ``use_ring=False``: the list path; ``config``: more
    ``JobConfig`` fields, such as ``trace``; ``validate``: the plan
    analyzer first) and return its ``CellRun``."""
    fn = ModelWindowFunction(model, policy=BucketPolicy(fixed_batch=batch),
                             warmup_batches=(batch,) if warmup else (),
                             outputs=("label", "score"), transfer_lanes=lanes,
                             pipeline_depth=DEPTH, use_ring=use_ring)
    return run_job(records, lambda s: s.count_window(batch, timeout_s=TIMEOUT_S)
                   .apply(fn, name="inception"),
                   device_provider=device_provider, timeout=timeout,
                   config={"chaining": chaining, **(config or {})}, on_start=on_start,
                   validate=validate)


def run_graph_job(graph, input_schema, records: typing.Sequence[TensorValue], *,
                  device_provider=None, timeout: float = 600.0, lanes: int = LANES,
                  batch: int = BATCH):
    """The cell's job with the model frozen (``models.loaders.freeze_method``
    at ``batch``): ``count_window(batch) -> GraphWindowFunction``, the
    cell's other settings unchanged."""
    fn = GraphWindowFunction(graph, batch=batch, input_schema=input_schema,
                             warmup_batches=(batch,), outputs=("label", "score"),
                             transfer_lanes=lanes, pipeline_depth=DEPTH)
    return run_job(records, lambda s: s.count_window(batch, timeout_s=TIMEOUT_S)
                   .apply(fn, name="inception"),
                   device_provider=device_provider, timeout=timeout)


def trailing_exclude(records: int = RECORDS) -> int:
    """``bench.py``'s exclusion: the last ``pipeline_depth`` windows."""
    return max(0, min(DEPTH * BATCH, records - 2 * BATCH))


# -- the open-loop pass ------------------------------------------------------

def service_function(model, *, lanes: int = LANES, **kw) -> ModelWindowFunction:
    """The bench's service operator (``make_service``, ``:1080``): a
    power-of-two ladder up to 16 (a sparse window ships its own records,
    not a padded 16), every rung warmed, depth 3."""
    ladder = BucketLadder.up_to(OL_BATCH)
    return ModelWindowFunction(model, policy=BucketPolicy(batch=ladder),
                               warmup_batches=tuple(ladder.sizes), outputs=("label", "score"),
                               transfer_lanes=lanes, pipeline_depth=OL_DEPTH, **kw)


def calibrate(model, records: typing.Sequence[TensorValue], *, device_provider=None,
              lanes: int = LANES, timeout: float = 600.0) -> typing.Tuple[float, typing.Any]:
    """Service capacity at the window size the paced pass fires (2), over
    ``CAL_WINDOWS`` windows, the last ``OL_DEPTH`` windows' flush burst
    left out (``:1100-1117``).  Returns ``(records/s, CellRun)``."""
    n = min(len(records), CAL_WINDOWS * CAL_WINDOW)
    run = run_job(records[:n], lambda s: s.count_window(CAL_WINDOW, timeout_s=5.0)
                  .apply(service_function(model, lanes=lanes), name="inception_cal"),
                  device_provider=device_provider, timeout=timeout)
    arrivals = run.arrivals
    cut = min(len(arrivals), max(2 * CAL_WINDOW, len(arrivals) - OL_DEPTH * CAL_WINDOW))
    span = arrivals[cut - 1] - arrivals[0]
    return ((cut - CAL_WINDOW) / span if span > 0 else float("nan")), run


def one_record_round_trip(model, record: TensorValue, *, device=None, repeats: int = 8) -> float:
    """Median seconds of one record alone through the runner: dispatch,
    H2D, compute, D2H, collected (the floor a budget must clear)."""
    runner = CompiledMethodRunner(model, policy=BucketPolicy(batch=BucketLadder.up_to(OL_BATCH)),
                                  device=device, output_names=("label", "score"))
    runner.open()
    try:
        runner.warmup((1,))
        times = []
        for _ in range(repeats):
            t0 = time.monotonic()
            runner.dispatch([record])
            runner.flush()
            times.append(time.monotonic() - t0)
    finally:
        runner.close()
    return float(np.median(times))


@dataclasses.dataclass
class OpenLoopRun:
    """One paced pass: results in sink order, ``(scheduled arrival,
    latency, stages)`` per result, the job's metrics and seconds."""

    results: typing.List[TensorValue]
    samples: typing.List[typing.Tuple[float, float, typing.Optional[dict]]]
    metrics: typing.Dict[str, typing.Any]
    seconds: float


def run_open_loop(model, records: typing.Sequence[TensorValue], rate: float, budget_s: float, *,
                  device_provider=None, lanes: int = LANES, seed: int = 0,
                  start_delay_s: float = START_DELAY_S, timeout: float = 600.0) -> OpenLoopRun:
    """``PacedSource(records, rate, poisson) -> count_window(16,
    latency_budget_s=budget_s) -> the service function (stage stamps on)
    -> a sink that reads each record's latency from its scheduled
    arrival``."""
    env = StreamExecutionEnvironment(parallelism=1)
    if device_provider is not None:
        env.set_device_provider(device_provider)
    results: typing.List[TensorValue] = []
    samples = []

    def sink(record):
        now = time.monotonic()
        results.append(record)
        sched = record.meta.get("sched_ts")
        if sched is not None:
            stages = record.meta.get("__stages__")
            if stages is not None and "__arrive_ts__" in record.meta:
                stages = {**stages, "arrive_ts": record.meta["__arrive_ts__"]}
            samples.append((sched, now - sched, stages))

    (env.from_source(PacedSource(records, rate, jitter="poisson", seed=seed,
                                 start_delay_s=start_delay_s), name="paced", parallelism=1)
     .count_window(OL_BATCH, latency_budget_s=budget_s)
     .apply(service_function(model, lanes=lanes, idle_flush_s=OL_IDLE_FLUSH_S,
                             stamp_stages=True), name="inception_ol")
     .sink_to_callable(sink))
    t0 = time.monotonic()
    job = env.execute(timeout=timeout)
    return OpenLoopRun(results, samples, job.metrics, time.monotonic() - t0)


def open_loop_summary(run: OpenLoopRun, rate: float) -> typing.Dict[str, typing.Any]:
    """The bench's reading of a paced pass (``:1210-1300``): latency
    percentiles from the scheduled arrival over the steady samples (those
    scheduled after the first result), the achieved rate from the first
    steady arrival to the last result, the median of each stage (ms), and
    how many windows fired at each size."""
    samples = run.samples
    first_emit = min(s + lat for s, lat, _ in samples)
    steady = [x for x in samples if x[0] >= first_emit] or list(samples)
    lat = np.array([lat for _, lat, _ in steady])
    stages = {k: [] for k in STAGES}
    batch_sizes: typing.Dict[int, int] = {}
    for s, latency, st in steady:
        if not st:
            continue
        arrive = st.get("arrive_ts", s)
        stages["queue_wait"].append(arrive - s)
        stages["trigger_hold"].append(st["t0"] - arrive)
        stages["lane_wait"].append(st["lane_wait_s"])
        stages["h2d_dispatch"].append(st["t_dispatched"] - st["t_lane_start"])
        stages["ready_wait"].append(st["t_fetch_start"] - st["t_dispatched"])
        stages["fetch"].append(st["t_done"] - st["t_fetch_start"])
        stages["emit"].append(s + latency - st["t_done"])
    for _, _, st in samples:
        if st:
            batch_sizes[st["batch_n"]] = batch_sizes.get(st["batch_n"], 0) + 1
    sched0 = min(s for s, _, _ in steady)
    span = max(s + latency for s, latency, _ in steady) - sched0
    return {
        "offered_rps": rate,
        "achieved_rps": len(steady) / span if span > 0 else float("nan"),
        "samples": len(samples), "steady_samples": len(steady),
        "p50_ms": float(np.percentile(lat, 50)) * 1e3,
        "p95_ms": float(np.percentile(lat, 95)) * 1e3,
        "p99_ms": float(np.percentile(lat, 99)) * 1e3,
        "stage_p50_ms": {k: float(np.median(v)) * 1e3 for k, v in stages.items() if v},
        # Records carry their batch's size: a window of n records counts n times.
        "windows_by_size": {n: c // n for n, c in sorted(batch_sizes.items())},
    }
