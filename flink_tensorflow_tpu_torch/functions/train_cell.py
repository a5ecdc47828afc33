"""The two training cells the port is measured on, built as the JAX
package's benches build them.

- **resnet-train** (``bench.py:bench_resnet``, ``:1940-2015``, one chip):
  ResNet-50 at full width (stages ``(3, 4, 6, 3)``, width 64, 224x224x3
  uint8 records normalised on the device, 1000 classes, bf16), 768
  records from ``np.random.RandomState(0)`` (``label = i % 1000``, pixels
  ``rand * 77 + label / 1000 * 178``), through ``from_collection ->
  count_window(32) -> DPTrainWindowFunction(adam(1e-3), global_batch=32)``
  on a ``{"data": 1}`` mesh: 24 steps.
- **widedeep-online** (``bench.py:bench_widedeep``, ``:1853-1933``):
  Wide&Deep with ``hash_buckets=1000, embed_dim=8, num_cat_slots=4,
  num_dense=8, num_wide=16, hidden=(32, 16)``, 8192 events from
  ``RandomState(0)`` over 16 users (``label = wide[user % 16] > 0.5``),
  through ``key_by(user) -> OnlineTrainFunction(adam(1e-2),
  mini_batch=32, steps_per_dispatch=16)`` at parallelism 1.

Weights come from the port's initialiser (seed 0).  Each ``run_*`` runs
the job once and returns its sink's records, their arrival times, the
metric registry, the job's seconds and the function instance that ran
last (its final TrainState; the host's after ``close``).

resnet-train across processes (the reference's manual multi-process
placement): each of N processes runs the same job on its rows of every
global batch of 32 (``partition``), with ``count_window(32 / N)`` into
the gang over a ``{"data": N}`` mesh.  One such process:

    python3 -m flink_tensorflow_tpu_torch.functions.train_cell \
        --rank R --world N --port P --steps S --out DIR [--backend gloo] \
        [--local-batch-stats]

joins the cohort at ``tcp://127.0.0.1:P`` on the card (``cuda:R mod
cards``; ``--backend gloo`` lets ranks share one card), trains S steps
and writes its losses, step times, collective and K1 launch counts and
final variables to ``DIR/rank<R>.pt``.  ``--local-batch-stats`` is the
negative control of the cross-rank batch norm
(:func:`local_batch_statistics`).
"""

from __future__ import annotations

import contextlib
import math
import time
import typing

import numpy as np

from flink_tensorflow_tpu_torch.core.environment import RestartStrategy, StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.functions.training_function import (
    DPTrainWindowFunction,
    OnlineTrainFunction,
)
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.parallel import collectives
from flink_tensorflow_tpu_torch.parallel.mesh import spans_processes
from flink_tensorflow_tpu_torch.parallel.optim import adam
from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, spec
from flink_tensorflow_tpu_torch.tensors.value import TensorValue

RESNET_BATCH = 32
RESNET_STEPS = 24
RESNET_LR = 1e-3
WIDEDEEP = dict(hash_buckets=1000, embed_dim=8, num_cat_slots=4, num_dense=8, num_wide=16,
                hidden=(32, 16))
WIDEDEEP_RECORDS = 8192
WIDEDEEP_USERS = 16
MINI_BATCH = 32
STEPS_PER_DISPATCH = 16
WIDEDEEP_LR = 1e-2


class CellRun(typing.NamedTuple):
    results: typing.List[TensorValue]
    arrivals: typing.List[float]
    env: StreamExecutionEnvironment
    seconds: float
    function: typing.Any


def _keeping(cls, kept: list):
    """``cls`` whose per-subtask clones are appended to ``kept``."""

    class Kept(cls):
        def clone(self):
            dup = super().clone()
            kept.append(dup)
            return dup

    return Kept


def _timed_sink(env_stream):
    results: typing.List[TensorValue] = []
    arrivals: typing.List[float] = []

    def sink(record):
        results.append(record)
        arrivals.append(time.monotonic())

    env_stream.sink_to_callable(sink)
    return results, arrivals


def resnet_cell(*, records: int = RESNET_BATCH * RESNET_STEPS, image_size: int = 224,
                num_classes: int = 1000, width: int = 64,
                stage_sizes: typing.Sequence[int] = (3, 4, 6, 3)):
    """``(model_def, train_schema, records)`` of the resnet-train cell
    (smaller sizes for the CPU tests)."""
    mdef = get_model_def("resnet50", num_classes=num_classes, image_size=image_size, width=width,
                         stage_sizes=tuple(stage_sizes), uint8_input=True)
    rng = np.random.RandomState(0)
    values = []
    for i in range(records):
        label = i % num_classes
        img = rng.rand(image_size, image_size, 3) * 77 + (label / num_classes) * 178
        values.append(TensorValue({"image": img.astype(np.uint8), "label": np.int32(label)}))
    schema = RecordSchema({"image": spec((image_size, image_size, 3), np.uint8),
                           "label": spec((), np.int32)})
    return mdef, schema, values


def partition(records: typing.Sequence[TensorValue], global_batch: int, rank: int,
              world: int) -> typing.List[TensorValue]:
    """Process ``rank``'s rows of every global batch: the ``rank``-th
    block of ``global_batch / world`` records of each, in order (the
    reference's dim-0 split over ``data``)."""
    local = global_batch // world
    return [r for i, r in enumerate(records) if (i % global_batch) // local == rank]


def run_resnet(mdef, schema, records, mesh, *, batch: int = RESNET_BATCH,
               checkpoint_dir: typing.Optional[str] = None, every_n_records: int = RESNET_BATCH,
               restore_id: typing.Optional[int] = None, timeout: float = 900.0) -> CellRun:
    """The resnet-train job at global batch ``batch``; over a mesh that
    spans processes, ``records`` are this process's partition and its
    windows hold ``batch / processes`` of them.  With ``checkpoint_dir``,
    count-based checkpoints every ``every_n_records`` of this process's
    records, and with ``restore_id`` the job restores from that one."""
    kept: list = []
    env = StreamExecutionEnvironment(parallelism=1)
    env.set_mesh(mesh)
    if checkpoint_dir is not None:
        env.enable_checkpointing(checkpoint_dir, every_n_records=every_n_records)
    window = batch // mesh.size if spans_processes(mesh) else batch
    stream = (env.from_collection(records, parallelism=1).count_window(window)
              .apply(_keeping(DPTrainWindowFunction, kept)(
                  mdef, adam(RESNET_LR), train_schema=schema, global_batch=batch),
                  name="dp_train"))
    results, arrivals = _timed_sink(stream)
    restore = {} if restore_id is None else dict(restore_from=checkpoint_dir,
                                                 restore_checkpoint_id=restore_id)
    t0 = time.monotonic()
    env.execute("resnet-train", timeout=timeout, **restore)
    return CellRun(results, arrivals, env, time.monotonic() - t0, kept[-1])


def widedeep_cell(*, records: int = WIDEDEEP_RECORDS):
    """``(model_def, train_schema, records)`` of the widedeep-online cell."""
    cfg = WIDEDEEP
    mdef = get_model_def("widedeep", **cfg)
    schema = RecordSchema({
        "wide": spec((cfg["num_wide"],)),
        "dense": spec((cfg["num_dense"],)),
        "cat": spec((cfg["num_cat_slots"],), np.int32),
        "label": spec((), np.int32),
    })
    rng = np.random.RandomState(0)
    values = []
    for _ in range(records):
        user = int(rng.randint(WIDEDEEP_USERS))
        x_wide = rng.rand(cfg["num_wide"]).astype(np.float32)
        values.append(TensorValue({
            "wide": x_wide,
            "dense": rng.rand(cfg["num_dense"]).astype(np.float32),
            "cat": rng.randint(0, cfg["hash_buckets"], (cfg["num_cat_slots"],)).astype(np.int32),
            "label": np.int32(x_wide[user % cfg["num_wide"]] > 0.5),
        }, meta={"user": user}))
    return mdef, schema, values


def expected_steps(records: typing.Sequence[TensorValue], mini_batch: int = MINI_BATCH) -> int:
    """Steps of the widedeep job: each user's records in mini-batches,
    the last one partial (``sum over users of ceil(n_user / mini_batch)``)."""
    counts: typing.Dict[typing.Any, int] = {}
    for r in records:
        counts[r.meta["user"]] = counts.get(r.meta["user"], 0) + 1
    return sum(math.ceil(n / mini_batch) for n in counts.values())


def run_widedeep(mdef, schema, records, *, device_provider=None,
                 checkpoint_dir: typing.Optional[str] = None, every_n_records: int = 1024,
                 tap=None, max_restarts: int = 0, throttle_s: float = 0.0,
                 timeout: float = 600.0) -> CellRun:
    """The widedeep job; with ``checkpoint_dir``, count-based checkpoints
    every ``every_n_records`` and ``RestartStrategy(max_restarts)``;
    ``tap`` is a map on the input events (e.g. one that raises once);
    ``throttle_s`` paces the source (so a crash finds checkpoints done)."""
    kept: list = []
    env = StreamExecutionEnvironment(parallelism=1)
    env.source_throttle_s = throttle_s
    if device_provider is not None:
        env.set_device_provider(device_provider)
    if checkpoint_dir is not None:
        env.enable_checkpointing(checkpoint_dir, every_n_records=every_n_records)
    stream = env.from_collection(records, parallelism=1)
    if tap is not None:
        stream = stream.map(tap, name="tap", parallelism=1)
    stream = (stream.key_by(lambda r: r.meta["user"])
              .process(_keeping(OnlineTrainFunction, kept)(
                  mdef, adam(WIDEDEEP_LR), train_schema=schema, mini_batch=MINI_BATCH,
                  steps_per_dispatch=STEPS_PER_DISPATCH), name="online_train"))
    results, arrivals = _timed_sink(stream)
    restart = RestartStrategy(max_restarts=max_restarts) if checkpoint_dir is not None else None
    t0 = time.monotonic()
    env.execute("widedeep-online", timeout=timeout, restart_strategy=restart)
    return CellRun(results, arrivals, env, time.monotonic() - t0, kept[-1])


def rate(arrivals: typing.Sequence[float], per_item: float = 1.0) -> float:
    """Items per second over the arrivals after the first (the first
    step carries the first call's one-time costs)."""
    if len(arrivals) < 2 or arrivals[-1] <= arrivals[0]:
        return float("nan")
    return (len(arrivals) - 1) * per_item / (arrivals[-1] - arrivals[0])


@contextlib.contextmanager
def local_batch_statistics():
    """While active, train-mode batch norm takes its moments over each
    rank's own rows (the gradients are still averaged): the control that
    shows a check can tell the global batch statistics from local ones."""
    shared = collectives.batch_moments
    collectives.batch_moments = lambda mean, mean_sq: (mean, mean_sq)
    try:
        yield
    finally:
        collectives.batch_moments = shared


def resnet_rank(rank: int, world: int, port: int, steps: int, out: str,
                backend: typing.Optional[str] = None, local_batch_stats: bool = False) -> None:
    """One process of the resnet-train cell across ``world`` processes,
    on its card (see the module docstring)."""
    import os

    import torch

    from flink_tensorflow_tpu_torch.ops.flash_attention import flash_attention
    from flink_tensorflow_tpu_torch.parallel import multihost
    from flink_tensorflow_tpu_torch.parallel.mesh import make_mesh

    # f32 products stay f32, as the single-process cell runs them.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(f"127.0.0.1:{port}", world, rank, backend=backend)
    try:
        mesh = make_mesh({"data": world})
        mdef, schema, records = resnet_cell(records=RESNET_BATCH * steps)
        collectives.calls.clear()
        with local_batch_statistics() if local_batch_stats else contextlib.nullcontext():
            run = run_resnet(mdef, schema, partition(records, RESNET_BATCH, rank, world), mesh)
        torch.save({"losses": [float(r["loss"]) for r in run.results],
                    "steps": [int(r["step"]) for r in run.results],
                    "arrivals": list(run.arrivals), "seconds": run.seconds,
                    "device": str(mesh.device), "calls": dict(collectives.calls),
                    "k1_launches": flash_attention.launches,
                    "variables": run.function.current_params()},
                   os.path.join(out, f"rank{rank}.pt"))
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description=resnet_rank.__doc__)
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--world", type=int, required=True)
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--steps", type=int, default=RESNET_STEPS)
    parser.add_argument("--out", required=True)
    parser.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    parser.add_argument("--local-batch-stats", action="store_true",
                        help="batch norm's moments over each rank's rows (the control)")
    args = parser.parse_args()
    resnet_rank(args.rank, args.world, args.port, args.steps, args.out, args.backend,
                args.local_batch_stats)
