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
        [--local-batch-stats] [--checkpoint-root CHK --attempt A [--fail-at-step F]]

joins the cohort at ``tcp://127.0.0.1:P`` on the card (``cuda:R mod
cards``; ``--backend gloo`` lets ranks share one card), trains S steps
and writes its losses, step times, collective and K1 launch counts and
final variables to ``DIR/rank<R>.pt``.  ``--local-batch-stats`` is the
negative control of the cross-rank batch norm
(:func:`local_batch_statistics`).  With ``--checkpoint-root`` the rank is
a supervised worker (:func:`run_supervised_resnet`, as the reference's
``examples/multihost_dp_train.py`` has it): count-based checkpoints every
``SUPERVISED_EVERY_N_STEPS`` steps into ``CHK/rank<R>``; on attempt
A > 0 a restore from ``parallel.latest_common_checkpoint`` over every
rank's directory; and with ``--fail-at-step F`` the last rank exits with
``FAIL_EXIT_CODE`` on attempt 0 once its F-th step's result arrives.  A
``parallel.CohortSupervisor`` spawns such ranks and passes the attempt.

resnet-train as ONE job across the cohort (the reference's
``examples/multihost_dp_train.py:148-250``), with ``--plane-ports
P0,P1,...`` (one record-plane endpoint per process, beside the gloo or
NCCL port): :func:`cohort_rank` joins the cohort's record plane
(``env.set_distributed``) and runs ``from_collection(parallelism=W) ->
count_window(32 / W) -> DPTrainWindowFunction(parallelism=W)`` (one gang
subtask per process) ``-> loss probe -> sink_to_callable(parallelism=1)``
on process 0, whose sink receives every rank's losses over the record
plane.  The collection is reordered (:func:`interleave`) so that source
subtask w emits exactly rank w's :func:`partition`, so the job trains on the rows
the per-rank job trains on.  Count-based checkpoints every
``SUPERVISED_EVERY_N_STEPS`` steps go into one shared directory (a shard
per process); the attempt is the cohort's ``restart_epoch``, and an
attempt after the first restores from the newest checkpoint every
process holds.

widedeep-online across the cohort (:func:`run_widedeep_cohort`, the shape
of the reference's ``tests/_distributed_worker.py:193-232``): ``key_by(user)
-> OnlineTrainFunction(scope="key", mini_batch=32, steps_per_dispatch=16)
-> ExactlyOnceRecordFileSink`` with the keyed stage spread over the
cohort.  One such process: ``python3 -m
flink_tensorflow_tpu_torch.functions.train_cell --widedeep --rank R --world
N --plane-ports P0,...,PN-1 --out DIR --checkpoint-root CHK [--par K]
[--restore-id I] [--throttle S]``.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
import typing

import numpy as np

from flink_tensorflow_tpu_torch.core import functions as fn
from flink_tensorflow_tpu_torch.core.distributed import DistributedConfig
from flink_tensorflow_tpu_torch.core.environment import RestartStrategy, StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.core.faults import fired_counts
from flink_tensorflow_tpu_torch.functions.training_function import (
    DPTrainWindowFunction,
    OnlineTrainFunction,
)
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.parallel import collectives
from flink_tensorflow_tpu_torch.parallel.mesh import spans_processes
from flink_tensorflow_tpu_torch.parallel.optim import adam
from flink_tensorflow_tpu_torch.parallel.supervisor import latest_common_checkpoint
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
#: Events between the widedeep-online cell's count-based checkpoints.
WIDEDEEP_EVERY_N_RECORDS = 1024
#: The cohort keys a user as ``user * WIDEDEEP_KEY_STRIDE``.  A small
#: integer key is its own key group, and key groups are split into
#: contiguous ranges, so keyed by the user alone all 16 users fall to
#: subtask 0 at any keyed parallelism up to 8 (as in the reference) and no
#: training event crosses to another process; the stride spreads them
#: (users 8-15 to subtask 1 at parallelism 2).
WIDEDEEP_KEY_STRIDE = 8
#: The exit code of a supervised rank told to fail (``--fail-at-step``).
FAIL_EXIT_CODE = 17
#: Steps between a supervised rank's count-based checkpoints.
SUPERVISED_EVERY_N_STEPS = 2


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
               restore_id: typing.Optional[int] = None, tap=None,
               timeout: float = 900.0) -> CellRun:
    """The resnet-train job at global batch ``batch``; over a mesh that
    spans processes, ``records`` are this process's partition and its
    windows hold ``batch / processes`` of them.  With ``checkpoint_dir``,
    count-based checkpoints every ``every_n_records`` of this process's
    records, and with ``restore_id`` the job restores from that one.
    ``tap`` is a map on the step results ahead of the sink."""
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
    if tap is not None:
        stream = stream.map(tap, name="tap")
    results, arrivals = _timed_sink(stream)
    restore = {} if restore_id is None else dict(restore_from=checkpoint_dir,
                                                 restore_checkpoint_id=restore_id)
    t0 = time.monotonic()
    env.execute("resnet-train", timeout=timeout, **restore)
    return CellRun(results, arrivals, env, time.monotonic() - t0, kept[-1])


def interleave(records: typing.Sequence[TensorValue], global_batch: int,
               world: int) -> typing.List[TensorValue]:
    """``records`` reordered so that a source at parallelism ``world`` (its
    subtask w emits elements w, w + world, ...) gives subtask w exactly
    ``partition(records, global_batch, w, world)``."""
    parts = [partition(records, global_batch, w, world) for w in range(world)]
    return [parts[i % world][i // world] for i in range(len(records))]


class LossProbe(fn.MapFunction):
    """The map behind the cohort's gang: tags each step's result with the
    gang subtask that produced it, and runs ``tap`` on it first (a tap
    may end the process)."""

    def __init__(self, tap=None):
        self.tap = tap
        self.subtask = 0

    def open(self, ctx):
        self.subtask = ctx.subtask_index

    def map(self, record):
        if self.tap is not None:
            self.tap(record)
        return record.with_meta(gang_subtask=self.subtask)


def cohort_dirs(checkpoint_root: str, world: int) -> typing.List[str]:
    """The shard directory of each process under the cohort's shared
    checkpoint directory."""
    dist = DistributedConfig(0, world, ("127.0.0.1:0",) * world)
    return [dist.process_checkpoint_dir(checkpoint_root, w) for w in range(world)]


def run_cohort_resnet(mdef, schema, records, mesh, dist: DistributedConfig, *,
                      checkpoint_root: str, every_n_records: int, batch: int = RESNET_BATCH,
                      fail_at_step: typing.Optional[int] = None,
                      timeout: float = 900.0):
    """One process's attempt (``dist.restart_epoch``) of the resnet-train
    job across the cohort ``dist`` over ``mesh`` (see the module
    docstring): ``records`` are the whole stream.  An attempt after the
    first restores from the newest checkpoint every process holds.  With
    ``fail_at_step`` the last process exits at that step on attempt 0,
    once the checkpoints cut before it are on every process's disk.
    Returns the run (its results are what process 0's sink received,
    empty elsewhere; its function is this process's gang subtask) and the
    checkpoint id it restored from (None: a fresh start)."""
    world = dist.num_processes
    window = batch // world
    dirs = cohort_dirs(checkpoint_root, world)
    restore_id = latest_common_checkpoint(dirs) if dist.restart_epoch > 0 else None
    tap = None
    if fail_at_step is not None and dist.restart_epoch == 0 and dist.process_index == world - 1:
        tap = _exit_at_step(fail_at_step, dirs, (fail_at_step - 1) * window // every_n_records)
    kept: list = []
    env = StreamExecutionEnvironment(parallelism=1)
    env.set_mesh(mesh)
    env.set_distributed(dist)
    env.enable_checkpointing(checkpoint_root, every_n_records=every_n_records)
    stream = (env.from_collection(interleave(records, batch, world), parallelism=world)
              .count_window(window)
              .apply(_keeping(DPTrainWindowFunction, kept)(
                  mdef, adam(RESNET_LR), train_schema=schema, global_batch=batch),
                  name="dp_train", parallelism=world)
              .map(LossProbe(tap), name="loss_probe", parallelism=world))
    results, arrivals = [], []

    def sink(record):
        results.append(record)
        arrivals.append(time.monotonic())

    stream.sink_to_callable(sink, name="loss_agg", parallelism=1)
    restore = {} if restore_id is None else dict(restore_from=checkpoint_root,
                                                 restore_checkpoint_id=restore_id)
    t0 = time.monotonic()
    env.execute("resnet-train-cohort", timeout=timeout, **restore)
    return CellRun(results, arrivals, env, time.monotonic() - t0, kept[-1]), restore_id


def rank_checkpoint_dirs(checkpoint_root: str, world: int) -> typing.List[str]:
    """Each rank's checkpoint directory under ``checkpoint_root``."""
    return [os.path.join(checkpoint_root, f"rank{r}") for r in range(world)]


def _exit_at_step(step: int, checkpoint_dirs: typing.Sequence[str], checkpoint_id: int,
                  wait_s: float = 60.0):
    """A tap that ends the process, with ``FAIL_EXIT_CODE``, when the result
    of step ``step`` (or a later one) reaches it: a worker lost in mid-run,
    its collectives cut.  It first waits (up to ``wait_s``) until checkpoint
    ``checkpoint_id``, the last one cut before that step, is on disk in
    every rank's directory (the ranks share a host), so the failure lands
    after it whatever the host's speed."""

    def tap(record):
        if int(record["step"]) >= step:
            deadline = time.monotonic() + wait_s
            while ((latest_common_checkpoint(checkpoint_dirs) or 0) < checkpoint_id
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            os._exit(FAIL_EXIT_CODE)
        return record

    return tap


def run_supervised_resnet(mdef, schema, records, mesh, *, rank: int, world: int,
                          checkpoint_root: str, every_n_records: int,
                          batch: int = RESNET_BATCH, attempt: int = 0,
                          restore_id: typing.Optional[int] = None,
                          fail_at_step: typing.Optional[int] = None,
                          timeout: float = 900.0) -> typing.Tuple[CellRun, typing.Optional[int]]:
    """One rank's attempt of the resnet-train job across ``world``
    processes, as a ``CohortSupervisor`` worker: ``records`` are the whole
    stream (the rank takes its ``partition``), count-based checkpoints
    every ``every_n_records`` of its records go to its own directory under
    ``checkpoint_root``.  An attempt after the first restores from the
    newest checkpoint every rank holds (``latest_common_checkpoint``), or
    from ``restore_id`` where one is given.  With ``fail_at_step``, the
    last rank exits at that step on attempt 0, once the checkpoints cut
    before it are on every rank's disk.  Returns the run and the
    checkpoint id it restored from (None: a fresh start)."""
    dirs = rank_checkpoint_dirs(checkpoint_root, world)
    if restore_id is None and attempt > 0:
        restore_id = latest_common_checkpoint(dirs)
    tap = None
    if fail_at_step is not None and attempt == 0 and rank == world - 1:
        window = batch // world
        tap = _exit_at_step(fail_at_step, dirs, (fail_at_step - 1) * window // every_n_records)
    run = run_resnet(mdef, schema, partition(records, batch, rank, world), mesh, batch=batch,
                     checkpoint_dir=dirs[rank], every_n_records=every_n_records,
                     restore_id=restore_id, tap=tap, timeout=timeout)
    return run, restore_id


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
                 checkpoint_dir: typing.Optional[str] = None,
                 every_n_records: int = WIDEDEEP_EVERY_N_RECORDS,
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


def run_widedeep_cohort(mdef, schema, records, dist: typing.Optional[DistributedConfig], *,
                        out: str, checkpoint_root: typing.Optional[str] = None,
                        every_n_records: int = WIDEDEEP_EVERY_N_RECORDS, parallelism: int = 2,
                        restore_id: typing.Optional[int] = None, throttle_s: float = 0.0,
                        device_provider=None, timeout: float = 600.0,
                        report: typing.Optional[dict] = None,
                        config: typing.Optional[dict] = None,
                        telemetry: typing.Optional[dict] = None) -> float:
    """The widedeep-online cell keyed over a cohort (``dist``; None: one
    process at the same keyed parallelism, the reference run):
    ``from_collection`` (on process 0) ``-> key_by(user) ->
    OnlineTrainFunction(adam(1e-2), scope="key", mini_batch=32,
    steps_per_dispatch=16)`` at ``parallelism`` ``-> ExactlyOnceRecordFileSink(out)``
    (on process 0), with count-based checkpoints every ``every_n_records``
    events.  Each key trains its own model in keyed state, so its steps
    depend on its own events only.  The key is ``user *
    WIDEDEEP_KEY_STRIDE``, so the keyed edge crosses processes.  Returns the
    job's seconds; ``report``, when given, receives the job's metric
    report.  ``config`` holds more ``JobConfig`` fields (tracing, say);
    ``telemetry``, when given, receives what the cohort's telemetry plane
    learned: process 0's collector counts and the size of one metric push
    frame, and the tracer's cohort block."""
    from flink_tensorflow_tpu_torch.io.files import ExactlyOnceRecordFileSink

    env = StreamExecutionEnvironment(parallelism=1)
    env.source_throttle_s = throttle_s
    if config:
        env.configure(**config)
    if dist is not None:
        env.set_distributed(dist)
    if device_provider is not None:
        env.set_device_provider(device_provider)
    if checkpoint_root is not None:
        env.enable_checkpointing(checkpoint_root, every_n_records=every_n_records)
    (env.from_collection(records, parallelism=1)
     .key_by(lambda r: r.meta["user"] * WIDEDEEP_KEY_STRIDE)
     .process(OnlineTrainFunction(mdef, adam(WIDEDEEP_LR), train_schema=schema, scope="key",
                                  mini_batch=MINI_BATCH, steps_per_dispatch=STEPS_PER_DISPATCH),
              name="keyed_train", parallelism=parallelism)
     .add_sink(ExactlyOnceRecordFileSink(out), name="sink", parallelism=1))
    restore = {} if restore_id is None else dict(restore_from=checkpoint_root,
                                                 restore_checkpoint_id=restore_id)
    t0 = time.monotonic()
    handle = env.execute_async("widedeep-cohort", **restore)
    handle.wait(timeout)
    seconds = time.monotonic() - t0
    if report is not None:
        report.update(env.metric_registry.report())
    if telemetry is not None:
        import pickle

        executor = handle.executor
        collector = getattr(executor, "cohort_collector", None)
        if collector is not None:
            telemetry.update(pushes=collector.pushes, peers_reporting=collector.peers_reporting)
        # One metric push as it rides the control channel.
        telemetry["push_bytes"] = len(pickle.dumps(
            ("metrics_push", 0, 1, env.metric_registry.export_state()), protocol=5))
        if executor.tracer is not None:
            telemetry["cohort_meta"] = executor.tracer.cohort_meta
            telemetry["trace_path"] = executor.trace_path
    return seconds


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
    shared = collectives.cross_replica_moments
    collectives.cross_replica_moments = lambda group, size: contextlib.nullcontext()
    try:
        yield
    finally:
        collectives.cross_replica_moments = shared


def resnet_rank(rank: int, world: int, port: int, steps: int, out: str,
                backend: typing.Optional[str] = None, local_batch_stats: bool = False,
                checkpoint_root: typing.Optional[str] = None, attempt: int = 0,
                fail_at_step: typing.Optional[int] = None,
                plane_ports: typing.Optional[typing.Sequence[int]] = None) -> None:
    """One process of the resnet-train cell across ``world`` processes,
    on its card (see the module docstring); with ``plane_ports`` the
    cohort runs it as one job (:func:`run_cohort_resnet`)."""
    import torch

    from flink_tensorflow_tpu_torch.ops.batch_norm import batch_norm_train
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
        restored = None
        with local_batch_statistics() if local_batch_stats else contextlib.nullcontext():
            if plane_ports is not None:
                dist = DistributedConfig(rank, world,
                                         tuple(f"127.0.0.1:{p}" for p in plane_ports),
                                         restart_epoch=attempt)
                run, restored = run_cohort_resnet(
                    mdef, schema, records, mesh, dist, checkpoint_root=checkpoint_root,
                    every_n_records=SUPERVISED_EVERY_N_STEPS * RESNET_BATCH // world,
                    fail_at_step=fail_at_step)
            elif checkpoint_root is None:
                run = run_resnet(mdef, schema, partition(records, RESNET_BATCH, rank, world),
                                 mesh)
            else:
                run, restored = run_supervised_resnet(
                    mdef, schema, records, mesh, rank=rank, world=world,
                    checkpoint_root=checkpoint_root,
                    every_n_records=SUPERVISED_EVERY_N_STEPS * RESNET_BATCH // world,
                    attempt=attempt,
                    fail_at_step=fail_at_step)
        torch.save({"losses": [float(r["loss"]) for r in run.results],
                    "steps": [int(r["step"]) for r in run.results],
                    "arrivals": list(run.arrivals), "seconds": run.seconds,
                    "device": str(mesh.device), "calls": dict(collectives.calls),
                    "k1_launches": flash_attention.launches,
                    "bn_launches": batch_norm_train.launches,
                    "attempt": attempt, "restored_checkpoint": restored,
                    "gang_subtasks": [int(r.meta.get("gang_subtask", rank))
                                      for r in run.results],
                    "variables": run.function.current_params()},
                   os.path.join(out, f"rank{rank}.pt"))
    finally:
        multihost.shutdown()


def widedeep_rank(rank: int, world: int, plane_ports: typing.Sequence[int], out: str,
                  checkpoint_root: str, *, parallelism: int, records: int = WIDEDEEP_RECORDS,
                  every_n_records: int = WIDEDEEP_EVERY_N_RECORDS,
                  restore_id: typing.Optional[int] = None, throttle_s: float = 0.0,
                  telemetry_interval_s: typing.Optional[float] = None,
                  trace_path: typing.Optional[str] = None) -> None:
    """One process of the widedeep-online cell keyed over ``world``
    processes (:func:`run_widedeep_cohort`), its model subtasks on the card.
    Writes ``seconds-<rank>.json`` under ``checkpoint_root``: the job's
    seconds, its edge reconnects, the faults that fired
    (``FLINK_TPU_FAULTS`` reaches the job through its config), the
    records its keyed subtasks took in, and what the telemetry plane
    learned.  ``telemetry_interval_s`` sets the cohort's telemetry cadence
    (None: ``DistributedConfig``'s default); ``trace_path`` traces the job
    (each process writes ``<trace>.proc<k>.json``)."""
    import json

    import torch

    # f32 products stay f32, as the cell runs them in one process.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mdef, schema, values = widedeep_cell(records=records)
    extra = {} if telemetry_interval_s is None else {"telemetry_interval_s": telemetry_interval_s}
    dist = DistributedConfig(rank, world, tuple(f"127.0.0.1:{p}" for p in plane_ports),
                             connect_timeout_s=60.0, **extra)
    report: typing.Dict[str, typing.Any] = {}
    telemetry: typing.Dict[str, typing.Any] = {}
    seconds = run_widedeep_cohort(
        mdef, schema, values, dist, out=out, checkpoint_root=checkpoint_root,
        every_n_records=every_n_records, parallelism=parallelism, restore_id=restore_id,
        throttle_s=throttle_s, report=report, telemetry=telemetry,
        config={"trace": True, "trace_path": trace_path} if trace_path else None)
    with open(os.path.join(checkpoint_root, f"seconds-{rank}.json"), "w") as f:
        json.dump({"rank": rank, "world": world, "seconds": seconds,
                   "edge_reconnects": report.get("recovery.edge_reconnects", {}).get("count", 0),
                   "faults": fired_counts(report),
                   "keyed_records_in": {k: v["count"] for k, v in report.items()
                                        if k.startswith("keyed_train.")
                                        and k.endswith(".records_in")},
                   "sanitizer_violations": report.get("sanitizer.violations"),
                   "telemetry": telemetry}, f)


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description=resnet_rank.__doc__)
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--world", type=int, required=True)
    parser.add_argument("--port", type=int, default=0, help="the gloo or NCCL port")
    parser.add_argument("--steps", type=int, default=RESNET_STEPS)
    parser.add_argument("--out", required=True)
    parser.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    parser.add_argument("--local-batch-stats", action="store_true",
                        help="batch norm's moments over each rank's rows (the control)")
    parser.add_argument("--checkpoint-root", default=None,
                        help="a supervised worker: per-rank checkpoints under this directory")
    parser.add_argument("--attempt", type=int, default=0,
                        help="the supervisor's attempt; after the first, restore")
    parser.add_argument("--fail-at-step", type=int, default=None,
                        help="on attempt 0 the last rank exits at this step")
    parser.add_argument("--plane-ports", default=None,
                        help="comma-separated record-plane ports, one per process: "
                             "the cohort runs one job")
    parser.add_argument("--widedeep", action="store_true",
                        help="the widedeep-online cell keyed over the cohort")
    parser.add_argument("--par", type=int, default=2, help="--widedeep: keyed parallelism")
    parser.add_argument("--records", type=int, default=WIDEDEEP_RECORDS)
    parser.add_argument("--every", type=int, default=WIDEDEEP_EVERY_N_RECORDS)
    parser.add_argument("--restore-id", type=int, default=None)
    parser.add_argument("--throttle", type=float, default=0.0)
    parser.add_argument("--telemetry-interval", type=float, default=None,
                        help="--widedeep: the cohort's telemetry cadence in seconds")
    parser.add_argument("--trace", default=None, help="--widedeep: trace to this path")
    args = parser.parse_args()
    plane = None if args.plane_ports is None else [int(p) for p in args.plane_ports.split(",")]
    if args.widedeep:
        widedeep_rank(args.rank, args.world, plane, args.out, args.checkpoint_root,
                      parallelism=args.par, records=args.records, every_n_records=args.every,
                      restore_id=args.restore_id, throttle_s=args.throttle,
                      telemetry_interval_s=args.telemetry_interval, trace_path=args.trace)
    else:
        resnet_rank(args.rank, args.world, args.port, args.steps, args.out, args.backend,
                    args.local_batch_stats, args.checkpoint_root, args.attempt,
                    args.fail_at_step, plane)
