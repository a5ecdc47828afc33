"""One process of a port cohort on the CPU, for the record-plane tests
(``tests/test_torch_distributed_plane.py``).

    python tests/_torch_distributed_worker.py --index I --ports P0,P1,... \\
        --out DIR [--chk CHK] [--job J] [--par K] ...

imports torch and the port only (``CUDA_VISIBLE_DEVICES`` empty) and runs
one process of a job built identically on every process, with
``env.set_distributed``: subtask i of every operator runs on process
i % N, and keyed edges between processes ride the record plane.  The jobs
are those of the reference's ``tests/_distributed_worker.py``:

- ``keyed_sum``: ``from_collection(range(n)) -> key_by(x % 4) -> KeyedSum
  -> ExactlyOnceRecordFileSink(--out)``, one ``(key, i, running sum)`` per
  record;
- ``keyed_train``: per-key Wide&Deep SGD (``OnlineTrainFunction(scope=
  "key", mini_batch=2)``) into the 2PC sink;
- ``gang``: the resnet-train cell at a tiny size across a gloo group of
  N (``--gloo-port``): the per-rank job (``train_cell.run_resnet`` on
  each rank's ``partition``), then the same steps as one job over the
  record plane (``train_cell.run_cohort_resnet``); the rank writes both
  runs to ``DIR/rank<I>.pt``.

``--die-after-checkpoint K`` SIGKILLs this process once checkpoint K is in
its own shard; ``--restore-id`` restores (``-2``: the highest complete
cohort checkpoint, if any).
"""

import argparse
import os
import signal
import sys
import threading
import time

os.environ["CUDA_VISIBLE_DEVICES"] = ""

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from flink_tensorflow_tpu_torch.core import functions as fn  # noqa: E402
from flink_tensorflow_tpu_torch.core.distributed import DistributedConfig  # noqa: E402
from flink_tensorflow_tpu_torch.core.environment import StreamExecutionEnvironment  # noqa: E402
from flink_tensorflow_tpu_torch.core.state import StateDescriptor  # noqa: E402
from flink_tensorflow_tpu_torch.io.files import ExactlyOnceRecordFileSink  # noqa: E402
from flink_tensorflow_tpu_torch.tensors.value import TensorValue  # noqa: E402

SUM = StateDescriptor("sum", default_factory=lambda: 0)
NUM_KEYS = 4
TRAIN_CFG = dict(hash_buckets=50, embed_dim=2, num_cat_slots=2, num_dense=4, num_wide=4,
                 hidden=(8,))
GANG_CFG = dict(num_classes=4, image_size=32, width=4, stage_sizes=(1, 1), uint8_input=True)


class KeyedSum(fn.ProcessFunction):
    """Running per-key sum in keyed state; emits (key, i, sum) per record."""

    def process_element(self, value, ctx, out):
        state = ctx.state(SUM)
        cur = state.value() + int(value)
        state.update(cur)
        out.collect(TensorValue({"v": np.int64(cur)},
                                {"key": int(ctx.current_key), "i": int(value)}))


def train_records(n):
    rng = np.random.RandomState(7)
    records = []
    for i in range(n):
        x_wide = rng.rand(TRAIN_CFG["num_wide"]).astype(np.float32)
        records.append(TensorValue({
            "wide": x_wide,
            "dense": rng.rand(TRAIN_CFG["num_dense"]).astype(np.float32),
            "cat": rng.randint(0, TRAIN_CFG["hash_buckets"],
                               (TRAIN_CFG["num_cat_slots"],)).astype(np.int32),
            "label": np.int32(x_wide[0] > 0.5),
        }, meta={"user": i % NUM_KEYS}))
    return records


def keyed_train_stage(env, args):
    from flink_tensorflow_tpu_torch.functions.training_function import OnlineTrainFunction
    from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
    from flink_tensorflow_tpu_torch.parallel.optim import sgd
    from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, spec

    mdef = get_model_def("widedeep", **TRAIN_CFG)
    schema = RecordSchema({"wide": spec((TRAIN_CFG["num_wide"],)),
                           "dense": spec((TRAIN_CFG["num_dense"],)),
                           "cat": spec((TRAIN_CFG["num_cat_slots"],), np.int32),
                           "label": spec((), np.int32)})
    env.set_device_provider(lambda task, index: "cpu")
    return (env.from_collection(train_records(args.n), parallelism=1)
            .key_by(lambda r: r.meta["user"])
            .process(OnlineTrainFunction(mdef, sgd(0.05), train_schema=schema, scope="key",
                                         mini_batch=2),
                     name="keyed_train", parallelism=args.par))


def gang(args, dist):
    from flink_tensorflow_tpu_torch.functions import train_cell
    from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
    from flink_tensorflow_tpu_torch.parallel import multihost
    from flink_tensorflow_tpu_torch.parallel.mesh import make_mesh
    from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, spec

    world, rank = dist.num_processes, dist.process_index
    multihost.initialize(f"127.0.0.1:{args.gloo_port}", world, rank, device="cpu",
                         timeout_s=60)
    try:
        mesh = make_mesh({"data": world}, devices=["cpu"])
        mdef = get_model_def("resnet50", **GANG_CFG)
        rng = np.random.RandomState(5)
        records = [TensorValue({"image": rng.randint(0, 256, (32, 32, 3)).astype(np.uint8),
                                "label": np.int32(i % 4)}, {"id": i}) for i in range(args.n)]
        schema = RecordSchema({"image": spec((32, 32, 3), np.uint8),
                               "label": spec((), np.int32)})
        batch = 8
        per_rank = train_cell.run_resnet(mdef, schema,
                                         train_cell.partition(records, batch, rank, world),
                                         mesh, batch=batch, timeout=120)
        cohort, _ = train_cell.run_cohort_resnet(
            mdef, schema, records, mesh, dist, checkpoint_root=args.chk,
            every_n_records=args.every, batch=batch, timeout=120)
        os.makedirs(args.out, exist_ok=True)
        torch.save({
            "per_rank": [(int(r["step"]), float(r["loss"])) for r in per_rank.results],
            "per_rank_variables": per_rank.function.current_params(),
            "cohort": [(int(r.meta["gang_subtask"]), int(r["step"]), float(r["loss"]))
                       for r in cohort.results],
            "cohort_variables": cohort.function.current_params()},
            os.path.join(args.out, f"rank{rank}.pt"))
    finally:
        multihost.shutdown()


def arm_self_kill(args):
    target = os.path.join(args.chk, f"proc-{args.index:05d}",
                          f"chk-{args.die_after_checkpoint:06d}")

    def watch():
        while not os.path.isdir(target):
            time.sleep(0.01)
        os.kill(os.getpid(), signal.SIGKILL)

    threading.Thread(target=watch, daemon=True).start()


def restore_kwargs(args):
    if args.restore_id >= 0:
        return dict(restore_from=args.chk, restore_checkpoint_id=args.restore_id)
    if args.restore_id == -2 and args.chk:
        from flink_tensorflow_tpu_torch.checkpoint.store import select_cohort_checkpoint

        try:
            cid, _ = select_cohort_checkpoint(args.chk)
        except (FileNotFoundError, ValueError):
            return {}
        return dict(restore_from=args.chk, restore_checkpoint_id=cid)
    return {}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--index", type=int, required=True)
    p.add_argument("--ports", required=True, help="comma-separated, one per process")
    p.add_argument("--out", required=True)
    p.add_argument("--chk", default=None)
    p.add_argument("--n", type=int, default=80)
    p.add_argument("--every", type=int, default=20)
    p.add_argument("--restore-id", type=int, default=-1)
    p.add_argument("--die-after-checkpoint", type=int, default=0)
    p.add_argument("--throttle", type=float, default=0.0)
    p.add_argument("--job", default="keyed_sum", choices=("keyed_sum", "keyed_train", "gang"))
    p.add_argument("--par", type=int, default=2)
    p.add_argument("--epoch", type=int, default=0)
    p.add_argument("--gloo-port", type=int, default=0)
    args = p.parse_args()

    ports = [int(x) for x in args.ports.split(",")]
    dist = DistributedConfig(args.index, len(ports), tuple(f"127.0.0.1:{pt}" for pt in ports),
                             connect_timeout_s=30.0, restart_epoch=args.epoch)
    if args.job == "gang":
        gang(args, dist)
        return
    env = StreamExecutionEnvironment(parallelism=1)
    env.configure(source_throttle_s=args.throttle)
    env.set_distributed(dist)
    if args.chk:
        env.enable_checkpointing(args.chk, every_n_records=args.every)
    if args.die_after_checkpoint > 0 and args.chk:
        arm_self_kill(args)
    if args.job == "keyed_train":
        stage = keyed_train_stage(env, args)
    else:
        stage = (env.from_collection(list(range(args.n)), parallelism=1)
                 .key_by(lambda x: x % NUM_KEYS)
                 .process(KeyedSum(), name="keyed_sum", parallelism=args.par))
    stage.add_sink(ExactlyOnceRecordFileSink(args.out), name="sink", parallelism=1)
    env.execute("dist-plane", timeout=180, **restore_kwargs(args))


if __name__ == "__main__":
    main()
