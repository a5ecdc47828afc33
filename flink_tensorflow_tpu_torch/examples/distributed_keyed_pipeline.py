"""A keyed pipeline across processes, as one job.

Port of ``examples/distributed_keyed_pipeline.py``: every process of a
cohort runs this script with its own ``--index``; the same job graph is
built everywhere, subtask ``i`` runs on process ``i % num_processes``,
and keyed edges that cross processes ride the record plane.  Count-based
aligned checkpoints cross the same channels, and the two-phase-commit
file sink commits only when a checkpoint is durable on every process.
No model runs here, so no device is touched.

Run (two terminals, or a ``CohortSupervisor`` spawning both):

    python -m flink_tensorflow_tpu_torch.examples.distributed_keyed_pipeline --index 0 --ports 7711,7712
    python -m flink_tensorflow_tpu_torch.examples.distributed_keyed_pipeline --index 1 --ports 7711,7712

Process 0 hosts the source, keyed-stats subtask 0 and the sink; process 1
hosts keyed-stats subtask 1.  Process 0 prints the committed per-key
stats.
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np

from flink_tensorflow_tpu_torch import DistributedConfig, StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.core import functions as fn
from flink_tensorflow_tpu_torch.core.state import StateDescriptor
from flink_tensorflow_tpu_torch.io.files import ExactlyOnceRecordFileSink, read_committed
from flink_tensorflow_tpu_torch.tensors.value import TensorValue

NUM_KEYS = 8

RUNNING = StateDescriptor("running", default_factory=lambda: (0, 0.0))


class KeyedStats(fn.ProcessFunction):
    """Per-key running count and mean in keyed state."""

    def process_element(self, value, ctx, out):
        state = ctx.state(RUNNING)
        n, total = state.value()
        n, total = n + 1, total + float(value["x"])
        state.update((n, total))
        out.collect(TensorValue({"mean": np.float32(total / n)},
                                {"key": int(ctx.current_key), "n": n}))


def build(env: StreamExecutionEnvironment, out_dir: str, n_records: int):
    rng = np.random.RandomState(0)
    records = [TensorValue({"x": np.float32(rng.rand())}, {"i": i, "k": i % NUM_KEYS})
               for i in range(n_records)]
    (
        env.from_collection(records, parallelism=1)
        .key_by(lambda r: r.meta["k"])
        .process(KeyedStats(), name="keyed_stats", parallelism=2)
        .add_sink(ExactlyOnceRecordFileSink(out_dir), name="sink", parallelism=1)
    )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--index", type=int, required=True)
    p.add_argument("--ports", required=True,
                   help="comma-separated record-plane ports, one per process")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--records", type=int, default=256)
    p.add_argument("--every", type=int, default=64, help="checkpoint every N source records")
    p.add_argument("--out", default=None)
    p.add_argument("--chk", default=None)
    args = p.parse_args(argv)

    ports = [int(x) for x in args.ports.split(",")]
    out_dir = args.out or tempfile.mkdtemp(prefix="dist-keyed-out-")
    chk_dir = args.chk or tempfile.mkdtemp(prefix=f"dist-keyed-chk{args.index}-")

    env = StreamExecutionEnvironment(parallelism=1)
    env.set_distributed(DistributedConfig(args.index, len(ports),
                                          tuple(f"{args.host}:{pt}" for pt in ports)))
    env.enable_checkpointing(chk_dir, every_n_records=args.every)
    build(env, out_dir, args.records)
    env.execute("distributed-keyed-pipeline", timeout=300)

    if args.index == 0:
        committed = read_committed(out_dir)
        finals = {}
        for r in committed:
            finals[r.meta["key"]] = (r.meta["n"], float(r["mean"]))
        print(f"committed records: {len(committed)}")
        for k in sorted(finals):
            n, mean = finals[k]
            print(f"  key {k}: n={n} mean={mean:.4f}")
    return out_dir


if __name__ == "__main__":
    main()
