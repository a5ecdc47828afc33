"""Multi-process data-parallel training over the record plane.

Port of ``examples/multihost_dp_train.py``.  One job graph, built the
same way in every process:

- a ``CohortSupervisor`` (parent mode) spawns N identical worker
  processes and restarts the whole cohort from the newest checkpoint
  every worker holds when any worker is lost;
- each worker joins the ``torch.distributed`` cohort and runs the same
  job with ``env.set_distributed``: the parallelism-N source partitions
  the stream (subtask w on process w), count windows of
  ``global_batch / N`` feed the gang ``DPTrainWindowFunction``
  (parallelism N, one subtask per process; the gradients are averaged
  over the cohort inside the step), and the loss stream rebalances down
  to a sink at parallelism 1 on process 0 over the record plane;
- checkpoints are count-based barriers into one shared directory (the
  framework keeps one shard per process) and commit on global
  durability.

The port runs ONE device per worker process: ``--devices-per-worker``
must be 1 (the reference's default of 4 were virtual CPU devices, which
the port has none of; more devices are more workers).  On the card,
workers take ``cuda:<worker mod cards>``: with fewer cards than workers
they share one over gloo, otherwise they join over NCCL.  ``--cpu``
trains on the host over gloo.

Run (2 processes, one injected failure):
  python -m flink_tensorflow_tpu_torch.examples.multihost_dp_train --records-per-worker 48
Clean run:  python -m flink_tensorflow_tpu_torch.examples.multihost_dp_train --no-failure
"""

import argparse
import json
import os
import pathlib
import sys
import tempfile
import time
import typing


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--devices-per-worker", type=int, default=1)
    p.add_argument("--records-per-worker", type=int, default=48)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--ckpt-every-steps", type=int, default=2)
    p.add_argument("--base-port", type=int, default=0,
                   help="0 = pick free ports automatically")
    p.add_argument("--no-failure", action="store_true",
                   help="skip the injected worker failure")
    p.add_argument("--fail-worker", type=int, default=1)
    p.add_argument("--fail-at-step", type=int, default=5)
    p.add_argument("--work-dir", default=None)
    p.add_argument("--cpu", action="store_true",
                   help="train on the CPU (default: the card, which must be present)")
    # worker-mode internals (set by the parent)
    p.add_argument("--worker", type=int, default=None)
    p.add_argument("--attempt", type=int, default=0)
    p.add_argument("--coordinator-port", type=int, default=None)
    p.add_argument("--shuffle-ports", default=None,
                   help="comma-separated record-plane ports, one per worker")
    return p


def worker_device(args) -> typing.Tuple[str, str]:
    """``(device, backend)`` of one worker process; raises when the
    worker is asked for more than the one device a process holds, or
    for more cards than are visible."""
    if args.devices_per_worker != 1:
        raise ValueError(
            f"--devices-per-worker {args.devices_per_worker}: the port runs one device per "
            "worker process; run more workers instead")
    if args.cpu:
        return "cpu", "gloo"
    import torch

    from flink_tensorflow_tpu_torch.utils.device import resolve_device

    resolve_device(None)   # raises without a card
    cards = torch.cuda.device_count()
    return "cuda", "nccl" if args.workers <= cards else "gloo"


def model_and_schema():
    import numpy as np

    from flink_tensorflow_tpu_torch.models import get_model_def
    from flink_tensorflow_tpu_torch.tensors import RecordSchema, spec

    cfg = dict(hash_buckets=200, embed_dim=4, num_cat_slots=2, num_dense=4, num_wide=8,
               hidden=(16,))
    mdef = get_model_def("widedeep", **cfg)
    schema = RecordSchema({
        "wide": spec((cfg["num_wide"],)),
        "dense": spec((cfg["num_dense"],)),
        "cat": spec((cfg["num_cat_slots"],), np.int32),
        "label": spec((), np.int32),
    })
    return mdef, schema, cfg


def stream_records(n, cfg):
    """The one logical stream, generated the same way in every process
    (the parallelism-W source gives subtask w the records w, w + W, ...),
    so a restarted cohort replays the same records."""
    import numpy as np

    from flink_tensorflow_tpu_torch.tensors.value import TensorValue

    rng = np.random.RandomState(1000)
    records = []
    for i in range(n):
        x_wide = rng.rand(cfg["num_wide"]).astype(np.float32)
        records.append(TensorValue({
            "wide": x_wide,
            "dense": rng.rand(cfg["num_dense"]).astype(np.float32),
            "cat": rng.randint(0, cfg["hash_buckets"], (cfg["num_cat_slots"],)).astype(np.int32),
            "label": np.int32(x_wide[0] > 0.5),
        }, meta={"id": i}))
    return records


# ---------------------------------------------------------------------------
# worker mode
# ---------------------------------------------------------------------------

class _LossProbe:
    """The per-process map behind the gang: keeps this process's losses,
    tags each record with its gang subtask and step for the aggregator,
    and injects the worker loss."""

    def __init__(self, args):
        self.args = args
        self.losses = []
        self.subtask = 0

    def make(self):
        from flink_tensorflow_tpu_torch.core import functions as fn

        probe = self

        class Probe(fn.MapFunction):
            def clone(self):
                return self  # one subtask per process: keep the handle

            def open(self, ctx):
                probe.subtask = ctx.subtask_index

            def map(self, record):
                probe.losses.append(float(record["loss"]))
                step = len(probe.losses)
                a = probe.args
                if (not a.no_failure and a.attempt == 0 and probe.subtask == a.fail_worker
                        and step >= a.fail_at_step):
                    # The injected worker loss: die mid-round, off a
                    # checkpoint boundary, taking the cohort's collectives
                    # and its record-plane channels down with it.
                    os._exit(1)
                return record.with_meta(gang_subtask=probe.subtask, step=step)

        return Probe()


def run_worker(args) -> int:
    from flink_tensorflow_tpu_torch import DistributedConfig, StreamExecutionEnvironment
    from flink_tensorflow_tpu_torch.functions import DPTrainWindowFunction
    from flink_tensorflow_tpu_torch.parallel import latest_common_checkpoint, multihost, optim

    device, backend = worker_device(args)
    topo = multihost.initialize(f"127.0.0.1:{args.coordinator_port}",
                                num_processes=args.workers, process_id=args.worker,
                                device=device, backend=backend)
    try:
        mesh = multihost.global_mesh({"data": topo.global_devices}, device=device)
        mdef, schema, cfg = model_and_schema()
        W = args.workers
        local_batch = args.global_batch // W
        records = stream_records(W * args.records_per_worker, cfg)
        total_steps = args.records_per_worker // local_batch

        shared_ckpt = os.path.join(args.work_dir, "ckpt")
        shuffle_ports = [int(x) for x in args.shuffle_ports.split(",")]
        dist = DistributedConfig(args.worker, W, tuple(f"127.0.0.1:{p}" for p in shuffle_ports),
                                 restart_epoch=args.attempt)
        worker_dirs = [dist.process_checkpoint_dir(shared_ckpt, w) for w in range(W)]

        env = StreamExecutionEnvironment(parallelism=1)
        env.set_mesh(mesh)
        env.set_distributed(dist)
        env.enable_checkpointing(shared_ckpt,
                                 every_n_records=args.ckpt_every_steps * local_batch)
        probe = _LossProbe(args)
        received = []

        def agg_sink(record):
            received.append((int(record.meta["gang_subtask"]), int(record.meta["step"]),
                             float(record["loss"])))

        (
            env.from_collection(records, parallelism=W)
            .count_window(local_batch)
            .apply(DPTrainWindowFunction(mdef, optim.adam(1e-2), train_schema=schema,
                                         global_batch=args.global_batch),
                   name="dp_train", parallelism=W)
            .map(probe.make(), name="loss_probe", parallelism=W)
            .sink_to_callable(agg_sink, name="loss_agg", parallelism=1)
        )
        restored_id = latest_common_checkpoint(worker_dirs) if args.attempt > 0 else None
        env.execute("multihost-dp-train", timeout=600,
                    restore_from=shared_ckpt if restored_id is not None else None,
                    restore_checkpoint_id=restored_id)
    finally:
        multihost.shutdown()

    result = {
        "worker": args.worker,
        "attempt": args.attempt,
        "global_devices": topo.global_devices,
        "num_processes": topo.num_processes,
        "restored_checkpoint": restored_id,
        "steps_this_attempt": len(probe.losses),
        "total_steps": total_steps,
        "losses": [round(loss, 6) for loss in probe.losses],
    }
    with open(os.path.join(args.work_dir, f"result_w{args.worker}.json"), "w") as f:
        json.dump(result, f)
    if args.worker == 0:
        import numpy as np

        by_worker = {}
        for subtask, step, loss in received:
            by_worker.setdefault(subtask, []).append((step, loss))
        summary = {
            "workers_reporting": sorted(by_worker),
            "records_received": len(received),
            "mean_final_loss": round(
                float(np.mean([sorted(v)[-1][1] for v in by_worker.values()])), 6
            ) if by_worker else None,
        }
        with open(os.path.join(args.work_dir, "aggregate.json"), "w") as f:
            json.dump(summary, f)
    return 0


# ---------------------------------------------------------------------------
# parent mode
# ---------------------------------------------------------------------------

def _free_ports(n: int) -> typing.List[int]:
    """``n`` distinct free ports, all bound before any is released."""
    import socket

    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def run_parent(args) -> dict:
    from flink_tensorflow_tpu_torch.parallel import CohortSupervisor

    worker_device(args)   # refuse an impossible layout before spawning
    work_dir = args.work_dir or tempfile.mkdtemp(prefix="multihost_dp_")
    # Fresh ports per attempt (1 coordinator + W record-plane endpoints):
    # a dead attempt's sockets may linger in TIME_WAIT.
    per_attempt = 1 + args.workers
    if args.base_port:
        ports = {a: tuple(args.base_port + a * per_attempt + i for i in range(per_attempt))
                 for a in range(4)}
    else:
        flat = _free_ports(4 * per_attempt)
        ports = {a: tuple(flat[a * per_attempt:(a + 1) * per_attempt]) for a in range(4)}
    root = str(pathlib.Path(__file__).resolve().parents[2])

    def command(worker, num_workers, attempt):
        cport, *shuffle = ports[attempt]
        cmd = [
            sys.executable, "-m", "flink_tensorflow_tpu_torch.examples.multihost_dp_train",
            "--worker", str(worker),
            "--workers", str(num_workers),
            "--attempt", str(attempt),
            "--coordinator-port", str(cport),
            "--shuffle-ports", ",".join(map(str, shuffle)),
            "--devices-per-worker", str(args.devices_per_worker),
            "--records-per-worker", str(args.records_per_worker),
            "--global-batch", str(args.global_batch),
            "--ckpt-every-steps", str(args.ckpt_every_steps),
            "--fail-worker", str(args.fail_worker),
            "--fail-at-step", str(args.fail_at_step),
            "--work-dir", work_dir,
        ]
        if args.no_failure:
            cmd.append("--no-failure")
        if args.cpu:
            cmd.append("--cpu")
        return cmd

    def env(worker, num_workers, attempt):
        path = os.environ.get("PYTHONPATH")
        return {"PYTHONPATH": root if not path else root + os.pathsep + path}

    supervisor = CohortSupervisor(command, args.workers, env=env, max_restarts=2,
                                  attempt_timeout_s=600)
    t0 = time.time()
    outcome = supervisor.run()

    results = []
    for w in range(args.workers):
        with open(os.path.join(work_dir, f"result_w{w}.json")) as f:
            results.append(json.load(f))
    with open(os.path.join(work_dir, "aggregate.json")) as f:
        aggregate = json.load(f)
    summary = {
        "job": "multihost_dp_train",
        "workers": args.workers,
        "cohort_attempts": outcome.attempts,
        "wall_s": round(time.time() - t0, 1),
        "global_devices": results[0]["global_devices"],
        "restored_checkpoint": results[0]["restored_checkpoint"],
        "steps_final_attempt": results[0]["steps_this_attempt"],
        "loss_first": results[0]["losses"][0] if results[0]["losses"] else None,
        "loss_last": results[0]["losses"][-1] if results[0]["losses"] else None,
        "losses_agree_across_workers": all(r["losses"] == results[0]["losses"] for r in results),
        "aggregate": aggregate,
        "work_dir": work_dir,
    }
    print(json.dumps(summary))
    return summary


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.global_batch % args.workers:
        raise SystemExit("global-batch must divide by workers")
    if args.worker is not None:
        sys.exit(run_worker(args))
    return run_parent(args)


if __name__ == "__main__":
    main()
