"""One process of the autoscale cohort (the port's copy of
``tests/_autoscale_worker.py``; torch and the port only).

One process of an N-process cohort running ``source -> key_by -> SLOW
keyed stage -> 2PC file sink`` (or a slow rebalanced stage ahead of a
cheap keyed sum, ``--slow-stage rebalance``) with the health plane on: a
tiny channel capacity plus a per-record sleep in the slow stage makes its
input queues saturate, the process-0
:class:`~flink_tensorflow_tpu_torch.metrics.health.HealthEvaluator`
sustains an ``edge-queue`` BREACH, and the
:class:`~flink_tensorflow_tpu_torch.core.autoscale.AutoscaleActuator`
(gated on a completed checkpoint) writes its decision file and cancels
the job, and this process exits with the rescale code.  The parent
:class:`~flink_tensorflow_tpu_torch.core.autoscale.AutoscaleSupervisor`
respawns the cohort one worker larger; ``--restore-id -2`` restores from
the highest complete cohort checkpoint with key-group redistribution,
and the committed output must equal the fault-free run exactly.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from flink_tensorflow_tpu_torch import DistributedConfig, StreamExecutionEnvironment  # noqa: E402
from flink_tensorflow_tpu_torch.core import functions as fn  # noqa: E402
from flink_tensorflow_tpu_torch.core.autoscale import AutoscaleConfig  # noqa: E402
from flink_tensorflow_tpu_torch.core.state import StateDescriptor  # noqa: E402
from flink_tensorflow_tpu_torch.io.files import ExactlyOnceRecordFileSink  # noqa: E402
from flink_tensorflow_tpu_torch.metrics.health import HealthConfig, SloRule  # noqa: E402
from flink_tensorflow_tpu_torch.tensors.value import TensorValue  # noqa: E402

SUM = StateDescriptor("sum", default_factory=lambda: 0)
NUM_KEYS = 4


class SlowKeyedSum(fn.ProcessFunction):
    """The induced bottleneck: a running per-key sum whose per-record
    sleep makes the fast source saturate the stage's input queues.

    ``busy=True`` burns the delay in a GIL-holding spin instead of a
    sleep: subtasks co-located on one process then contend for the
    interpreter, so spreading the same subtasks over MORE processes
    genuinely raises throughput — the bench's step-up arm."""

    def __init__(self, delay_s, busy=False):
        self.delay_s = delay_s
        self.busy = busy

    def process_element(self, value, ctx, out):
        if self.busy and self.delay_s > 0:
            end = time.perf_counter() + self.delay_s
            while time.perf_counter() < end:
                pass
        elif self.delay_s > 0:
            time.sleep(self.delay_s)
        state = ctx.state(SUM)
        cur = state.value() + int(value)
        state.update(cur)
        out.collect(TensorValue(
            {"v": np.int64(cur)},
            {"key": int(ctx.current_key), "i": int(value)},
        ))


class SlowGate(fn.MapFunction):
    """Stateless slow stage for the bench's rebalance topology: the
    round-robin edge spreads records evenly over its subtasks at ANY
    width, so widening it on rescale raises throughput by construction
    (keyed routing can't promise that — int keys hash to identity, and
    few small keys all land in one subtask's key-group range)."""

    def __init__(self, delay_s, busy=False):
        self.delay_s = delay_s
        self.busy = busy

    def map(self, value):
        if self.busy and self.delay_s > 0:
            end = time.perf_counter() + self.delay_s
            while time.perf_counter() < end:
                pass
        elif self.delay_s > 0:
            time.sleep(self.delay_s)
        return value


def main():
    torch.set_num_threads(1)
    p = argparse.ArgumentParser()
    p.add_argument("--index", type=int, required=True)
    p.add_argument("--ports", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--chk", required=True)
    p.add_argument("--n", type=int, default=400)
    p.add_argument("--every", type=int, default=40)
    p.add_argument("--par", type=int, default=2)
    p.add_argument("--delay", type=float, default=0.01,
                   help="per-record sleep in the keyed stage (the "
                        "induced bottleneck)")
    p.add_argument("--cap", type=int, default=8,
                   help="channel capacity — small so queues saturate")
    p.add_argument("--busy", action="store_true",
                   help="burn --delay in a GIL-holding spin instead of "
                        "sleeping (see SlowKeyedSum)")
    p.add_argument("--keys", type=int, default=NUM_KEYS,
                   help="key cardinality (more keys balance better "
                        "across a rescaled keyed stage)")
    p.add_argument("--slow-stage", choices=["keyed", "rebalance"],
                   default="keyed",
                   help="where the induced bottleneck lives: the keyed "
                        "stage itself, or a stateless rebalanced stage "
                        "in front of it (see SlowGate)")
    p.add_argument("--epoch", type=int, default=0,
                   help="supervisor attempt, threaded into "
                        "DistributedConfig.restart_epoch (zombie fencing)")
    p.add_argument("--restore-id", type=int, default=-1,
                   help="-1 fresh; -2 AUTO (highest complete cohort "
                        "checkpoint)")
    p.add_argument("--decision", required=True,
                   help="autoscale decision file path (shared with the "
                        "parent supervisor)")
    p.add_argument("--min-workers", type=int, default=1)
    p.add_argument("--max-workers", type=int, default=3)
    p.add_argument("--cooldown", type=float, default=2.0)
    p.add_argument("--flight", default=None)
    args = p.parse_args()

    ports = [int(x) for x in args.ports.split(",")]
    peers = tuple(f"127.0.0.1:{pt}" for pt in ports)
    autoscale = AutoscaleConfig(
        min_workers=args.min_workers, max_workers=args.max_workers,
        step=1, cooldown_s=args.cooldown, decision_path=args.decision,
        require_checkpoint=True,
    )
    # Explicit rules so the soak is deterministic: a saturated input
    # edge on the slow stage escalates after 2 consecutive evaluations.
    # (value-mode against the tiny channel capacity — no rate warmup.)
    rules = (
        SloRule("edge-queue", "edge*_queue_depth",
                warn=0.5 * args.cap, breach=0.75 * args.cap,
                sustain=2, clear_after=2, action="scale_up"),
    )
    env = StreamExecutionEnvironment(parallelism=1)
    env.configure(
        channel_capacity=args.cap,
        health=HealthConfig(rules=rules, interval_s=0.25,
                            autoscale=autoscale),
    )
    if args.flight:
        env.configure(flight_path=args.flight)
    env.set_distributed(DistributedConfig(
        args.index, len(ports), peers, connect_timeout_s=30.0,
        telemetry_interval_s=0.25, restart_epoch=args.epoch))
    env.enable_checkpointing(args.chk, every_n_records=args.every)
    stream = env.from_collection(list(range(args.n)), parallelism=1)
    if args.slow_stage == "rebalance":
        # Bottleneck on a stateless rebalanced stage (par = the knob the
        # rescale turns); the keyed sum stays cheap and narrow as the
        # exactly-once state oracle.
        stream = stream.map(SlowGate(args.delay, busy=args.busy),
                            name="slow_stage", parallelism=args.par)
        keyed_par, keyed_delay = 1, 0.0
    else:
        keyed_par, keyed_delay = args.par, args.delay
    (
        stream
        .key_by(lambda x: x % args.keys)
        .process(SlowKeyedSum(keyed_delay, busy=args.busy),
                 name="slow_sum", parallelism=keyed_par)
        .add_sink(ExactlyOnceRecordFileSink(args.out), name="sink",
                  parallelism=1)
    )

    restore = {}
    if args.restore_id >= 0:
        restore = dict(restore_from=args.chk,
                       restore_checkpoint_id=args.restore_id)
    elif args.restore_id == -2:
        from flink_tensorflow_tpu_torch.checkpoint.store import (
            select_cohort_checkpoint,
        )

        try:
            cid, _ = select_cohort_checkpoint(args.chk)
            restore = dict(restore_from=args.chk,
                           restore_checkpoint_id=cid)
        except (FileNotFoundError, ValueError):
            restore = {}

    handle = env.execute_async("autoscale-soak", restart_epoch=args.epoch,
                               **restore)
    try:
        handle.wait(timeout=180)
    except Exception:
        # A decision cancels the job from inside; any teardown error it
        # caused still IS the rescale request, not a failure.
        if handle.autoscale_decision is not None:
            sys.exit(autoscale.rescale_exit_code)
        raise
    if handle.autoscale_decision is not None:
        # The actuator decided and cancelled the job: exit with the
        # rescale code so the parent supervisor respawns the cohort at
        # decision.to_workers instead of counting a failure.
        sys.exit(autoscale.rescale_exit_code)


if __name__ == "__main__":
    main()
