"""One process of the port's two-process traced cohort (the port's copy of
``tests/_cohort_trace_worker.py``; torch and the port only).

``source(par 1, process 0) -> rebalance -> map(par 2, one subtask per
process) -> sink(par 1, process 0)`` with tracing and cohort telemetry
on: the round-robin edge sends half the records across the process
boundary and ``work.1 -> sink.0`` brings them back, so the per-process
trace files hold cross-process record journeys for
``tracing/stitch.py``.  ``--health`` also runs the health plane on
process 0 over the merged cohort snapshot and writes its final
``health()`` view and merged snapshot as JSON to that path.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from flink_tensorflow_tpu_torch import (  # noqa: E402
    DistributedConfig,
    StreamExecutionEnvironment,
)
from flink_tensorflow_tpu_torch.metrics.health import HealthConfig  # noqa: E402


def main():
    torch.set_num_threads(1)
    p = argparse.ArgumentParser()
    p.add_argument("--index", type=int, required=True)
    p.add_argument("--ports", required=True)
    p.add_argument("--n", type=int, default=120)
    p.add_argument("--throttle", type=float, default=0.01)
    p.add_argument("--trace", required=True)
    p.add_argument("--telemetry-interval", type=float, default=0.2)
    p.add_argument("--health", default=None)
    args = p.parse_args()

    ports = [int(x) for x in args.ports.split(",")]
    peers = tuple(f"127.0.0.1:{pt}" for pt in ports)
    env = StreamExecutionEnvironment(parallelism=1)
    env.configure(source_throttle_s=args.throttle, trace=True, trace_path=args.trace)
    if args.health:
        env.configure(health=HealthConfig(interval_s=args.telemetry_interval))
    env.set_distributed(DistributedConfig(
        args.index, len(ports), peers, connect_timeout_s=30.0,
        telemetry_interval_s=args.telemetry_interval))
    (
        env.from_collection(list(range(args.n)), parallelism=1)
        .map(lambda x: x + 1, name="work", parallelism=2)
        .sink_to_callable(lambda v: None, name="sink", parallelism=1)
    )
    handle = env.execute_async("cohort-trace")
    handle.wait(180)
    if args.health and args.index == 0:
        collector = handle.executor.cohort_collector
        _, merged = collector.merged_snapshot()
        with open(args.health, "w") as f:
            json.dump({"health": handle.health.health(), "pushes": collector.pushes,
                       "peers_reporting": collector.peers_reporting,
                       "snapshot": merged}, f, default=str)


if __name__ == "__main__":
    main()
