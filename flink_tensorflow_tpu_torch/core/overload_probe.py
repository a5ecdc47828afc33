"""The record plane under overload, and where a traced frame's time goes.

Mirror of the reference bench's overload workload (``bench.py:
bench_overload``, ``:3309-3520``) and its traced wire pass
(``_shuffle_trace_attribution``, ``:2320-2372``), over the port's
:class:`~flink_tensorflow_tpu_torch.core.shuffle.RemoteChannelWriter` and
:class:`~flink_tensorflow_tpu_torch.core.shuffle.ShuffleServer` in one
process.  Host-only: no tensor touches a device.

- :func:`overload_arm`: an unthrottled producer drives a reactor-backed
  remote edge into a slow consumer (a fixed service time per record and
  one hard stall), with credit flow control on or off.  With credits the
  sender's send queue (``peak_send_queue_bytes``) stays under the credit
  window times the frame quantum and the parks show as
  ``wire.credit_wait`` spans; without them the queue grows with however
  far the producer ran ahead.
- :func:`trace_attribution`: a traced pass over the wire, folded into the
  stage table (``wire.flush``, ``serde``, ``wire``) of the writer.

    python3 -m flink_tensorflow_tpu_torch.core.overload_probe [--records 2000]

prints one JSON line per arm, then the traced pass's stage table.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
import typing

import numpy as np

from flink_tensorflow_tpu_torch.core import elements as el
from flink_tensorflow_tpu_torch.core.channels import InputGate
from flink_tensorflow_tpu_torch.core.reactor import Reactor
from flink_tensorflow_tpu_torch.core.shuffle import (
    CREDIT_OVERFLOW_FRAMES,
    RemoteChannelWriter,
    ShuffleServer,
    credit_window,
)
from flink_tensorflow_tpu_torch.metrics.registry import MetricRegistry
from flink_tensorflow_tpu_torch.tensors.value import TensorValue
from flink_tensorflow_tpu_torch.tracing.attribution import attribution
from flink_tensorflow_tpu_torch.tracing.tracer import Tracer

#: ``bench_overload``'s full-size knobs.
RECORDS = 2000
PAYLOAD_FLOATS = 256       # about 1 KB a record on the wire
CAPACITY = 64              # gate quanta: a credit window of 2
FLUSH_BYTES = 4096
FLUSH_MS = 2.0
SERVICE_S = 0.0002         # the consumer's ceiling, about 5,000 records/s
STALL_S = 0.5
WIRE_STAGES = ("serde", "wire", "wire.flush", "wire.credit_wait")


def credit_bound_bytes(capacity: int = CAPACITY, flush_bytes: int = FLUSH_BYTES) -> int:
    """The ON arm's send-queue ceiling (``bench.py:3471``): the window plus
    the barrier overdraft, each a frame of at most ``flush_bytes`` plus one
    record's overshoot."""
    return (credit_window(capacity) + CREDIT_OVERFLOW_FRAMES) * (flush_bytes + 4096)


def stage_table(events: typing.Sequence[tuple],
                stages: typing.Sequence[str] = WIRE_STAGES) -> dict:
    """Count, total and median-of-p50 per stage over every operator
    (``bench.py:3363-3378``, ``:2908-2938``)."""
    merged: dict = {}
    for rows in attribution(events).values():
        for stage, row in rows.items():
            if stage not in stages:
                continue
            agg = merged.setdefault(stage, {"count": 0, "total_ms": 0.0, "p50s": []})
            agg["count"] += row["count"]
            agg["total_ms"] += row["total_ms"]
            agg["p50s"].append(row["p50_ms"])
    return {stage: {"count": agg["count"], "total_ms": round(agg["total_ms"], 3),
                    "p50_ms": round(float(np.median(agg["p50s"])), 4)}
            for stage, agg in merged.items()}


def overload_arm(flow_control: bool, n: int = RECORDS, *, stall_s: float = STALL_S,
                 service_s: float = SERVICE_S) -> dict:
    """One arm of ``bench_overload`` (``bench.py:3380-3455``): the row the
    bench books, plus the traced events' stage table."""
    reg = MetricRegistry()
    tracer = Tracer(sample_rate=1.0)
    gate = InputGate(1, capacity=CAPACITY)
    server = ShuffleServer("127.0.0.1", 0, metrics=reg)
    server.register_gate("op", 0, gate)
    server.start()
    reactor = Reactor()
    reactor.start()
    writer = RemoteChannelWriter(
        "127.0.0.1", server.port, "op", 0, 0, metrics=reg, flush_bytes=FLUSH_BYTES,
        flush_ms=FLUSH_MS, reactor=reactor, tracer=tracer, flow_control=flow_control)
    stall_at = max(1, n // 3)
    got = [0]
    stall_over_t = [0.0]
    drained_t = [0.0]
    done = threading.Event()

    def consume():
        while True:
            item = gate.poll(timeout=1.0)
            if item is None:
                continue
            if isinstance(item[1], el.EndOfPartition):
                done.set()
                return
            got[0] += 1
            if got[0] == stall_at:
                time.sleep(stall_s)
                stall_over_t[0] = time.monotonic()
            else:
                time.sleep(service_s)

    def watch_recovery():
        # The consumer resumed: how long until the sender's backlog is
        # back under one frame quantum.
        while stall_over_t[0] == 0.0 and not done.is_set():
            time.sleep(0.005)
        conn = writer._conn
        while not done.is_set():
            if conn is None or conn.send_queue_bytes <= FLUSH_BYTES:
                drained_t[0] = time.monotonic()
                return
            time.sleep(0.005)

    consumer = threading.Thread(target=consume)
    consumer.start()
    watcher = threading.Thread(target=watch_recovery)
    t0 = time.monotonic()
    try:
        rec = np.arange(PAYLOAD_FLOATS, dtype=np.float32)
        for i in range(n):
            writer.write(el.StreamRecord(TensorValue({"x": rec}, {"i": i}), None))
            if i == 0:
                watcher.start()
        writer.write(el.EndOfPartition())
        produced_s = time.monotonic() - t0
        if not done.wait(300):
            raise TimeoutError("the consumer never saw end-of-partition")
        wall = time.monotonic() - t0
        conn = writer._conn
        peak = 0 if conn is None else conn.peak_send_queue_bytes
    finally:
        done.set()
        consumer.join(10)
        if watcher.ident is not None:  # started at the first record
            watcher.join(10)
        writer.close()
        reactor.close()
        server.close()
    rep = reg.report()
    recovery_s = (drained_t[0] - stall_over_t[0]
                  if drained_t[0] and stall_over_t[0] else None)
    events = tracer.events()
    return {
        "flow_control": flow_control,
        "wall_s": wall,
        "producer_wall_s": produced_s,
        "records_per_s": n / wall,
        "peak_send_queue_bytes": int(peak),
        "stall_recovery_s": None if recovery_s is None else max(0.0, recovery_s),
        "credit_starved_s": rep.get("shuffle.out.op.0.ch0.credit_starved_s", 0.0),
        "credit_grants": rep.get("shuffle.in.op.0.ch0.credit_grants", 0),
        "records_delivered": got[0],
        "trace_attribution": stage_table(events),
    }


def trace_attribution(n: int, floats: int, **writer_knobs) -> dict:
    """``bench.py:_shuffle_trace_attribution``: a traced pass of ``n``
    records of ``floats`` f32 values over a loopback writer, folded per
    stage; ``writer_knobs`` picks the arm (``flush_bytes=0`` is a frame
    per record)."""
    tracer = Tracer(sample_rate=1.0, seed=0)
    gate = InputGate(1, capacity=8192)
    server = ShuffleServer("127.0.0.1")
    server.register_gate("bench", 0, gate)
    server.start()
    rng = np.random.RandomState(0)
    pool = [TensorValue({"x": rng.rand(floats).astype(np.float32)}, {}) for _ in range(64)]
    writer = RemoteChannelWriter("127.0.0.1", server.port, "bench", 0, 0,
                                 connect_timeout_s=30.0, tracer=tracer, **writer_knobs)

    def produce():
        for i in range(n):
            writer.write(el.StreamRecord(pool[i & 63]))
        writer.write(el.EndOfPartition())

    producer = threading.Thread(target=produce, daemon=True)
    producer.start()
    try:
        while True:
            item = gate.poll(timeout=60.0)
            if item is None:
                raise TimeoutError("the traced pass stalled")
            if isinstance(item[1], el.EndOfPartition):
                break
    finally:
        producer.join(timeout=10)
        writer.close()
        server.close()
    return stage_table(tracer.events())


def main(argv: typing.Optional[typing.Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--records", type=int, default=RECORDS)
    args = p.parse_args(argv)
    for flow_control in (True, False):
        print(json.dumps(overload_arm(flow_control, args.records)), flush=True)
    print(json.dumps({"trace_attribution": trace_attribution(args.records, 64)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
