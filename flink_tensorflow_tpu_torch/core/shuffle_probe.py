"""The record plane's throughput across a real process boundary.

Mirror of the reference bench's shuffle microbenchmark
(``bench.py:_shuffle_arm``, ``:2236-2318``, and the arms and sizes of
``bench_shuffle``, ``:2482-2560``): a sender subprocess writes ``n``
records of ``floats`` f32 values (from a pool of 64 distinct records made
outside the measured stream) through a
:class:`~flink_tensorflow_tpu_torch.core.shuffle.RemoteChannelWriter`
into this process's reactor-backed
:class:`~flink_tensorflow_tpu_torch.core.shuffle.ShuffleServer`; the span
runs from the first record's arrival at the gate to end-of-partition.
Host-only: no tensor touches a device.

    python3 -m flink_tensorflow_tpu_torch.core.shuffle_probe [--passes 2] [--smoke]

prints one JSON line per arm and size, then the bench's two ratios.  One
sender process serves every arm in turn (the bench starts one per arm);
the measured span is the same.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import typing

from flink_tensorflow_tpu_torch.core import elements as el
from flink_tensorflow_tpu_torch.core.channels import InputGate
from flink_tensorflow_tpu_torch.core.shuffle import ShuffleServer

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: (floats per record, records) of ``bench_shuffle``'s full run.
SIZES = ((64, 40000), (1024, 20000), (16384, 2000))
SMOKE_SIZES = ((64, 2000), (1024, 1000))

#: The bench's arms: ``flush_bytes=0`` is a frame per record.
ARMS = {
    "percord_tcp": dict(flush_bytes=0, flush_ms=0.0, columnar=False, shm=False),
    "coalesce_tcp": dict(flush_bytes=64 << 10, flush_ms=5.0, columnar=False, shm=False),
    "coalesce_columnar_tcp": dict(flush_bytes=64 << 10, flush_ms=5.0, columnar=True,
                                  shm=False),
    "coalesce_columnar_shm": dict(flush_bytes=64 << 10, flush_ms=5.0, columnar=True,
                                  shm=True),
}

#: The sender: one process for the whole run, reading one arm per line
#: of its standard input (``port n floats flush_bytes flush_ms columnar
#: shm``) and answering ``ok`` when the arm's writer has closed.  The
#: bench starts a process per arm; the span measured is the same (first
#: arrival to end-of-partition), and one process pays its imports once.
_SENDER = r"""
import sys
import numpy as np
from flink_tensorflow_tpu_torch.core import elements as el
from flink_tensorflow_tpu_torch.core.shuffle import RemoteChannelWriter
from flink_tensorflow_tpu_torch.tensors.value import TensorValue

for line in sys.stdin:
    port, n, floats, flush_bytes, flush_ms, columnar, shm = line.split()
    port, n, floats, flush_bytes = int(port), int(n), int(floats), int(flush_bytes)
    rng = np.random.RandomState(0)
    pool = [TensorValue({"x": rng.rand(floats).astype(np.float32)}, {}) for _ in range(64)]
    w = RemoteChannelWriter("127.0.0.1", port, "bench", 0, 0, connect_timeout_s=30.0,
                            flush_bytes=flush_bytes, flush_ms=float(flush_ms),
                            columnar=bool(int(columnar)), shm=bool(int(shm)))
    for i in range(n):
        w.write(el.StreamRecord(pool[i & 63]))
    w.write(el.EndOfPartition())
    w.close()
    print("ok", flush=True)
"""


class Sender:
    """The sender subprocess (``with Sender() as sender: ...``)."""

    def __enter__(self) -> "Sender":
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
        self.proc = subprocess.Popen([sys.executable, "-c", _SENDER], env=env, text=True,
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT)
        return self

    def send(self, port: int, n: int, floats: int, *, flush_bytes: int, flush_ms: float,
             columnar: bool, shm: bool) -> None:
        self.proc.stdin.write(f"{port} {n} {floats} {flush_bytes} {flush_ms} "
                              f"{int(columnar)} {int(shm)}\n")
        self.proc.stdin.flush()

    def done(self) -> None:
        """Wait for the arm's ``ok``; raises with the sender's output if it
        failed."""
        line = self.proc.stdout.readline()
        if line.strip() != "ok":
            rest = self.proc.stdout.read() if self.proc.poll() is not None else ""
            raise RuntimeError(f"sender failed: {line}{rest}")

    def __exit__(self, *exc) -> None:
        try:
            self.proc.stdin.close()
            self.proc.wait(timeout=30)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()


def shuffle_arm(sender: Sender, n: int, floats: int, *, capacity: int = 8192,
                timeout_s: float = 120.0, **knobs) -> dict:
    """One (arm, size) pass through ``sender``; raises unless every record
    arrived."""
    gate = InputGate(1, capacity=capacity)
    server = ShuffleServer("127.0.0.1")
    server.register_gate("bench", 0, gate)
    server.start()
    got = 0
    t0 = t1 = None
    try:
        sender.send(server.port, n, floats, **knobs)
        while True:
            item = gate.poll(timeout=timeout_s)
            if item is None:
                raise RuntimeError(f"shuffle probe stalled after {got} of {n} records")
            element = item[1]
            if isinstance(element, el.StreamRecord):
                if t0 is None:
                    t0 = time.monotonic()
                got += 1
            elif isinstance(element, el.EndOfPartition):
                t1 = time.monotonic()
                break
        sender.done()
    finally:
        server.close()
    if got != n:
        raise RuntimeError(f"lost records: {got}/{n}")
    span = (t1 - t0) if t0 is not None and t1 > t0 else float("nan")
    return {"records": n, "record_bytes": floats * 4, "span_s": span,
            "records_per_sec": n / span if span == span else None,
            "wire_sustained_mb_s": n * floats * 4 / span / 1e6 if span == span else None}


def shuffle_bench(sizes: typing.Sequence[typing.Tuple[int, int]] = SIZES,
                  passes: int = 2) -> dict:
    """Every arm at every size, the best of ``passes`` passes each (the
    bench's rule), and the bench's ratios: coalesced columnar over
    frame-per-record TCP on records of at most 4 KB, and shm over TCP."""
    arms: typing.Dict[str, list] = {name: [] for name in ARMS}
    with Sender() as sender:
        for floats, n in sizes:
            for name, knobs in ARMS.items():
                runs = [shuffle_arm(sender, n, floats, **knobs) for _ in range(passes)]
                arms[name].append(max(runs, key=lambda r: r["wire_sustained_mb_s"] or 0.0))

    def mbs(arm, i):
        return arms[arm][i]["wire_sustained_mb_s"]

    small = [i for i, (f, _) in enumerate(sizes) if f * 4 <= 4096]
    return {"record_sizes_bytes": [f * 4 for f, _ in sizes], "passes": passes, "arms": arms,
            "coalesce_columnar_speedup_small_records": [
                mbs("coalesce_columnar_tcp", i) / mbs("percord_tcp", i) for i in small],
            "shm_vs_loopback_tcp_ratio": [
                mbs("coalesce_columnar_shm", i) / mbs("coalesce_columnar_tcp", i)
                for i in range(len(sizes))]}


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--passes", type=int, default=2)
    parser.add_argument("--smoke", action="store_true", help="the bench's smoke sizes")
    args = parser.parse_args()
    result = shuffle_bench(SMOKE_SIZES if args.smoke else SIZES, args.passes)
    for name, rows in result["arms"].items():
        for row in rows:
            print(json.dumps({"arm": name, **row}), flush=True)
    print(json.dumps({k: v for k, v in result.items() if k != "arms"}))
