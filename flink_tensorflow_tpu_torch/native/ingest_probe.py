"""How long the ring's push takes per record, alone and beside threads
that keep taking and giving up the interpreter lock, as dispatch lanes do.

    python3 -m flink_tensorflow_tpu_torch.native.ingest_probe [--threads 6] [--records 2048]

Pushes Inception records (299x299x3 uint8, 268,203 B) into a
``TensorRing`` of 1,024 slots, claiming them all (which waits for their
copies) and releasing them whenever it is full, after one unmeasured
pass that touches the arena, in both rings: ``native`` (the C++ ring: the
push submits the row pointers and the ring's copier thread copies, off
the interpreter lock) and ``python`` (the plain version: reserve, numpy
copy, commit, on the pushing thread).  The threads loop small torch CPU
ops (each gives the lock up and takes it back).  Prints one JSON line:
per ring, alone and beside the threads, microseconds per record of
filling the empty ring (``push``: what the pushing thread pays) and of a
flood through it (``flood``: the copies' waits included), and one hot
numpy copy of a record for scale.  Host only: the arena is plain memory
unless ``--pinned`` (needs CUDA).
"""

from __future__ import annotations

import argparse
import json
import threading
import time
import typing

import numpy as np
import torch

from flink_tensorflow_tpu_torch.native.ring import TensorRing
from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, spec

SHAPE = (299, 299, 3)
CAPACITY = 1024


def push_all(ring: TensorRing, records, n: int) -> typing.Tuple[float, float]:
    """Seconds per record of filling the empty ring (the pushes alone),
    and of ``n`` pushes through it (the waits for copies included)."""
    def push(i):
        rec = {"image": records[i % len(records)]}
        if not ring.try_push(rec):
            ring.release(ring.claim_batch(CAPACITY)[1])
            ring.try_push(rec)

    t0 = time.perf_counter()
    for i in range(CAPACITY):
        push(i)
    fill = (time.perf_counter() - t0) / CAPACITY
    ring.release(ring.claim_batch(CAPACITY)[1])
    t0 = time.perf_counter()
    for i in range(n):
        push(i)
    ring.release(ring.claim_batch(CAPACITY)[1])
    return fill, (time.perf_counter() - t0) / n


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--threads", type=int, default=6)
    parser.add_argument("--records", type=int, default=2048)
    parser.add_argument("--pinned", action="store_true")
    args = parser.parse_args()
    records = [np.random.RandomState(i).randint(0, 256, SHAPE, dtype=np.uint8)
               for i in range(8)]
    stop = threading.Event()

    def lane():
        x = torch.zeros(64)
        while not stop.is_set():
            x = x + 1

    out = {"threads": args.threads, "records": args.records, "pinned": args.pinned}
    for name, native in (("native", True), ("python", False)):
        ring = TensorRing(RecordSchema({"image": spec(SHAPE, np.uint8)}), CAPACITY,
                          native=native, pinned=args.pinned)
        push_all(ring, records, CAPACITY)      # touch the arena
        fill, flood = push_all(ring, records, args.records)
        out[f"{name}_push_alone_us"], out[f"{name}_flood_alone_us"] = fill * 1e6, flood * 1e6
        stop.clear()
        threads = [threading.Thread(target=lane, daemon=True) for _ in range(args.threads)]
        for t in threads:
            t.start()
        try:
            fill, flood = push_all(ring, records, args.records)
            out[f"{name}_push_beside_threads_us"] = fill * 1e6
            out[f"{name}_flood_beside_threads_us"] = flood * 1e6
        finally:
            stop.set()
            for t in threads:
                t.join()
        ring.close()
    dst = np.empty_like(records[0])
    t0 = time.perf_counter()
    for _ in range(200):
        dst[...] = records[0]
    out["hot_numpy_copy_us"] = (time.perf_counter() - t0) / 200 * 1e6
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
