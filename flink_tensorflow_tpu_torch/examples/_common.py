"""Shared plumbing for the port's job scripts: flags, device choice,
synthetic records and the report line.

Port of ``examples/_common.py``.  The flags and the report's JSON fields
are the reference's; ``--cpu`` asks for the host (``device="cpu"``), as
every entry point of the port needs it asked for, and there are no
virtual devices.  Records come from the same ``np.random.RandomState``
calls as the reference's, so both packages' jobs see the same data.
"""

from __future__ import annotations

import argparse
import json
import time
import typing

import numpy as np

from flink_tensorflow_tpu_torch.tensors.value import TensorValue


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--records", type=int, default=256, help="stream length")
    p.add_argument("--batch", type=int, default=32, help="micro-batch / window size")
    p.add_argument("--parallelism", type=int, default=1)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the card, which must be present)")
    p.add_argument("--smoke", action="store_true", help="tiny sizes for CI")
    return p


def place(env, args):
    """Point every subtask of ``env`` at the job's device: the host under
    ``--cpu``; without it the runners resolve the card themselves."""
    if args.cpu:
        env.set_device_provider(lambda task, index: "cpu")
    return env


def synthetic_images(n: int, size: int, channels: int = 3, seed: int = 0
                     ) -> typing.List[TensorValue]:
    """Deterministic image records: ``rand(size, size, channels)`` f32
    per record from ``RandomState(seed)``, ``meta={"id": i}``."""
    rng = np.random.RandomState(seed)
    return [TensorValue({"image": rng.rand(size, size, channels).astype(np.float32)}, {"id": i})
            for i in range(n)]


def report(job: str, metrics: dict, t0: float, records: int, extra: dict = None):
    """One JSON line: wall time, records/s, the worst subtask's p50/p99
    record latency and the job's own fields."""
    wall = time.time() - t0
    out = {
        "job": job,
        "records": records,
        "wall_s": round(wall, 3),
        "records_per_s": round(records / wall, 2) if wall > 0 else None,
    }
    out.update(extra or {})
    p50s, p99s = [], []
    for key, value in metrics.items():
        if key.endswith("record_latency_s") and isinstance(value, dict):
            p50s.append(value["p50"])
            p99s.append(value["p99"])
    if p50s:
        out["p50_latency_ms"] = round(max(p50s) * 1e3, 3)
        out["p99_latency_ms"] = round(max(p99s) * 1e3, 3)
        if len(p50s) > 1:
            out["latency_aggregation"] = f"max over {len(p50s)} subtasks"
    print(json.dumps(out))
    return out
