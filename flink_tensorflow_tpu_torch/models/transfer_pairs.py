"""The ring against the list path, and six transfer lanes against one, on
the Inception streaming cell.

    python3 -m flink_tensorflow_tpu_torch.models.transfer_pairs [--rounds 6]

Runs the cell's job (``models/inception_cell.py``: 2,048 uint8 299x299x3
records, ``count_window(128)``, ``fixed_batch=128``, depth 6) on the GPU
in four arms: through the ring or the list path (``use_ring=False``), at
``transfer_lanes`` 6 (the bench's) or 1 (two lane threads, the port's
layout before the ring and the lanes).  One unmeasured run warms the
process; then each round runs every arm once, the order rotated round
by round, so no arm always runs first.  Each run's labels and scores are
held to the first run's bit for bit.  Prints one JSON line per run
(steady records/s as ``bench.py:_steady_rps`` cuts it, records/s over the
job, the summed host seconds of assembly and H2D enqueue per job, the
ring's batches) and a last line with, per arm, the median and range of
both rates, and, per pair of arms, the rounds one beat the other.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np

ARMS = (("ring6", 6, None), ("list6", 6, False), ("ring1", 1, None), ("list1", 1, False))


def run_arm(cell, model, records, lanes, use_ring):
    from flink_tensorflow_tpu_torch.models.stream_cell import steady_rps

    run = cell.run_cell_job(model, records, lanes=lanes, use_ring=use_ring)
    m = {k.split(".", 2)[2]: v for k, v in run.metrics.items() if k.startswith("inception.0.")}
    rps, _ = steady_rps(run.arrivals, cell.RECORDS, cell.BATCH, cell.trailing_exclude(cell.RECORDS))
    out = {r.meta["id"]: (int(r["label"]), float(r["score"])) for r in run.results}
    row = {"steady_rps": rps, "job_rps": cell.RECORDS / run.seconds,
           "assemble_sum_s": m["assemble_s"]["mean"] * m["assemble_s"]["count"],
           "h2d_sum_s": m["h2d_s"]["mean"] * m["h2d_s"]["count"],
           "dispatch_p50_ms": m["dispatch_s"]["p50"] * 1e3,
           "ring_batches": m.get("ring_batches", 0)}
    return row, out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("transfer_pairs: CUDA is not available; this script runs on the GPU",
              file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser()
    parser.add_argument("--rounds", type=int, default=6)
    args = parser.parse_args()
    torch.backends.cudnn.allow_tf32 = False
    from flink_tensorflow_tpu_torch.models import inception_cell as cell

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    _, model, _, records = cell.inception_cell(0)
    _, want = run_arm(cell, model, records, 6, None)      # warms the process
    rows = {name: [] for name, _, _ in ARMS}
    for k in range(args.rounds):
        order = ARMS[k % len(ARMS):] + ARMS[:k % len(ARMS)]
        if k % 2:
            order = order[::-1]
        for name, lanes, use_ring in order:
            row, got = run_arm(cell, model, records, lanes, use_ring)
            if got != want:
                print(f"transfer_pairs: {name} in round {k} differs from the first run",
                      file=sys.stderr)
                return 1
            rows[name].append(row)
            print(json.dumps({"round": k, "arm": name, **row, "card": card}), flush=True)
    summary = {}
    for name, runs in rows.items():
        for key in ("steady_rps", "job_rps"):
            v = [r[key] for r in runs]
            summary[f"{name}_{key}"] = {"median": float(np.median(v)), "min": min(v),
                                        "max": max(v)}
    wins = {}
    for i, (a, _, _) in enumerate(ARMS):
        for b, _, _ in ARMS[i + 1:]:
            wins[f"{a}>{b}_steady"] = sum(x["steady_rps"] > y["steady_rps"]
                                          for x, y in zip(rows[a], rows[b]))
    print(json.dumps({"rounds": args.rounds, "summary": summary, "wins": wins, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
