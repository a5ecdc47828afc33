"""The control of ``correct``: the plain reference put in the program's
place, computed a precision below the configuration's (fp8 operands for
a bfloat16 configuration, ``reference/arith.py``), or with a fault
planted in it, and held to the same numbers as a run.

    python3 -m benchmark.control --workload <name> --seeds 1,2,3 [--fault half-batch]

Prints one JSON line per seed with every number ``check.py`` reads, and
``correct`` as the harness's own verdict (``check.verdict``) gives it at
the cell's limits (``limits/<cell>.json``): the control has to come out
not correct, and the command exits 1 where it does not.  An inference cell's control reads the same number of records a run
samples, drawn from the pool by the seed; a training cell's takes the
run's first steps on the run's batches.  ``--fault half-batch`` (training
only) keeps the reference's precision and takes each step's loss as the
mean over the first half of the batch alone.  The benchmark's runs do not
run this; it sets the upper readings the limits are chosen under
(``PERF.md``).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def _half_batch(batches):
    return [(p[: len(p) // 2], y[: len(y) // 2]) for p, y in batches]


def readings(cell, seed: int, device: torch.device, *, fault: str = "") -> dict:
    """The control's numbers for ``cell`` at ``seed``."""
    from benchmark import check, load, weights
    from benchmark.reference import arith

    config, mix = cell.config, cell.mix
    arith.no_tf32()
    shape = (config["image_size"], config["image_size"], 3)
    ref = weights.reference_module(config, seed, device)
    if mix["job"] == "train":
        batch = int(config["train_batch_per_worker"])
        pool = load.pool(seed, mix["pool"], shape, salt=2)
        labels = (np.arange(len(pool)) % int(config["num_classes"])).astype(np.int32)
        n = int(mix["check_steps"])
        batches = [(pool[np.arange(k * batch, (k + 1) * batch) % len(pool)],
                    labels[np.arange(k * batch, (k + 1) * batch) % len(pool)]) for k in range(n)]
        opt = config["optimizer"]
        kw = dict(rng=weights.derive(seed, 5), lr=opt["learning_rate"], b1=opt["b1"],
                  b2=opt["b2"], eps=opt["eps"], device=device)
        p0 = [p.detach().clone() for p in ref.parameters()]
        exact = check.reference_steps(ref, batches, **kw)
        if fault == "half-batch":
            other = check.reference_steps(ref, _half_batch(batches), **kw)
        else:
            other = check.reference_steps(ref, batches, arith=arith.Fp8(), **kw)
        return check.train_numbers(other[0], exact[0], other[1], exact[1],
                                   [a - p for a, p in zip(other[2], p0)],
                                   [a - p for a, p in zip(exact[2], p0)], other[3], exact[3])
    if fault:
        raise ValueError(f"fault {fault!r} is for training cells")
    pool = load.pool(seed, mix["pool"], shape, salt=1)
    rng = np.random.default_rng([seed, 3])
    picked = pool[rng.integers(0, len(pool), int(mix["check_sample"]))]
    exact = check.reference_logits(ref, picked, device)
    low = check.reference_logits(ref, picked, device, arith=arith.Fp8())
    return check.forward_numbers(exact, low, low.argmax(axis=1))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--fault", default="", choices=("", "half-batch"))
    args = parser.parse_args(argv)
    from benchmark import check, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    passed = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers = readings(cell, seed, torch.device("cuda", 0), fault=args.fault)
        correct, shown, _ = check.verdict(numbers, cell.limits, 0)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.fault or "fp8", "correct": correct,
                          "checked": shown, **numbers}), flush=True)
        passed += correct
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
