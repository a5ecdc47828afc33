"""A copy of the benchmark at sizes a CPU test can run.

``tiny_root(tmp)`` copies ``BENCHMARK.json`` and the benchmark's folder
into ``tmp`` and shrinks, in the copy only, what the CPU cannot run at
full size: image sizes, classes, ResNet's width and depth, pools,
windows and lanes.  Limits are set wide open unless given, so a test
reads the numbers themselves.
"""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)

CONFIGS = {
    "inception-v3": {"image_size": 75, "num_classes": 10, "train_batch_per_worker": 4,
                     "port": {"num_classes": 10, "image_size": 75, "uint8_input": True,
                              "compute_dtype": "bfloat16"},
                     "reference": {"module": "inception_v3", "class": "InceptionV3",
                                   "kwargs": {"num_classes": 10, "dropout": 0.2}}},
    "resnet-50": {"image_size": 32, "num_classes": 10, "width": 8, "stage_sizes": [1, 1, 1, 1],
                  "train_batch_per_worker": 4,
                  "port": {"num_classes": 10, "image_size": 32, "width": 8,
                           "stage_sizes": [1, 1, 1, 1], "uint8_input": True,
                           "compute_dtype": "bfloat16"},
                  "reference": {"module": "resnet50", "class": "ResNet50",
                                "kwargs": {"num_classes": 10, "width": 8,
                                           "stage_sizes": [1, 1, 1, 1]}}},
}
MIXES = {
    "closed-w128": {"pool": 16, "outstanding": 16, "window": 4, "transfer_lanes": 2,
                    "pipeline_depth": 2, "warmup_records": 8, "check_sample": 8, "trace_slice_s": 0.3},
    "train-closed": {"pool": 24, "outstanding_steps": 3, "warmup_steps": 4, "trace_slice_s": 0.3},
}
OPEN = {"logit_err": 1e9, "label_gap": 1e9, "loss_gap": 1e9, "grad_gap": 1e9,
        "update_gap": 1e9, "moments_err": 1e9}


def _update(path: str, changes: dict) -> dict:
    with open(path) as f:
        data = json.load(f)
    data.update(changes)
    with open(path, "w") as f:
        json.dump(data, f)
    return data


def tiny_root(tmp: str, limits: dict = None) -> str:
    """A shrunken copy of the benchmark under ``tmp``; returns its root."""
    root = os.path.join(str(tmp), "checkout")
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    for name, changes in CONFIGS.items():
        path = os.path.join(root, "benchmark", "configs", name + ".json")
        _update(path, changes)
    table = limits or OPEN
    for name in os.listdir(os.path.join(root, "benchmark", "limits")):
        path = os.path.join(root, "benchmark", "limits", name)
        with open(path) as f:
            data = json.load(f)
        with open(path, "w") as f:
            json.dump({k: table[k] for k in data if k in table}, f)
    for name, changes in MIXES.items():
        _update(os.path.join(root, "benchmark", "mixes", name + ".json"), changes)
    return root
