"""The benchmark is driven by data: cells, configurations, mixes and
metrics are found by name, ``BENCHMARK.json`` keeps to its contract, and
a new configuration, mix or metric needs only new files and entries."""

import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import jobs, run, spec
from benchmark.reference.count import PEAK_FLOPS
from benchmark.tests.tiny import HERE, ROOT, tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_contract_keys_and_names():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for name in names + metrics + [w["traffic"] for w in bench["workloads"]]:
        assert NAME.match(name), name
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


@pytest.mark.parametrize("workload", [w["name"] for w in _bench()["workloads"]])
def test_every_cell_resolves_and_reports_what_its_layers_move(workload):
    cell = spec.cell(workload)
    assert cell.chips == 1
    e2e = {m.name for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m.moves in e2e, (m.name, m.moves)
    assert jobs.kind(cell.mix["job"], cell.base).kind == cell.mix["job"]
    assert cell.limits and all(limit > 0 for limit in cell.limits.values())


def test_every_metric_has_a_reader():
    bench = _bench()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.load_reader(m["name"]))


def test_a_new_config_mix_and_metric_are_files_and_entries(tmp_path):
    """In a (small) copy: a new configuration, mix, job kind, metric and
    cell, added as files and entries alone, are found by name and run; no
    file there is edited."""
    root = tiny_root(tmp_path)
    bench_dir = os.path.join(root, "benchmark")
    before = {}
    for base, _, files in os.walk(bench_dir):
        for name in files:
            path = os.path.join(base, name)
            before[path] = open(path, "rb").read()
    with open(os.path.join(bench_dir, "configs", "resnet-50.json")) as f:
        config = json.load(f)
    config["stage_sizes"] = config["port"]["stage_sizes"] = [1, 1, 2, 1]
    config["reference"]["kwargs"]["stage_sizes"] = [1, 1, 2, 1]
    with open(os.path.join(bench_dir, "configs", "resnet-50-deeper.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(bench_dir, "mixes", "train-closed.json")) as f:
        mix = json.load(f)
    mix["check_steps"] = 2
    mix["job"] = "train_counted"
    with open(os.path.join(bench_dir, "mixes", "train-closed-short.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(bench_dir, "kinds", "train_counted.py"), "w") as f:
        f.write("from benchmark.kinds import train\n\n\n"
                "class Counted(train.TrainJob):\n"
                "    def sink(self, record):\n"
                "        self.results = getattr(self, 'results', 0) + 1\n"
                "        super().sink(record)\n\n\nJOB = Counted\n")
    with open(os.path.join(bench_dir, "limits", "resnet50-train-short.json"), "w") as f:
        json.dump({"grad_gap": 1e9, "update_gap": 1e9}, f)
    with open(os.path.join(bench_dir, "metrics", "steps_per_s.train.py"), "w") as f:
        f.write("def read(job):\n    return job.in_window(job.t0, job.t1) / job.batch / "
                "job.seconds\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "resnet-50-deeper",
                             "source": "https://arxiv.org/abs/1512.03385",
                             "file": "benchmark/configs/resnet-50-deeper.json", "reduced": [],
                             "why": "another depth"})
    bench["workloads"].append({"name": "resnet50-train-short", "config": "resnet-50-deeper",
                               "traffic": "train-closed-short", "chips": 1, "why": "two steps"})
    bench["per_layer"].append({"name": "steps_per_s.train", "unit": "steps/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "train function", "moves": "train_records_per_s",
                               "workloads": ["resnet50-train-short"]})
    for m in bench["end_to_end"]:
        if m["name"] == "train_records_per_s":
            m["workloads"].append("resnet50-train-short")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    cell = spec.cell("resnet50-train-short", root)
    assert cell.config["stage_sizes"] == [1, 1, 2, 1] and cell.mix["check_steps"] == 2
    assert set(cell.limits) == {"grad_gap", "update_gap"}
    result = run.measure(cell, 5, 1.0, True, torch.device("cpu"), t_origin=time.monotonic(),
                         age=0.0)
    assert result["correct"] and result["metrics"]["steps_per_s.train"]["value"] > 0
    assert set(result["checked"]) == {"failed", "grad_gap", "update_gap"}
    assert all(open(p, "rb").read() == data for p, data in before.items())
    # The cells already there see nothing of it.
    assert "steps_per_s.train" not in {m.name for m in spec.cell("resnet50-train", root)
                                       .per_layer}


#: Run in the copy, whose ``benchmark`` package is the one imported: both
#: runs of the new cell on the CPU, and what each job read.
_TOKEN_RUNS = """
import json, time
import torch
from benchmark import jobs, run, spec

made = []
real = jobs.kind


def kind(name, base=spec.HERE):
    class Seen(real(name, base)):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)
    return Seen


jobs.kind = kind
cell = spec.cell("tiny-decoder-serve")
out = []
for trace in (False, True):
    result = run.measure(cell, 2**31 + 11, 1.5, trace, torch.device("cpu"),
                         t_origin=time.monotonic(), age=0.0)
    job = made[-1]
    out.append({"result": result, "base": job.cell.base,
                "in_window": job.in_window(job.t0, job.t1), "seconds": job.seconds,
                "flops": job.count.flops if trace else None,
                "slice_rate": job.slice_records / job.slice.window_s if trace else None})
print(json.dumps(out))
"""


def test_a_token_sequence_config_kind_mix_and_metric_are_files_and_entries(tmp_path):
    """In a (small) copy: a configuration whose records are token sequences
    (its plain decoder in the copy's ``reference/``, weights made per
    tensor), a ``serve`` kind driving ``continuous_batching`` in a closed
    loop of sessions, its mix, limits, a cell listed in ``records_per_s``
    and a per-layer metric, all from ``tests/token_cell`` as files and
    entries alone: the end-to-end rate and the per-layer metric are read,
    the traced count is the kind's own (a request's prefill and decode
    steps), and no file that was in the copy changed."""
    root = tiny_root(tmp_path)
    bench_dir = os.path.join(root, "benchmark")
    before = {}
    for base, _, files in os.walk(bench_dir):
        for name in files:
            path = os.path.join(base, name)
            before[path] = open(path, "rb").read()
    new = os.path.join(HERE, "token_cell")
    for base, _, files in os.walk(new):
        for name in files:
            assert not os.path.exists(os.path.join(bench_dir, os.path.relpath(base, new), name))
    shutil.copytree(new, bench_dir, dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny-decoder", "source": "https://arxiv.org/abs/1706.03762",
                             "file": "benchmark/configs/tiny-decoder.json", "reduced": [],
                             "why": "a decoder served through the serving plane"})
    bench["workloads"].append({"name": "tiny-decoder-serve", "config": "tiny-decoder",
                               "traffic": "serve-closed", "chips": 1,
                               "why": "closed loop of 8 sessions, 12-token prompts, 6 tokens"})
    bench["per_layer"].append({"name": "mfu_pct.serve", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "whole step",
                               "moves": "records_per_s", "workloads": ["tiny-decoder-serve"]})
    for m in bench["end_to_end"]:
        if m["name"] == "records_per_s":
            m["workloads"].append("tiny-decoder-serve")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([root, ROOT])}
    proc = subprocess.run([sys.executable, "-c", _TOKEN_RUNS], capture_output=True, text=True,
                          cwd=root, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    plain, traced = json.loads(proc.stdout.strip().splitlines()[-1])
    assert plain["base"] == bench_dir   # the copy's harness ran, not this one
    for run_ in (plain, traced):
        result = run_["result"]
        assert result["correct"] and result["failed"] == 0, result["checked"]
        assert set(result["checked"]) == {"failed", "token_gap"}
    rate = plain["result"]["metrics"]["records_per_s"]["value"]
    assert rate > 0 and rate == plain["in_window"] / plain["seconds"]
    assert set(plain["result"]["metrics"]) == {"records_per_s", "setup_s"}
    # A request: a 12-token prefill (logits of the last position alone),
    # then 5 decode steps over caches of 13 to 17 positions; 2 layers of
    # width 32, MLP 128, vocabulary 48.
    d, mlp, vocab, layers, prompt = 32, 128, 48, 2, 12
    prefill = layers * (8 * prompt * d * d + 4 * prompt * prompt * d + 4 * prompt * d * mlp)
    decode = sum(layers * (8 * d * d + 4 * cache * d + 4 * d * mlp)
                 for cache in range(prompt + 1, prompt + 6))
    assert traced["flops"] == prefill + decode + 6 * 2 * d * vocab
    mfu = traced["result"]["metrics"]["mfu_pct.serve"]["value"]
    assert mfu == pytest.approx(100 * traced["flops"] * traced["slice_rate"] / PEAK_FLOPS)
    assert mfu > 0
    assert all(open(p, "rb").read() == data for p, data in before.items())
    # The cells already there see nothing of it.
    assert "mfu_pct.serve" not in {m.name for m in spec.cell("inception-stream", root).per_layer}


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")

