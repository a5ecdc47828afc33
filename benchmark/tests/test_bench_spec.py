"""The benchmark is driven by data: cells, configurations, mixes and
metrics are found by name, ``BENCHMARK.json`` keeps to its contract, and
a new configuration, mix or metric needs only new files and entries."""

import json
import os
import re
import time

import pytest
import torch

from benchmark import jobs, run, spec
from benchmark.tests.tiny import ROOT, tiny_root

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


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")

