"""Whole runs at a small size on the CPU (the look for a card skipped),
clean and with the timed path broken underneath: each fault a cell can
have turns ``correct`` false, and a clean run keeps it true.  The limits
here are this size's own, set from the clean runs' readings; the
cells' own limits (``limits/<cell>.json``) are the card's (PERF.md)."""

import dataclasses
import time

import pytest
import torch

from benchmark import jobs, run, spec
from benchmark.tests.tiny import tiny_root

CPU = torch.device("cpu")
#: Clean readings at this size: logit_err about 0.05; grad_gap under
#: 0.1, update_gap about 0.1.  (The batch moments, from 4 records at
#: 32 px, are not compared here.)
LIMITS = {"logit_err": 0.2, "grad_gap": 0.6, "update_gap": 0.5}


def _run(tmp_path, workload, seconds=1.0):
    cell = spec.cell(workload, tiny_root(tmp_path, LIMITS))
    cell.mix["check_sample"] = 10_000      # judge every result of the window
    return run.measure(cell, 2**31 + 77, seconds, False, CPU, t_origin=time.monotonic(), age=0.0)


def _patched_def(monkeypatch, change):
    real = jobs.get_model_def

    def fake(arch, **kw):
        return change(real(arch, **kw))

    monkeypatch.setattr(jobs, "get_model_def", fake)


@pytest.mark.parametrize("workload", ["inception-stream", "resnet50-train"])
def test_clean_runs_are_correct(tmp_path, workload):
    result = _run(tmp_path, workload)
    assert result["correct"], result["checked"]
    assert result["failed"] == 0 and result["attempted"] > 0


def test_an_answer_altered_where_it_is_produced_is_not_correct(tmp_path, monkeypatch):
    def alter(mdef):
        method = mdef.methods["serve"]

        def serve(module, inputs):
            out = dict(method.fn(module, inputs))
            logits = out["logits"].clone()
            logits[0] = logits[0].roll(1)      # the first record of every batch
            out["logits"], out["label"] = logits, logits.argmax(-1).to(torch.int32)
            return out

        return dataclasses.replace(
            mdef, methods={"serve": dataclasses.replace(method, fn=serve)})

    _patched_def(monkeypatch, alter)
    result = _run(tmp_path, "inception-stream")
    assert not result["correct"]
    assert result["checked"]["logit_err"]["value"] > LIMITS["logit_err"]


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(tmp_path, monkeypatch):
    from flink_tensorflow_tpu_torch.parallel import optim

    monkeypatch.setattr(optim.Adam, "apply_", lambda self, grads, state, params: None)
    result = _run(tmp_path, "resnet50-train")
    assert not result["correct"]
    assert result["checked"]["update_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_not_correct(tmp_path, monkeypatch):
    def halve(mdef):
        loss_fn = mdef.loss_fn

        def half(module, batch, generator):
            n = len(batch["label"]) // 2
            return loss_fn(module, {k: v[:n] for k, v in batch.items()}, generator)

        return dataclasses.replace(mdef, loss_fn=half)

    _patched_def(monkeypatch, halve)
    result = _run(tmp_path, "resnet50-train")
    assert not result["correct"]
    assert result["checked"]["grad_gap"]["value"] > LIMITS["grad_gap"]


@pytest.mark.parametrize("fault", ["lost", "twice", "not-a-number"])
def test_a_window_step_lost_sent_twice_or_not_a_number_is_not_correct(tmp_path, monkeypatch,
                                                                      fault):
    """Past the checked first steps: step 6 of the window, at the
    program's emit."""
    import numpy as np

    from flink_tensorflow_tpu_torch.functions import training_function

    real = training_function.DPTrainWindowFunction._drain

    class Altered:
        def __init__(self, out):
            self.out = out

        def collect(self, value):
            if int(value["step"]) == 6:
                if fault == "lost":
                    return
                if fault == "twice":
                    self.out.collect(value)
                if fault == "not-a-number":
                    value = value.replace(loss=np.float32("nan"))
            self.out.collect(value)

    monkeypatch.setattr(training_function.DPTrainWindowFunction, "_drain",
                        lambda self, out, keep: real(self, Altered(out), keep))
    result = _run(tmp_path, "resnet50-train")
    assert not result["correct"]
    assert result["failed"] > 0 and result["checked"]["update_gap"]["value"] < LIMITS["update_gap"]
