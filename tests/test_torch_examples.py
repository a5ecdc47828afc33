"""The port's job scripts (``flink_tensorflow_tpu_torch/examples/``) run in
smoke mode on the CPU, held to the reference's jobs where weights can be
carried across.

Twins of ``tests/test_examples.py`` (the same assertions; the port's
``resnet_dp_train`` trains on a mesh of one device, one device per
process, where the reference's ``--cpu`` made 8 virtual devices) and of
``tests/test_lint_clean.py``'s plan gates (the port's analyzer,
shardcheck and statecheck over each port example: no ERROR).  The two
cohort jobs run as real processes on the host.

Held to the reference, each on the reference's own weights (its init for
seed 0, carried as numpy):

- ``inception_inference``: the five sample labels equal the reference
  job's, and every record's logits agree with the reference model's
  serve method to 3e-2 of their largest magnitude (bf16, as in
  ``tests/test_torch_inception.py``);
- ``widedeep_online``: the reported first and last losses agree with
  the reference job's to 3e-2 relative (bf16 training);
- ``llm_serving_pipeline``: every session's tokens equal those of the
  reference's pipeline, built here without its ``abstract_mesh`` line
  (which raises under jax 0.9, ROADMAP queue 3).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("flax")

import jax

from _torch_ports import free_ports
from flink_tensorflow_tpu_torch.analysis import Severity, analyze, capture_plan, format_diagnostics
from flink_tensorflow_tpu_torch.examples import (
    bilstm_stream,
    distributed_keyed_pipeline,
    inception_inference,
    llm_serving_pipeline,
    mnist_lenet,
    multihost_dp_train,
    resnet_dp_train,
    split_source_pipeline,
    widedeep_online,
)

sys.path.insert(0, ".")

SMOKE = ["--smoke", "--cpu"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the smoke runs, with tests/test_examples.py's assertions ------------------

def test_mnist_lenet():
    out = mnist_lenet.main(SMOKE)
    assert out["records"] == 32 and sum(out["label_histogram"].values()) == 32


def test_widedeep_online():
    out = widedeep_online.main(SMOKE)
    assert out["steps"] >= 16
    assert out["loss_last"] < out["loss_first"]


def test_bilstm_stream():
    out = bilstm_stream.main(SMOKE)
    assert out["records"] == 24 and 0.0 <= out["positive_fraction"] <= 1.0


def test_resnet_dp_train():
    out = resnet_dp_train.main(SMOKE)
    assert out["devices"] == 1 and out["steps"] == 4
    assert out["loss_last"] < out["loss_first"]


def test_inception_inference():
    out = inception_inference.main(SMOKE)
    assert out["records"] == 16 and len(out["sample_labels"]) == 5


def test_inception_inference_through_a_bundle_and_the_2pc_sink(tmp_path):
    bundle, committed = str(tmp_path / "bundle"), str(tmp_path / "out")
    direct = inception_inference.main(SMOKE)
    out = inception_inference.main(SMOKE + ["--bundle-dir", bundle, "--output-dir", committed])
    assert os.path.isdir(bundle)
    assert out["sample_labels"] == direct["sample_labels"]
    assert out["committed_records"] == 16


def test_llm_serving_pipeline():
    out = llm_serving_pipeline.main(SMOKE)
    assert out["sessions"] == 8
    assert out["tokens"] == 8 * 8
    assert out["all_sessions_completed"]


def test_split_source_pipeline():
    out = split_source_pipeline.main(SMOKE)
    assert out["records"] == 64
    assert sum(out["splits_per_subtask"].values()) == 8
    assert out["every_subtask_got_work"]
    assert out["window_chain"] == ["replay", "window", "collect"]


def test_distributed_keyed_pipeline_across_two_processes(tmp_path):
    ports = ",".join(map(str, free_ports(2)))
    out = str(tmp_path / "out")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT)
    cmd = [sys.executable, "-m", "flink_tensorflow_tpu_torch.examples.distributed_keyed_pipeline",
           "--ports", ports, "--out", out]
    peer = subprocess.Popen(cmd + ["--index", "1", "--chk", str(tmp_path / "c1")], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        lead = subprocess.run(cmd + ["--index", "0", "--chk", str(tmp_path / "c0")], env=env,
                              capture_output=True, text=True, timeout=120)
        assert peer.wait(timeout=60) == 0
    finally:
        peer.kill()
    assert lead.returncode == 0, lead.stdout + lead.stderr
    assert "committed records: 256" in lead.stdout
    assert lead.stdout.count("n=32 mean=") == distributed_keyed_pipeline.NUM_KEYS


def test_multihost_dp_train_restarts_the_cohort_once(tmp_path):
    out = multihost_dp_train.main(["--cpu", "--work-dir", str(tmp_path)])
    assert out["cohort_attempts"] == 2
    assert out["global_devices"] == 2
    assert out["restored_checkpoint"] == 2
    assert out["steps_final_attempt"] == 8
    assert out["losses_agree_across_workers"]
    assert out["aggregate"]["workers_reporting"] == [0, 1]


def test_more_devices_per_worker_than_a_process_holds_is_refused():
    with pytest.raises(ValueError, match="one device per worker process"):
        multihost_dp_train.main(["--cpu", "--devices-per-worker", "4"])


# -- held to the reference's jobs on the reference's weights -----------------------

def test_inception_labels_and_logits_match_the_reference_job():
    from examples import inception_inference as ref_job
    from flink_tensorflow_tpu.models import get_model_def as jax_model_def

    want = ref_job.main(SMOKE)
    jdef = jax_model_def("inception_v3", num_classes=10)
    variables = jax.tree.map(np.asarray, jax.jit(jdef.init_fn)(jax.random.key(0)))
    results = []
    got = inception_inference.run(inception_inference.parse(SMOKE), variables, results)
    assert got["sample_labels"] == want["sample_labels"]
    images = np.stack([r["image"] for r in inception_inference.synthetic_images(16, 299)])
    ref_logits = np.asarray(jax.jit(jdef.methods["serve"].fn)(variables, {"image": images})
                            ["logits"])
    logits = np.stack([r["logits"] for r in results])
    assert np.abs(logits - ref_logits).max() <= 3e-2 * np.abs(ref_logits).max()


def test_widedeep_losses_match_the_reference_job():
    from examples import widedeep_online as ref_job
    from flink_tensorflow_tpu.models import get_model_def as jax_model_def

    want = ref_job.main(SMOKE)
    jdef = jax_model_def("widedeep", **widedeep_online.CONFIG)
    variables = jax.tree.map(np.asarray,
                             jdef.init_fn(jax.random.fold_in(jax.random.key(0), 0)))
    args = widedeep_online.parse(SMOKE)
    mdef = widedeep_online.model_def(args)
    mdef = dataclasses.replace(mdef, init_fn=lambda seed: mdef.load_fn(variables))
    got = widedeep_online.run(args, mdef)
    assert got["steps"] == want["steps"]
    for key in ("loss_first", "loss_last"):
        assert abs(got[key] - want[key]) <= 3e-2 * abs(want[key]), key


def reference_serving_tokens(args):
    """The reference's serving job (``examples/llm_serving_pipeline.py``)
    on its own weights, without the ``abstract_mesh`` declaration."""
    from examples import llm_serving_pipeline as ref_job
    from flink_tensorflow_tpu import StreamExecutionEnvironment, serving
    from flink_tensorflow_tpu.models import get_model_def
    from flink_tensorflow_tpu.sources import PacedSplitSource

    mdef = get_model_def("char_transformer", vocab_size=ref_job.VOCAB, embed_dim=64,
                         num_heads=4, num_layers=2, capacity=64)
    params = mdef.init_params(jax.random.PRNGKey(0))
    model = mdef.to_model(params)
    requests = [serving.GenerateRequest(session_id=f"user-{i}",
                                        prompt=ref_job.encode(ref_job.PROMPTS[i % 8]),
                                        max_new_tokens=8)
                for i in range(args.records)]
    env = StreamExecutionEnvironment(parallelism=1)
    events = serving.continuous_batching(
        env.from_source(PacedSplitSource(requests, rate_hz=50.0, num_splits=4),
                        name="sessions", parallelism=1).key_by(lambda r: r.session_id),
        model,
        config=serving.ServingConfig(max_active_seqs=8, token_budget=256, capacity=64),
        name="continuous_batching", parallelism=1).sink_to_list()
    env.execute("llm-serving", timeout=600)
    return jax.tree.map(np.asarray, params), {(e.session_id, e.index): e.token for e in events}


def test_serving_tokens_equal_the_reference_pipeline():
    args = llm_serving_pipeline.parse(SMOKE)
    params, want = reference_serving_tokens(args)
    events = []
    out = llm_serving_pipeline.run(args, params, events)
    assert out["all_sessions_completed"]
    assert {(e.session_id, e.index): e.token for e in events} == want
    assert len(want) == 8 * 8


# -- the plan gates of tests/test_lint_clean.py -------------------------------------

PLANNED = {
    "mnist_lenet": (mnist_lenet, SMOKE),
    "widedeep_online": (widedeep_online, SMOKE),
    "bilstm_stream": (bilstm_stream, SMOKE),
    "resnet_dp_train": (resnet_dp_train, SMOKE),
    "inception_inference": (inception_inference, SMOKE),
    "split_source_pipeline": (split_source_pipeline, SMOKE),
    "llm_serving_pipeline": (llm_serving_pipeline, SMOKE),
    "distributed_keyed_pipeline": (distributed_keyed_pipeline,
                                   ["--index", "0", "--ports", "7711,7712"]),
}

GATES = {
    "analyzer": lambda d: True,
    "purity": lambda d: d.rule == "replay-purity",
    "shardcheck": lambda d: d.rule.startswith("shardcheck"),
    "statecheck": lambda d: d.rule.startswith("statecheck") or d.rule == "exactly-once-boundary",
}


@pytest.mark.parametrize("gate", sorted(GATES))
@pytest.mark.parametrize("job", sorted(PLANNED))
def test_example_plans_have_no_error_diagnostics(job, gate):
    module, argv = PLANNED[job]
    env = capture_plan(lambda: module.main(list(argv)))
    diags = [d for d in analyze(env.graph, config=env.config) if GATES[gate](d)]
    errors = [d for d in diags if d.severity == Severity.ERROR]
    assert errors == [], format_diagnostics(diags)
