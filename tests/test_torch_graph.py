"""Frozen graphs: ``models/loaders.py:freeze_method`` and ``GraphLoader``,
and ``GraphWindowFunction`` / ``GraphMapFunction``, held to the JAX
package on the same weights (flax initialisers, carried over by
``models/convert.py``) and inputs (numpy seeds).

Tolerances: the port's frozen graph against the port's own model is
exact (the exported program runs the same ops on the same constants);
against the JAX package's frozen graph, bf16 as the LeNet and BiLSTM
twins hold their models: logits to 3e-2 of the largest |logit| (every
layer rounds to bf16 after summing in another order), and labels equal
wherever the JAX top-1/top-2 gap exceeds twice that share.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("flax")

import jax

from flink_tensorflow_tpu import StreamExecutionEnvironment as JaxEnv
from flink_tensorflow_tpu.functions import GraphMapFunction as JaxGraphMapFunction
from flink_tensorflow_tpu.functions import GraphWindowFunction as JaxGraphWindowFunction
from flink_tensorflow_tpu.models import freeze_method as jax_freeze_method
from flink_tensorflow_tpu.models import get_model_def as jax_model_def
from flink_tensorflow_tpu.tensors import TensorValue as JaxValue
from flink_tensorflow_tpu_torch.core.environment import StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.functions.model_function import (
    GraphMapFunction,
    GraphWindowFunction,
    ModelWindowFunction,
)
from flink_tensorflow_tpu_torch.models.loaders import GraphLoader, freeze_method
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.tensors.batching import BucketPolicy
from flink_tensorflow_tpu_torch.tensors.value import TensorValue

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_TOL = 3e-2
BILSTM = dict(vocab_size=50, embed_dim=8, hidden_dim=16)


@pytest.fixture(scope="module")
def lenet():
    jdef = jax_model_def("lenet")
    variables = jax.tree.map(np.asarray, jax.jit(jdef.init_fn)(jax.random.key(0)))
    images = np.random.RandomState(0).rand(10, 28, 28, 1).astype(np.float32)
    return jdef.to_model(variables), get_model_def("lenet").to_model(variables), images


@pytest.fixture(scope="module")
def bilstm():
    jdef = jax_model_def("bilstm", **BILSTM)
    variables = jax.tree.map(np.asarray, jax.jit(jdef.init_fn)(jax.random.key(1)))
    rng = np.random.RandomState(1)
    texts = [rng.randint(1, 50, (n,)).astype(np.int32) for n in (3, 16, 9, 1, 12, 7)]
    return jdef.to_model(variables), get_model_def("bilstm", **BILSTM).to_model(variables), texts


def cpu_env():
    env = StreamExecutionEnvironment(parallelism=1)
    env.set_device_provider(lambda task, index: "cpu")
    return env


def by_id(results, key="i"):
    return {r.meta[key]: r for r in results}


def hold_to_jax(got, want):
    """Port results against JAX results by id: logits within the bf16
    bar, labels equal where the JAX decision is clear."""
    assert sorted(got) == sorted(want)
    peak = max(float(np.abs(np.asarray(w["logits"], np.float32)).max()) for w in want.values())
    for i, w in want.items():
        wl = np.asarray(w["logits"], np.float32)
        gl = np.asarray(got[i]["logits"], np.float32)
        assert np.abs(gl - wl).max() <= BF16_TOL * peak, i
        top = np.sort(wl)[-2:]
        if top[1] - top[0] > 2 * BF16_TOL * peak:
            assert int(got[i]["label"]) == int(w["label"]), i


def run_window(env, records, function, batch):
    out = env.from_collection(records).count_window(batch).apply(function, name="g") \
        .sink_to_list()
    result = env.execute(timeout=120)
    return out, result


@pytest.mark.parametrize("transfer_lanes", [1, 2])
def test_lenet_graph_window_matches_jax_and_the_model(lenet, transfer_lanes):
    """``count_window(4) -> GraphWindowFunction`` (ten records: windows of
    4, 4 and 2, the last padded) in both packages; the port's results also
    equal its own ``ModelWindowFunction`` bit for bit, through the ring."""
    jmodel, model, images = lenet
    schema = model.method("serve").input_schema
    env = JaxEnv(parallelism=1)
    want = (env.from_collection([JaxValue({"image": im}, {"i": i}) for i, im in enumerate(images)])
            .count_window(4)
            .apply(JaxGraphWindowFunction(jax_freeze_method(jmodel, "serve", batch=4), batch=4,
                                          input_schema=jmodel.method("serve").input_schema))
            .sink_to_list())
    env.execute(timeout=120)
    records = [TensorValue({"image": im}, {"i": i}) for i, im in enumerate(images)]
    frozen = freeze_method(model, "serve", batch=4, device="cpu")
    got, result = run_window(cpu_env(), records, GraphWindowFunction(
        frozen, batch=4, input_schema=schema, transfer_lanes=transfer_lanes), 4)
    hold_to_jax(by_id(got), by_id(want))
    assert result.metrics["g.0.ring_batches"] == 3
    direct, _ = run_window(cpu_env(), records, ModelWindowFunction(
        model, policy=BucketPolicy(fixed_batch=4)), 4)
    direct = by_id(direct)
    for i, r in by_id(got).items():
        for k in ("logits", "label", "prob"):
            assert np.array_equal(r[k], direct[i][k]), (i, k)


def test_lenet_graph_map_matches_jax(lenet):
    """Per-record ``GraphMapFunction`` over a batch-1 graph, pipelined:
    arrival order kept, results held to the JAX ``GraphMapFunction``."""
    jmodel, model, images = lenet
    env = JaxEnv(parallelism=1)
    want = (env.from_collection([JaxValue({"image": im}, {"i": i}) for i, im in enumerate(images)],
                                parallelism=1)
            .map(JaxGraphMapFunction(jax_freeze_method(jmodel, "serve", batch=1),
                                     input_schema=jmodel.method("serve").input_schema,
                                     pipeline_depth=3))
            .sink_to_list())
    env.execute(timeout=120)
    env = cpu_env()
    got = (env.from_collection([TensorValue({"image": im}, {"i": i})
                                for i, im in enumerate(images)], parallelism=1)
           .map(GraphMapFunction(freeze_method(model, batch=1, device="cpu"),
                                 input_schema=model.method("serve").input_schema,
                                 pipeline_depth=3))
           .sink_to_list())
    env.execute(timeout=120)
    assert [r.meta["i"] for r in got] == list(range(len(images)))
    hold_to_jax(by_id(got), by_id(want))


def test_bilstm_graph_takes_lengths_at_one_bucket(bilstm):
    """A ``needs_lengths`` method frozen at length bucket 16: records of
    1-16 tokens pad to it, their lengths ride along, and the results hold
    to the JAX package's frozen BiLSTM and equal the port's own model."""
    jmodel, model, texts = bilstm
    env = JaxEnv(parallelism=1)
    want = (env.from_collection([JaxValue({"tokens": t}, {"i": i}) for i, t in enumerate(texts)])
            .count_window(4)
            .apply(JaxGraphWindowFunction(
                jax_freeze_method(jmodel, "serve", batch=4, length_bucket=16), batch=4,
                input_schema=jmodel.method("serve").input_schema, needs_lengths=True,
                length_bucket=16))
            .sink_to_list())
    env.execute(timeout=120)
    records = [TensorValue({"tokens": t}, {"i": i}) for i, t in enumerate(texts)]
    frozen = freeze_method(model, batch=4, length_bucket=16, device="cpu")
    got, result = run_window(cpu_env(), records, GraphWindowFunction(
        frozen, batch=4, input_schema=model.method("serve").input_schema, needs_lengths=True,
        length_bucket=16), 4)
    hold_to_jax(by_id(got), by_id(want))
    assert result.metrics.get("g.0.ring_batches", 0) == 0   # dynamic lengths: the list path
    from flink_tensorflow_tpu_torch.tensors.batching import BucketLadder

    direct, _ = run_window(cpu_env(), records, ModelWindowFunction(
        model, policy=BucketPolicy(fixed_batch=4, lengths=BucketLadder([16]))), 4)
    direct = by_id(direct)
    for i, r in by_id(got).items():
        assert np.array_equal(r["logits"], direct[i]["logits"]), i


def test_a_wrong_batch_is_refused_and_the_graph_loads_from_a_file(lenet, tmp_path):
    _, model, images = lenet
    frozen = freeze_method(model, batch=2, device="cpu")
    path = tmp_path / "lenet.pt2"
    path.write_bytes(frozen)
    call = GraphLoader(str(path)).load()
    x = torch.from_numpy(images)
    out = call({"image": x[:2]})
    with torch.no_grad():
        want = model.method("serve").fn(model.params.eval(), {"image": x[:2]})
    assert torch.equal(out["logits"], want["logits"])
    with pytest.raises((AssertionError, RuntimeError, ValueError)):
        call({"image": x[:3]})


def test_a_frozen_graph_runs_without_the_port():
    """The bytes load and run in a process that has torch and nothing of
    either package: the weights are constants of the program."""
    mdef = get_model_def("lenet")
    frozen = freeze_method(mdef.to_model(mdef.init_params(0)), batch=2, device="cpu")
    code = ("import io, sys, torch\n"
            "sys.modules['flink_tensorflow_tpu_torch'] = None\n"
            "sys.modules['flink_tensorflow_tpu'] = None\n"
            "ep = torch.export.load(io.BytesIO(sys.stdin.buffer.read()))\n"
            "assert not dict(ep.module().named_parameters())\n"
            "out = ep.module()({'image': torch.zeros(2, 28, 28, 1)})\n"
            "print(sorted(out), tuple(out['logits'].shape))\n")
    proc = subprocess.run([sys.executable, "-c", code], input=frozen, capture_output=True,
                          timeout=120, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    assert proc.stdout.decode().strip() == "['label', 'logits', 'prob'] (2, 10)"


def test_inception_graph_window_equals_the_model_window():
    """The card phase's shape on the CPU at 75 px: Inception frozen at
    batch 4 through ``GraphWindowFunction`` equals ``ModelWindowFunction``
    bit for bit (labels and scores)."""
    mdef = get_model_def("inception_v3", num_classes=4, image_size=75, uint8_input=True)
    model = mdef.to_model(mdef.init_params(0))
    rng = np.random.RandomState(3)
    records = [TensorValue({"image": rng.randint(0, 256, (75, 75, 3)).astype(np.uint8)}, {"i": i})
               for i in range(6)]
    frozen = freeze_method(model, batch=4, device="cpu")
    got, _ = run_window(cpu_env(), records, GraphWindowFunction(
        frozen, batch=4, input_schema=model.method("serve").input_schema), 4)
    direct, _ = run_window(cpu_env(), records, ModelWindowFunction(
        model, policy=BucketPolicy(fixed_batch=4), outputs=("label", "score")), 4)
    got, direct = by_id(got), by_id(direct)
    assert sorted(got) == list(range(6))
    for i in got:
        assert np.array_equal(got[i]["label"], direct[i]["label"])
        assert np.array_equal(got[i]["score"], direct[i]["score"])
