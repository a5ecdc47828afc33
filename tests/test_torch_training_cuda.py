"""Training in the port on the card (``cuda``-marked; they skip without an
NVIDIA GPU).  This file imports neither flax nor the JAX package, so it
collects on a machine that has neither.

- ``make_mesh({"data": 1})`` is ``cuda:0``; the gang trains there and its
  steps equal the CPU's plain path at f32 with TF32 off (loss 1e-5
  relative, params 1e-5 of the largest |param| after 3 adam steps with
  ``eps=1e-3``: see ``tests/test_torch_resnet.py`` for why not 1e-8).
- The online function trains on the card by default, and its losses
  equal a CPU run's (f32, 1e-5 relative).
- A gang snapshot taken on the card is a host copy, restores onto the
  card, and the restored gang continues with the uninterrupted one's
  params, bit for bit.
"""

import numpy as np
import pytest
import torch

from flink_tensorflow_tpu_torch import StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.functions.training_function import (
    DPTrainWindowFunction,
    OnlineTrainFunction,
)
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.parallel import optim
from flink_tensorflow_tpu_torch.parallel.mesh import make_mesh
from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, spec
from flink_tensorflow_tpu_torch.tensors.value import TensorValue

RESNET = dict(num_classes=4, image_size=32, width=8, stage_sizes=(1, 1), compute_dtype="float32")
WIDEDEEP = dict(hash_buckets=50, embed_dim=4, num_cat_slots=2, num_dense=3, num_wide=8,
                hidden=(8,), compute_dtype="float32")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def images(n=32):
    rng = np.random.RandomState(0)
    return [TensorValue({"image": (rng.rand(32, 32, 3) * 0.2 + (i % 4) * 0.25).astype(np.float32),
                         "label": np.int32(i % 4)}) for i in range(n)]


IMAGE_SCHEMA = RecordSchema({"image": spec((32, 32, 3)), "label": spec((), np.int32)})


def gang(mesh, recs, restore=None):
    kept = []

    class Kept(DPTrainWindowFunction):
        def clone(self):
            dup = super().clone()
            kept.append(dup)
            return dup

    env = StreamExecutionEnvironment(parallelism=1)
    env.set_mesh(mesh)
    f = Kept(get_model_def("resnet50", **RESNET), optim.adam(1e-2, eps=1e-3),
             train_schema=IMAGE_SCHEMA, global_batch=8)
    out = env.from_collection(recs).count_window(8).apply(f, name="dp").sink_to_list()
    if restore is not None:
        f.restore_state(restore)   # the prototype's clone carries it into the job
    env.execute(timeout=300)
    return out, kept[-1]


@pytest.mark.cuda
def test_gang_on_the_card_matches_the_cpu(card):
    mesh = make_mesh({"data": 1})
    assert mesh.device == torch.device("cuda", 0)
    out, f = gang(mesh, images(24))
    ref_out, ref = gang(make_mesh({"data": 1}, devices=["cpu"]), images(24))
    got, want = [float(r["loss"]) for r in out], [float(r["loss"]) for r in ref_out]
    assert len(got) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)
    a, b = f.current_params()["params"], ref.current_params()["params"]
    peak = max(float(t.abs().max()) for t in b.values())
    assert max(float((a[k] - b[k]).abs().max()) for k in b) <= 1e-5 * peak


@pytest.mark.cuda
def test_gang_snapshot_is_a_host_copy_and_restores_on_the_card(card):
    mesh = make_mesh({"data": 1})
    _, f = gang(mesh, images(16))
    snap = f.snapshot_state()
    assert all(t.device.type == "cpu" for t in snap["state"]["variables"]["params"].values())
    restored_out, restored = gang(mesh, images(32)[16:], restore=snap)
    _, straight = gang(mesh, images(32))
    assert [int(r["step"]) for r in restored_out] == [3, 4]
    a, b = restored.current_params(), straight.current_params()
    for coll in ("params", "batch_stats"):
        for k in b[coll]:
            assert torch.equal(a[coll][k], b[coll][k]), k


@pytest.mark.cuda
def test_online_training_runs_on_the_card_by_default(card):
    rng = np.random.RandomState(0)
    recs = [TensorValue({"wide": rng.rand(8).astype(np.float32),
                         "dense": rng.rand(3).astype(np.float32),
                         "cat": rng.randint(0, 50, (2,)).astype(np.int32),
                         "label": np.int32(i % 2)}, meta={"user": i % 3}) for i in range(48)]
    schema = RecordSchema({"wide": spec((8,)), "dense": spec((3,)), "cat": spec((2,), np.int32),
                           "label": spec((), np.int32)})
    losses = {}
    for where in ("cuda", "cpu"):
        env = StreamExecutionEnvironment(parallelism=1)
        if where == "cpu":
            env.set_device_provider(lambda task, index: "cpu")
        out = (env.from_collection(recs).key_by(lambda r: r.meta["user"])
               .process(OnlineTrainFunction(get_model_def("widedeep", **WIDEDEEP),
                                            optim.adam(1e-2), train_schema=schema,
                                            mini_batch=4, steps_per_dispatch=2), name="train")
               .sink_to_list())
        result = env.execute(timeout=300)
        losses[where] = [float(r["loss"]) for r in out]
        if where == "cuda":
            assert result.metrics["train.0.device_bytes_at_open"]["count"] == 1
    assert len(losses["cuda"]) == 12
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)
