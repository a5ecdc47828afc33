"""The port's ResNet and its train step held to the JAX package on the
same weights, optimizer state and batches.

A tiny ResNet (width 8, stages (1, 1), 32x32 uint8 images, 10 classes)
is initialised by flax; its variables and the optax adam state cross to
the port through ``models/convert.py:train_state_from_jax``.  The batch
is assembled by each package's own ``_train_batch_arrays`` from 6 records
padded to 8 (pad rows replay record 0: they enter the batch-norm
statistics, and the ``valid`` mask keeps them out of the loss).  The
second stage's 3x3 stride-2 conv sees an 8x8 input, so flax's asymmetric
``"SAME"`` padding ``(0, 1)`` is exercised; the running variance moves
with the biased batch variance.

Tolerances, each relative to the largest magnitude in the compared
collection (the loss, all params, all batch stats), or by norm where
said (``||port - jax|| / ||jax||``, of what the steps changed):

- f32 (the JAX side built as ``ResNet(compute_dtype=jnp.float32)``):
  1e-5, and the running statistics' update ``s - s0`` to 1e-5 by norm.
  Both sides sum f32 products in another order.  The f32 cases feed f32
  images normalised on the host: with uint8 input, XLA fuses the bf16
  normalisation into the f32 stem conv at a precision that is neither
  bf16 nor f32 (4e-4 off the rounded input, 9e-3 off the unrounded one,
  at these shapes), which no port can match to 1e-5.
- bf16 (the reference's own definition): the loss, the params and the
  statistics' update by norm to 3e-2.  Every conv and batch norm rounds
  its output to bf16 after summing in another order.  A gradient keeps
  few correct bits at bf16 (a batch-norm gradient is a sum with heavy
  cancellation): JAX's own bf16 step lands 4-28% (by norm) from the f32
  step at these shapes, so the params' update ``p - p0`` and the adam
  moments are held by that distance: the port's bf16 step may be at most
  1.25 times as far from JAX's bf16 step as that is from the port's f32
  step on the same uint8 batches (read: 0.83-1.04 times).  That distance
  stays below 1 / 1.25, so a state the steps left unchanged (which reads
  1) fails.

The steps use adam with ``eps=1e-3``.  At optax's default 1e-8, a
gradient element within rounding of zero steps its param by up to
``lr`` either way (one such element of the stem's BN bias moved 9e-4 at
f32 while the moments agreed to 4e-6): the comparison would measure
adam's amplification, not the step.  With ``eps=1e-3`` a gradient
difference moves a param by at most ``lr`` times that difference over
``eps``.  The optimizer's arithmetic at the default eps is held to optax
on identical gradients in ``tests/test_torch_training.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("flax")

import jax
import jax.numpy as jnp
import optax

from flink_tensorflow_tpu.functions.training_function import (
    _train_batch_arrays as jax_batch_arrays,
)
from flink_tensorflow_tpu.models import get_model_def as jax_model_def
from flink_tensorflow_tpu.models.zoo import resnet as jresnet
from flink_tensorflow_tpu.models.zoo._common import weighted_metrics as jax_weighted
from flink_tensorflow_tpu.parallel.dp import init_train_state as jax_init_state
from flink_tensorflow_tpu.parallel.dp import make_train_step as jax_train_step
from flink_tensorflow_tpu.tensors import BucketPolicy as JaxPolicy
from flink_tensorflow_tpu.tensors import RecordSchema as JaxSchema
from flink_tensorflow_tpu.tensors import TensorValue as JaxValue
from flink_tensorflow_tpu.tensors import spec as jax_spec
from flink_tensorflow_tpu_torch.functions.training_function import _train_batch_arrays
from flink_tensorflow_tpu_torch.models.convert import train_state_from_jax
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.models.zoo.resnet import same_padding
from flink_tensorflow_tpu_torch.parallel import dp, optim
from flink_tensorflow_tpu_torch.tensors.batching import BucketPolicy
from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, spec
from flink_tensorflow_tpu_torch.tensors.value import TensorValue

CFG = dict(num_classes=10, image_size=32, width=8, stage_sizes=(1, 1))
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
BF16_NOISE_FACTOR = 1.25
LR = 1e-3
EPS = 1e-3


def jax_resnet_def(dtype: str):
    """The JAX package's ResNet def; at f32 the same def on
    ``ResNet(compute_dtype=jnp.float32)`` with ``resnet.py:106-118``'s loss."""
    jdef = jax_model_def("resnet50", uint8_input=dtype == "bfloat16", **CFG)
    if dtype == "bfloat16":
        return jdef
    module = jresnet.ResNet(stage_sizes=CFG["stage_sizes"], num_classes=CFG["num_classes"],
                            width=CFG["width"], compute_dtype=jnp.float32)

    def init_fn(rng):
        return module.init(rng, jnp.zeros((1, 32, 32, 3)), train=False)

    def loss_fn(variables, batch, rng):
        logits, new_state = module.apply(variables, batch["image"], train=True,
                                         mutable=["batch_stats"])
        labels = batch["label"]
        per_ex = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
        hits = (jnp.argmax(logits, -1) == labels).astype(jnp.float32)
        loss, acc = jax_weighted(per_ex, hits, batch.get("valid"))
        return loss, (new_state, {"loss": loss, "accuracy": acc})

    return dataclasses.replace(jdef, module=module, init_fn=init_fn, loss_fn=loss_fn)


def perturb(variables, seed: int):
    """Batch-norm scales, biases and running statistics moved off their
    init values (so no block's last BN is the zero map)."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        a = np.asarray(leaf)
        if name == "scale":
            return rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(fill, variables)


def batches(n_batches: int, dtype: str, seed: int = 0):
    """``n_batches`` pairs (JAX arrays, port arrays) of 6 records padded to
    8: uint8 images for bf16, f32 images normalised on the host for f32."""
    rng = np.random.RandomState(seed)
    image_dtype = np.uint8 if dtype == "bfloat16" else np.float32
    jschema = JaxSchema({"image": jax_spec((32, 32, 3), image_dtype),
                         "label": jax_spec((), np.int32)})
    schema = RecordSchema({"image": spec((32, 32, 3), image_dtype), "label": spec((), np.int32)})
    out = []
    for _ in range(n_batches):
        fields = []
        for _ in range(6):
            image = rng.randint(0, 256, (32, 32, 3)).astype(np.uint8)
            if dtype == "float32":
                image = image.astype(np.float32) / np.float32(127.5) - np.float32(1.0)
            fields.append({"image": image, "label": np.int32(rng.randint(10))})
        _, ja = jax_batch_arrays([JaxValue(f) for f in fields], jschema, JaxPolicy(fixed_batch=8))
        _, pa = _train_batch_arrays([TensorValue(f) for f in fields], schema,
                                    BucketPolicy(fixed_batch=8))
        out.append((ja, pa))
    return out


def rel(got: dict, want: dict) -> float:
    assert set(got) == set(want)
    peak = max(float(np.abs(np.asarray(w, np.float32)).max()) for w in want.values())
    return max(float(np.abs(got[k].float().numpy() - np.asarray(want[k], np.float32)).max())
               for k in want) / peak


def jax_state_np(state):
    return jax.tree.map(np.asarray, {k: v for k, v in state.items() if k != "rng"})


def norm_rel(got: dict, want: dict, start: dict = None) -> float:
    """``||got - want|| / ||want - start||`` (``start`` 0 by default), each
    tree taken as one vector."""
    assert set(got) == set(want)
    diff = sum(float((got[k].double() - want[k].double()).square().sum()) for k in want)
    size = sum(float((want[k].double() - (start[k].double() if start else 0)).square().sum())
               for k in want)
    return (diff / size) ** 0.5


@pytest.mark.parametrize("perturbed", [False, True], ids=["flax-init", "perturbed-bn"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adam_steps_match_jax(dtype, perturbed):
    jdef = jax_resnet_def(dtype)
    jopt = optax.adam(LR, eps=EPS)
    jstate = jax_init_state(jdef, jopt, jax.random.key(0))
    if perturbed:
        jstate["variables"] = jax.tree.map(jnp.asarray, perturb(jstate["variables"], 1))
    mdef = get_model_def("resnet50", compute_dtype=dtype, uint8_input=dtype == "bfloat16", **CFG)
    state = train_state_from_jax(jax_state_np(jstate), mdef)
    start = {c: {n: t.clone() for n, t in coll.items()}
             for c, coll in state["variables"].items()}
    jstep = jax.jit(jax_train_step(jdef, jopt))
    step = dp.make_train_step(mdef, optim.adam(LR, eps=EPS))
    if dtype == "bfloat16":
        # The port's f32 step on the same uint8 batches: what bf16 costs.
        f32_def = get_model_def("resnet50", compute_dtype="float32", uint8_input=True, **CFG)
        f32_state = train_state_from_jax(jax_state_np(jstate), f32_def)
        f32_step = dp.make_train_step(f32_def, optim.adam(LR, eps=EPS))
    tol = TOL[dtype]
    for i, (ja, pa) in enumerate(batches(3, dtype)):
        jstate, jm = jstep(jstate, ja)
        batch = {k: torch.from_numpy(v) for k, v in pa.items()}
        state, m = step(state, batch)
        want = train_state_from_jax(jax_state_np(jstate), mdef)
        assert int(state["step"]) == int(jstate["step"]) == i + 1
        assert abs(float(m["loss"]) - float(jm["loss"])) <= tol * abs(float(jm["loss"]))
        assert float(m["accuracy"]) == float(jm["accuracy"])
        for coll in ("params", "batch_stats"):
            assert rel(state["variables"][coll], want["variables"][coll]) <= tol, (i, coll)
        assert norm_rel(state["variables"]["batch_stats"], want["variables"]["batch_stats"],
                        start["batch_stats"]) <= tol, i
        if dtype == "float32":
            for moment in ("mu", "nu"):
                assert rel(state["opt_state"][moment], want["opt_state"][moment]) <= tol, \
                    (i, moment)
        else:
            f32_state, _ = f32_step(f32_state, batch)
            pairs = {"update": (state["variables"]["params"], want["variables"]["params"],
                                f32_state["variables"]["params"], start["params"])}
            for moment in ("mu", "nu"):
                pairs[moment] = (state["opt_state"][moment], want["opt_state"][moment],
                                 f32_state["opt_state"][moment], None)
            for name, (got, ref, f32, origin) in pairs.items():
                noise = norm_rel(ref, f32, origin)
                assert BF16_NOISE_FACTOR * noise < 1, (i, name, noise)
                assert norm_rel(got, ref, origin) <= BF16_NOISE_FACTOR * noise, (i, name, noise)
        assert int(state["opt_state"]["count"]) == i + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_matches_jax(dtype):
    jdef = jax_resnet_def(dtype)
    variables = perturb(jdef.init_fn(jax.random.key(3)), 2)
    image = np.random.RandomState(4).randint(0, 256, (3, 32, 32, 3)).astype(np.uint8)
    if dtype == "float32":
        image = image.astype(np.float32) / np.float32(127.5) - np.float32(1.0)
    want = np.asarray(jax.jit(jdef.methods["serve"].fn)(variables, {"image": image})["logits"]) \
        if dtype == "bfloat16" else \
        np.asarray(jax.jit(lambda v, x: jdef.module.apply(v, x))(variables, image))
    mdef = get_model_def("resnet50", compute_dtype=dtype, uint8_input=dtype == "bfloat16", **CFG)
    with torch.inference_mode():
        got = mdef.methods["serve"].fn(mdef.to_model(variables).params,
                                       {"image": torch.from_numpy(image)})
    assert got["logits"].dtype == torch.float32
    err = np.abs(got["logits"].numpy() - want).max() / np.abs(want).max()
    assert err <= TOL[dtype]


@pytest.mark.parametrize("size,kernel,stride,want", [
    (56, 3, 2, (0, 1)), (28, 3, 2, (0, 1)), (7, 3, 2, (1, 1)), (56, 3, 1, (1, 1)),
    (56, 1, 2, (0, 0)), (7, 1, 2, (0, 0)), (112, 7, 2, (2, 3))])
def test_same_padding_is_flax_same(size, kernel, stride, want):
    assert same_padding(size, kernel, stride) == want
    x = np.random.RandomState(0).standard_normal((1, size, size, 1)).astype(np.float32)
    k = np.random.RandomState(1).standard_normal((kernel, kernel, 1, 1)).astype(np.float32)
    ref = jax.lax.conv_general_dilated(x, k, (stride, stride), "SAME",
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"))
    lo, hi = want
    xt = torch.nn.functional.pad(torch.from_numpy(x).permute(0, 3, 1, 2), (lo, hi, lo, hi))
    got = torch.nn.functional.conv2d(xt, torch.from_numpy(k).permute(3, 2, 0, 1), stride=stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=1e-5)


def test_initialiser_follows_flax_distributions():
    mdef = get_model_def("resnet50", **CFG)
    a, b = mdef.init_params(0), mdef.init_params(0)
    w = a.blocks[1].conv2.weight.detach()        # 3x3x16 -> 16
    assert torch.equal(w, b.blocks[1].conv2.weight)
    assert abs(float(w.std()) * np.sqrt(9 * 16) - 1.0) < 0.1
    for block in a.blocks:
        assert torch.equal(block.bn3.scale, torch.zeros_like(block.bn3.scale))
        assert torch.equal(block.bn1.scale, torch.ones_like(block.bn1.scale))
    assert torch.equal(a.head.bias, torch.zeros(10))
