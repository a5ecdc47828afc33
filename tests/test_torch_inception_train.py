"""The port's Inception-v3 ``loss_fn`` (train mode) held to the JAX
package's on the same weights and batches.

Flax ``variables`` come from ``tests/test_torch_inception.py:
flax_variables`` (numpy from a seed) at 75 px and 10 classes; the batch
is 8 rows of which the last 2 are padding (``valid`` 0), so the loss and
accuracy are masked while every row enters batch norm's moments, as in
both packages.  Dropout is 0 on both sides: the JAX side runs the
reference's own ``loss_fn`` from ``build`` with its module class bound to
``dropout_rate=0``; the port's def gets a module with ``dropout_rate=0``.

Tolerances:

- f32 (float images normalized on the host; the reference's f32 module):
  the loss to 1e-4 relative (read 1.4e-5); accuracy equal; the new
  running statistics to 1e-5 of their largest magnitude (read 3.7e-7)
  and their update ``new - old`` to 1e-3 by norm (read 2.2e-4).
- bf16 (the reference's own definition, uint8 input): train-mode batch
  norm over 8 rows re-scales each layer's rounding differences to unit
  size, so the two packages drift apart with depth.  Each unit's
  statistics update is held against the reference's own precision gap
  at that unit: the distance by norm between the reference's bf16 update
  and its f32 update on the same uint8 batch.  The port's update may be
  at most twice that gap from the reference's bf16 one at every unit
  (read at most 1.55 times it, in block 2); in the first four stem units
  at most half of it (read 0.13-0.24 times), so a port that ran the
  bf16 path at f32 (about 1 gap) fails.  Past the stem the drift of
  rounding fills the gap, so no tighter bound holds there.  The whole
  net's loss carries no precision signal at this size: the net ends on
  1 x 1 maps, and reversing the batch's rows (another summation order)
  moves the port's own bf16 logits 47% by norm and the reference's 49%;
  it is held to 25% (read 17%) only as a check of the head and the
  masked mean.
- Gradients at f32: each block type alone (ConvBN, InceptionA-C,
  ReductionA-B; train mode, a random cotangent) to 1e-5 by norm per conv
  kernel (read at most 1.3e-6).  Through the whole net the f32 rounding
  differences grow with depth, from 1.3e-3 by norm at the head to 7% at
  the stem (read 6.3-8.2% over five sizes, batches and inits): both
  packages take batch norm's variance as flax does, ``E[x^2] - E[x]^2``,
  which cancels where a channel's mean dwarfs its spread.  Against the
  port's own f64 gradient on this batch the reference's f32 gradient
  read 7.8% and the port's 1.9% (one reading), so most of the distance
  is the reference's rounding.  The whole-net gradient is held to 0.1 by
  norm and the head's to 5e-3.  One ``DPTrainWindowFunction``
  step with SGD at lr 1 (the update is minus the gradient) is held to
  that gradient, and to the port's own autograd of ``loss_fn`` on the
  same batch to 1e-6 by norm.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

pytest.importorskip("flax")

import jax
import jax.numpy as jnp

from flink_tensorflow_tpu.functions.training_function import (
    _train_batch_arrays as jax_batch_arrays,
)
from flink_tensorflow_tpu.models import get_model_def as jax_model_def
from flink_tensorflow_tpu.models.zoo import inception as jinc
from flink_tensorflow_tpu.tensors import BucketPolicy as JaxPolicy
from flink_tensorflow_tpu.tensors import RecordSchema as JaxSchema
from flink_tensorflow_tpu.tensors import TensorValue as JaxValue
from flink_tensorflow_tpu.tensors import spec as jax_spec
from flink_tensorflow_tpu_torch.core import StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.functions import DPTrainWindowFunction
from flink_tensorflow_tpu_torch.functions.training_function import _train_batch_arrays
from flink_tensorflow_tpu_torch.models import get_model_def
from flink_tensorflow_tpu_torch.models.convert import inception_from_flax
from flink_tensorflow_tpu_torch.models.zoo import inception as pinc
from flink_tensorflow_tpu_torch.models.zoo.inception import InceptionV3
from flink_tensorflow_tpu_torch.parallel import make_mesh, optim
from flink_tensorflow_tpu_torch.tensors import BucketPolicy, RecordSchema, TensorValue, spec
from test_torch_inception import flax_variables

SIZE = 75
CLASSES = 10
ROWS, VALID = 8, 6


def jax_def(dtype, uint8_input=None):
    """The reference's ``inception_v3`` def, its module bound to ``dtype``
    and ``dropout_rate=0`` (``build`` names the class at call time); uint8
    input at bf16 unless ``uint8_input`` says otherwise."""
    if uint8_input is None:
        uint8_input = dtype == jnp.bfloat16
    orig = jinc.InceptionV3
    jinc.InceptionV3 = functools.partial(orig, compute_dtype=dtype, dropout_rate=0.0)
    try:
        return jax_model_def("inception_v3", num_classes=CLASSES, image_size=SIZE,
                             uint8_input=uint8_input)
    finally:
        jinc.InceptionV3 = orig


def port_def(dtype: str, variables):
    """The port's def at ``dtype``, with ``dropout_rate=0`` and the
    reference's weights as its initial state."""
    mdef = get_model_def("inception_v3", num_classes=CLASSES, image_size=SIZE,
                         uint8_input=dtype == "bfloat16", compute_dtype=dtype)
    tdtype = torch.float32 if dtype == "float32" else torch.bfloat16

    def make_module():
        return InceptionV3(CLASSES, tdtype, dropout_rate=0.0)

    return dataclasses.replace(
        mdef, make_module=make_module,
        init_fn=lambda seed: inception_from_flax(variables, make_module()),
        load_fn=lambda params: inception_from_flax(params, make_module()))


@pytest.fixture(scope="module")
def variables():
    return flax_variables(jax_def(jnp.bfloat16), 0)


def batch(dtype: str, seed: int = 1):
    rng = np.random.RandomState(seed)
    image = rng.randint(0, 256, (ROWS, SIZE, SIZE, 3)).astype(np.uint8)
    if dtype == "float32":
        image = image.astype(np.float32) / np.float32(127.5) - np.float32(1.0)
    label = rng.randint(0, CLASSES, ROWS).astype(np.int32)
    valid = np.array([1.0] * VALID + [0.0] * (ROWS - VALID), np.float32)
    return {"image": image, "label": label, "valid": valid}


def run_both(dtype: str, variables):
    arrays = batch(dtype)
    jdef = jax_def(jnp.float32 if dtype == "float32" else jnp.bfloat16)
    jloss, (jstate, jm) = jax.jit(jdef.loss_fn)(variables, arrays, jax.random.key(0))
    mdef = port_def(dtype, variables)
    module = mdef.build_module(variables)
    with torch.no_grad():
        loss, (state, m) = mdef.loss_fn(module, {k: torch.from_numpy(v) for k, v in arrays.items()},
                                        torch.Generator())
    want = mdef.make_module()
    inception_from_flax({"params": variables["params"],
                         "batch_stats": jax.tree.map(np.asarray, jstate["batch_stats"])}, want)
    return (float(jloss), jm, dict(want.named_buffers())), \
        (float(loss), m, state["batch_stats"], dict(module.named_buffers()))


def update_distance(got, want, start, names) -> float:
    diff = sum(float((got[n].double() - want[n].double()).square().sum()) for n in names)
    size = sum(float((want[n].double() - start[n].double()).square().sum()) for n in names)
    return (diff / size) ** 0.5


def test_loss_fn_f32_matches_the_reference(variables):
    (jloss, jm, want), (loss, m, stats, start) = run_both("float32", variables)
    assert set(stats) == set(want) == set(start)
    assert abs(loss - jloss) <= 1e-4 * abs(jloss)
    assert float(m["accuracy"]) == float(jm["accuracy"])
    assert float(m["loss"]) == loss
    peak = max(float(w.abs().max()) for w in want.values())
    assert max(float((stats[n] - want[n]).abs().max()) for n in want) <= 1e-5 * peak
    assert update_distance(stats, want, start, list(want)) <= 1e-3


def reference_f32_stats(variables):
    """The reference's new running statistics from its f32 module on the
    bf16 case's uint8 batch, as the port's buffers."""
    jdef = jax_def(jnp.float32, uint8_input=True)
    _, (jstate, _) = jax.jit(jdef.loss_fn)(variables, batch("bfloat16"), jax.random.key(0))
    want = InceptionV3(CLASSES, torch.float32)
    inception_from_flax({"params": variables["params"],
                         "batch_stats": jax.tree.map(np.asarray, jstate["batch_stats"])}, want)
    return dict(want.named_buffers())


def test_loss_fn_bf16_matches_the_reference(variables):
    (jloss, _, want), (loss, _, stats, start) = run_both("bfloat16", variables)
    want_f32 = reference_f32_stats(variables)
    assert set(stats) == set(want) == set(want_f32)
    units = list(dict.fromkeys(n.rsplit(".", 1)[0] for n in want))
    assert len(units) == 94
    for unit in units:
        names = [f"{unit}.mean", f"{unit}.var"]
        got = update_distance(stats, want, start, names)
        gap = update_distance(want, want_f32, start, names)
        bound = 0.5 if unit in ("stem.0", "stem.1", "stem.2", "stem.3") else 2.0
        assert got <= bound * gap, (unit, got, gap)
    assert abs(loss - jloss) <= 0.25 * abs(jloss)


def test_the_valid_mask_keeps_pad_rows_out_of_the_loss(variables):
    mdef = port_def("float32", variables)
    module = mdef.build_module(variables)
    arrays = {k: torch.from_numpy(v) for k, v in batch("float32").items()}
    flipped = dict(arrays, label=arrays["label"].clone())
    flipped["label"][VALID:] = (flipped["label"][VALID:] + 1) % CLASSES
    with torch.no_grad():
        a = mdef.loss_fn(module, arrays, torch.Generator())
        b = mdef.loss_fn(module, flipped, torch.Generator())
    assert float(a[0]) == float(b[0])
    assert float(a[1][1]["accuracy"]) == float(b[1][1]["accuracy"])


def test_dropout_draws_from_the_callers_generator(variables):
    """Train-mode dropout: the same generator seed gives the same loss,
    another seed another one, and eval mode draws nothing."""
    mdef = get_model_def("inception_v3", num_classes=CLASSES, image_size=SIZE,
                         compute_dtype="float32")
    module = mdef.build_module(variables)
    assert module.dropout_rate == 0.2
    arrays = {k: torch.from_numpy(v) for k, v in batch("float32").items()}
    with torch.no_grad():
        losses = [float(mdef.loss_fn(module, arrays, torch.Generator().manual_seed(s))[0])
                  for s in (3, 3, 4)]
    assert losses[0] == losses[1] != losses[2]


def _block_pairs():
    return [
        ("ConvBN", lambda: jinc.ConvBN(32, (3, 3), padding="SAME", compute_dtype=jnp.float32),
         lambda: pinc.ConvBN(16, 32, (3, 3), padding="SAME"), 9),
        ("InceptionA", lambda: jinc.InceptionA(32, jnp.float32), lambda: pinc.InceptionA(16, 32), 9),
        ("ReductionA", lambda: jinc.ReductionA(jnp.float32), lambda: pinc.ReductionA(16), 9),
        ("InceptionB", lambda: jinc.InceptionB(8, jnp.float32), lambda: pinc.InceptionB(16, 8), 9),
        ("ReductionB", lambda: jinc.ReductionB(jnp.float32), lambda: pinc.ReductionB(16), 9),
        ("InceptionC", lambda: jinc.InceptionC(jnp.float32), lambda: pinc.InceptionC(16), 5),
    ]


@pytest.mark.parametrize("name,jmake,pmake,hw", _block_pairs(), ids=[b[0] for b in _block_pairs()])
def test_block_train_gradients_match_flax(name, jmake, pmake, hw):
    rng = np.random.RandomState(0)
    x = rng.standard_normal((8, hw, hw, 16)).astype(np.float32)
    jmod, pmod = jmake(), pmake()
    variables = jmod.init(jax.random.key(0), x)
    # Batch norm's scale, bias and statistics moved off their init values;
    # the kernels kept zero-mean (a shared positive shift would make each
    # conv output's mean dwarf its spread, and flax's E[x^2] - E[x]^2
    # would cancel in both packages, each in its own summation order).
    variables = jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a) + (0.0 if path[-1].key == "kernel" else
                                         0.1 * rng.rand(*a.shape).astype(np.float32)),
        variables)
    y0, _ = jmod.apply(variables, x, train=True, mutable=["batch_stats"])
    cot = rng.standard_normal(y0.shape).astype(np.float32)

    def loss(params):
        y, _ = jmod.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                          train=True, mutable=["batch_stats"])
        return jnp.sum(y * cot)

    grads = jax.grad(loss)(variables["params"])
    units = [""] if name == "ConvBN" else [f"convs.{c}." for c in range(len(pmod.convs))]
    state = {}
    for c, prefix in enumerate(units):
        p = variables["params"] if name == "ConvBN" else variables["params"][f"ConvBN_{c}"]
        st = (variables["batch_stats"] if name == "ConvBN"
              else variables["batch_stats"][f"ConvBN_{c}"])
        state[prefix + "weight"] = torch.from_numpy(
            np.asarray(p["Conv_0"]["kernel"])).permute(3, 2, 0, 1).contiguous()
        for key in ("scale", "bias"):
            state[prefix + key] = torch.from_numpy(np.asarray(p["BatchNorm_0"][key]))
        for key in ("mean", "var"):
            state[prefix + key] = torch.from_numpy(np.asarray(st["BatchNorm_0"][key]))
    pmod.load_state_dict(state)
    y = pmod(torch.from_numpy(x).permute(0, 3, 1, 2), {})
    (y.permute(0, 2, 3, 1) * torch.from_numpy(cot)).sum().backward()
    modules = dict(pmod.named_modules())
    for c, prefix in enumerate(units):
        g = grads if name == "ConvBN" else grads[f"ConvBN_{c}"]
        want = torch.from_numpy(np.asarray(g["Conv_0"]["kernel"])).permute(3, 2, 0, 1)
        got = modules[prefix.rstrip(".")].weight.grad
        assert float((got - want).norm() / want.norm()) <= 1e-5, (name, c)


def test_one_dp_train_window_step_matches_the_reference_gradient(variables):
    arrays = batch("float32")
    records = [{"image": arrays["image"][i], "label": arrays["label"][i]} for i in range(ROWS)]
    # The reference's gradient of its own loss_fn on the same batch assembly.
    jschema = JaxSchema({"image": jax_spec((SIZE, SIZE, 3)), "label": jax_spec((), np.int32)})
    _, ja = jax_batch_arrays([JaxValue(r) for r in records], jschema, JaxPolicy(fixed_batch=ROWS))
    jdef = jax_def(jnp.float32)

    def jloss(params):
        return jdef.loss_fn({"params": params, "batch_stats": variables["batch_stats"]}, ja,
                            jax.random.key(0))[0]

    jgrad = jax.jit(jax.grad(jloss))(variables["params"])
    want = InceptionV3(CLASSES, torch.float32)
    inception_from_flax({"params": jax.tree.map(np.asarray, jgrad),
                         "batch_stats": variables["batch_stats"]}, want)
    want = {n: p.detach() for n, p in want.named_parameters()}

    schema = RecordSchema({"image": spec((SIZE, SIZE, 3)), "label": spec((), np.int32)})
    _, pa = _train_batch_arrays([TensorValue(r) for r in records], schema,
                                BucketPolicy(fixed_batch=ROWS))
    for k in ja:
        np.testing.assert_array_equal(pa[k], np.asarray(ja[k]))
    mdef = port_def("float32", variables)
    # The port's own autograd of loss_fn on that batch.
    module = mdef.build_module(variables).train()
    loss, _ = mdef.loss_fn(module, {k: torch.from_numpy(v) for k, v in pa.items()},
                           torch.Generator())
    loss.backward()
    direct = {n: p.grad for n, p in module.named_parameters()}
    start = {n: p.detach() for n, p in module.named_parameters()}
    kept = []

    class Kept(DPTrainWindowFunction):
        def clone(self):
            dup = super().clone()
            kept.append(dup)
            return dup

    env = StreamExecutionEnvironment(parallelism=1)
    env.set_mesh(make_mesh({"data": 1}, devices=["cpu"]))
    out = (env.from_collection([TensorValue(r) for r in records]).count_window(ROWS)
           .apply(Kept(mdef, optim.sgd(1.0), train_schema=schema, global_batch=ROWS),
                  name="dp_train")
           .sink_to_list())
    env.execute(timeout=300)
    assert [int(r["step"]) for r in out] == [1]
    stepped = kept[-1].current_params()["params"]
    got = {n: start[n] - stepped[n] for n in start}   # SGD at lr 1: minus the gradient
    assert norm_distance(got, direct, list(start)) <= 1e-6
    assert norm_distance(got, want, list(start)) <= 0.1
    assert norm_distance(got, want, ["head.weight", "head.bias"]) <= 5e-3


def norm_distance(got, want, names) -> float:
    diff = sum(float((got[n].double() - want[n].double()).square().sum()) for n in names)
    return (diff / sum(float(want[n].double().square().sum()) for n in names)) ** 0.5
