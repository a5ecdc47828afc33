"""The port's LeNet held to the flax definition on the same weights, and
the MNIST example job held to the JAX package's.

Flax ``variables`` come from the JAX package's initialiser with every
bias drawn from a seeded normal (the initialiser's biases are zero, which
would not test them), carried into the port with
``models/convert.py:lenet_from_flax``.

Tolerances, relative to the largest magnitude of the reference output:

- f32: 1e-5 (both sides sum f32 products in another order; observed
  about 2e-7);
- bf16: 3e-2, as for Inception: every conv and Dense rounds its output to
  bf16 after summing in another order (observed about 2e-3).  Labels must
  agree wherever the reference's top-1/top-2 gap exceeds twice that.
- gradients, by norm (``||port - jax|| / ||jax||``) per parameter: f32
  1e-4 (observed about 1e-6); bf16 at most 1.5 times the JAX package's
  own distance between its bf16 and f32 gradients (two independent bf16
  roundings of one gradient are about sqrt(2) times as far apart as each
  is from it) or 1e-2, whichever is larger, and below 0.5, so a gradient
  of nothing fails.

The flatten before ``Dense_0`` is the trap this file exists for: flax
flattens NHWC, so a port that flattened NCHW would pass the shapes and
fail every comparison here.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("flax")

import jax
import jax.numpy as jnp

from flink_tensorflow_tpu import StreamExecutionEnvironment as JaxEnv
from flink_tensorflow_tpu.functions import ModelWindowFunction as JaxModelWindowFunction
from flink_tensorflow_tpu.models import get_model_def as jax_model_def
from flink_tensorflow_tpu.models.zoo.lenet import LeNet as JaxLeNet
from flink_tensorflow_tpu_torch.core.environment import StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.functions.model_function import ModelWindowFunction
from flink_tensorflow_tpu_torch.models.convert import lenet_from_flax
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.tensors.value import TensorValue

F32_TOL = 1e-5
BF16_TOL = 3e-2
GRAD_F32_TOL = 1e-4
GRAD_BF16_NOISE_FACTOR = 1.5
DTYPES = ("float32", "bfloat16")


def with_random_biases(variables, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: ((0.3 * rng.standard_normal(x.shape)).astype(x.dtype)
                         if path[-1].key == "bias" else np.asarray(x)), variables)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def rel_err(got, want) -> float:
    want = f32(want)
    return float(np.abs(f32(got) - want).max() / np.abs(want).max())


def norm_err(got, want) -> float:
    want = f32(want)
    return float(np.linalg.norm(f32(got) - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def variables():
    mdef = jax_model_def("lenet")
    return with_random_biases(jax.jit(mdef.init_fn)(jax.random.key(0)), 1)


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(0).rand(6, 28, 28, 1).astype(np.float32)


def jax_module(dtype):
    return JaxLeNet(compute_dtype=getattr(jnp, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_lenet_serve(variables, images, dtype):
    """Twin of ``tests/test_models.py::test_lenet_serve``, held to flax."""
    mdef = get_model_def("lenet", compute_dtype=dtype)
    model = mdef.to_model(variables)
    with torch.no_grad():
        out = mdef.methods["serve"].fn(model.params, {"image": torch.from_numpy(images)})
    assert out["logits"].shape == (6, 10) and out["logits"].dtype == torch.float32
    assert out["label"].shape == (6,) and out["label"].dtype == torch.int32
    np.testing.assert_allclose(out["prob"].sum(-1).numpy(), 1.0, rtol=1e-5)
    want = np.asarray(jax.jit(jax_module(dtype).apply)(variables, jnp.asarray(images)))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert rel_err(out["logits"], want) <= tol
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * tol * np.abs(want).max()
    assert clear.any()
    np.testing.assert_array_equal(out["label"].numpy()[clear], np.argmax(want, -1)[clear])


def test_the_bridge_is_exact_and_keeps_the_nhwc_flatten(variables):
    module = get_model_def("lenet").to_model(variables).params
    p = variables["params"]
    np.testing.assert_array_equal(module.conv1.weight.detach().numpy(),
                                  np.transpose(p["Conv_0"]["kernel"], (3, 2, 0, 1)))
    # Dense_0's rows carry over unpermuted: the module flattens (H, W, C).
    np.testing.assert_array_equal(module.fc1.weight.detach().numpy(), p["Dense_0"]["kernel"].T)
    np.testing.assert_array_equal(module.head.bias.detach().numpy(), p["Dense_2"]["bias"])


def grads_of(dtype, variables, batch):
    """(loss, grads) of the JAX loss_fn and the port's on one batch, the
    JAX gradients carried to the port's names by the bridge."""
    jdef = jax_model_def("lenet")
    module_j = jax_module(dtype)

    def jax_loss(params):
        import optax

        logits = module_j.apply({"params": params}, batch["image"])
        per_ex = optax.softmax_cross_entropy_with_integer_labels(logits, batch["label"])
        w = batch["valid"].astype(jnp.float32)
        return (per_ex * w).sum() / w.sum()

    if dtype == "bfloat16":  # the registered loss_fn is the bf16 module's
        jloss, _ = jdef.loss_fn(variables, batch, jax.random.key(0))
        assert float(jloss) == pytest.approx(float(jax_loss(variables["params"])), rel=1e-6)
    jloss, jgrads = jax.value_and_grad(jax_loss)(variables["params"])
    want = lenet_from_flax({"params": jax.tree.map(np.asarray, jgrads)},
                           get_model_def("lenet").make_module()).state_dict()
    mdef = get_model_def("lenet", compute_dtype=dtype)
    module = mdef.to_model(variables).params.train()
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss, (_, metrics) = mdef.loss_fn(module, tbatch, None)
    loss.backward()
    got = {n: p.grad for n, p in module.named_parameters()}
    return float(jloss), float(loss.detach()), want, got, float(metrics["accuracy"])


def test_loss_fn_and_gradients(variables, images):
    batch = {"image": jnp.asarray(images),
             "label": jnp.asarray(np.arange(6) % 10, jnp.int32),
             "valid": jnp.asarray([1, 1, 1, 1, 1, 0], jnp.float32)}
    jl32, pl32, want32, got32, acc = grads_of("float32", variables, batch)
    assert pl32 == pytest.approx(jl32, rel=F32_TOL)
    assert 0.0 <= acc <= 1.0
    for name in want32:
        assert norm_err(got32[name], want32[name]) <= GRAD_F32_TOL, name
    jl16, pl16, want16, got16, _ = grads_of("bfloat16", variables, batch)
    assert pl16 == pytest.approx(jl16, rel=BF16_TOL)
    for name in want16:
        noise = norm_err(want16[name], want32[name])   # the reference's own bf16 error
        err = norm_err(got16[name], want16[name])
        assert err <= max(GRAD_BF16_NOISE_FACTOR * noise, 1e-2) and err < 0.5, (name, err, noise)


def test_mnist_example_job_gives_the_jax_jobs_labels():
    """``examples/mnist_lenet.py --smoke`` (32 records of
    ``synthetic_images(32, 28, channels=1)``, ``rebalance ->
    count_window(8, timeout_s=0.02) -> ModelWindowFunction``, the JAX
    package's initial weights) through both packages: every id once, the
    same label."""
    from examples._common import synthetic_images

    jdef = jax_model_def("lenet")
    variables = jax.tree.map(np.asarray, jax.jit(jdef.init_fn)(jax.random.key(0)))
    records = synthetic_images(32, 28, channels=1)

    env = JaxEnv(parallelism=1)
    want = (env.from_collection(records, parallelism=1, schema=jdef.input_schema).rebalance()
            .count_window(8, timeout_s=0.02)
            .apply(JaxModelWindowFunction(jdef.to_model(variables)), name="lenet")
            .sink_to_list())
    env.execute("mnist-lenet-microbatch", timeout=600)

    env = StreamExecutionEnvironment(parallelism=1)
    env.set_device_provider(lambda task, index: "cpu")
    got = (env.from_collection([TensorValue(dict(r.fields), dict(r.meta)) for r in records],
                               parallelism=1).rebalance()
           .count_window(8, timeout_s=0.02)
           .apply(ModelWindowFunction(get_model_def("lenet").to_model(variables)), name="lenet")
           .sink_to_list())
    env.execute(timeout=600)
    assert sorted(r.meta["id"] for r in got) == list(range(32))
    assert {r.meta["id"]: int(r["label"]) for r in got} == \
        {r.meta["id"]: int(r["label"]) for r in want}
