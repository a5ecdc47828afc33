"""The port's Inception-v3 held to the flax definition on the same weights.

Flax ``variables`` are made with numpy from a seed (He-scaled kernels;
batch-norm scale, bias, mean and var perturbed so BN is not the
identity and activations stay O(1)), run through the JAX package's
modules, and carried into the port with ``models/convert.py``.

Tolerances, relative to the largest magnitude of the reference output:

- f32: 1e-4.  Both sides sum f32 products in another order (observed
  about 1e-6 over the whole net).
- bf16: 3e-2.  Every conv rounds its output to bf16 (2**-8 relative)
  after summing in another order, and XLA keeps some intermediates in
  f32 where the port rounds them (observed about 6e-3 over the whole
  net).  Labels must agree wherever the reference's top-1/top-2 gap
  exceeds twice that tolerance.
"""

import numpy as np
import pytest
import torch

# The reference models are flax modules; where flax is absent (a GPU machine
# without it) the module skips instead of failing to collect.
pytest.importorskip("flax")

import jax
import jax.numpy as jnp

from flink_tensorflow_tpu.models import get_model_def as jax_model_def
from flink_tensorflow_tpu.models.zoo import inception as jinc
from flink_tensorflow_tpu.ops.preprocessing import inception_normalize as jax_normalize
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.ops.preprocessing import inception_normalize

F32_TOL = 1e-4
BF16_TOL = 3e-2
SIZE = 75
CLASSES = 10


def flax_variables(jax_def, seed: int):
    """Numpy flax ``variables`` of ``jax_def``'s shapes, from ``seed``."""
    shapes = jax.eval_shape(jax_def.init_fn, jax.random.key(0))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        raise KeyError(name)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def rel_err(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)).max()
                 / np.abs(np.asarray(want, np.float32)).max())


def assert_labels_agree(got_labels, want_logits, tol):
    """Labels equal wherever the reference's top-1/top-2 gap is clear."""
    want_logits = np.asarray(want_logits, np.float32)
    top2 = np.sort(want_logits, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * tol * np.abs(want_logits).max()
    assert clear.any()
    np.testing.assert_array_equal(np.asarray(got_labels)[clear],
                                  np.argmax(want_logits, -1)[clear])


@pytest.fixture(scope="module")
def variables():
    return flax_variables(jax_model_def("inception_v3", num_classes=CLASSES,
                                        image_size=SIZE, uint8_input=True), 0)


@pytest.fixture(scope="module")
def net(variables):
    mdef = get_model_def("inception_v3", num_classes=CLASSES, image_size=SIZE,
                         compute_dtype="float32")
    return mdef.to_model(variables).params


def _block_cases():
    # (flax name, flax module per dtype, port submodule path, input channels, H=W)
    return [
        ("ConvBN_0", lambda dt: jinc.ConvBN(32, (3, 3), strides=(2, 2), compute_dtype=dt),
         ("stem", 0), 3, 9),
        ("InceptionA_0", lambda dt: jinc.InceptionA(32, dt), ("blocks", 0), 192, 5),
        ("ReductionA_0", lambda dt: jinc.ReductionA(dt), ("blocks", 3), 288, 7),
        ("InceptionB_0", lambda dt: jinc.InceptionB(128, dt), ("blocks", 4), 768, 5),
        ("ReductionB_0", lambda dt: jinc.ReductionB(dt), ("blocks", 8), 768, 7),
        ("InceptionC_0", lambda dt: jinc.InceptionC(dt), ("blocks", 9), 1280, 3),
    ]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", _block_cases(), ids=lambda c: c[0])
def test_block_matches_flax(variables, net, case, dtype):
    name, make, (group, idx), cin, hw = case
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    x = np.random.RandomState(idx + 1).standard_normal((2, hw, hw, cin)).astype(np.float32)
    block_vars = {"params": variables["params"][name],
                  "batch_stats": variables["batch_stats"][name]}
    module = make(jdt)
    want = jax.jit(lambda v, a: module.apply(v, a))(block_vars, jnp.asarray(x, jdt))
    with torch.inference_mode():
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(tdt)
        got = getattr(net, group)[idx](xt).permute(0, 2, 3, 1).float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape
    assert rel_err(got, want) <= (F32_TOL if dtype == "float32" else BF16_TOL)


def test_net_f32_matches_flax(variables):
    x = np.random.RandomState(1).randint(0, 256, (2, SIZE, SIZE, 3)).astype(np.float32)
    x = x / 127.5 - 1.0
    jmod = jinc.InceptionV3(num_classes=CLASSES, compute_dtype=jnp.float32)
    want = np.asarray(jax.jit(lambda v, a: jmod.apply(v, a))(variables, x))
    mdef = get_model_def("inception_v3", num_classes=CLASSES, image_size=SIZE,
                         compute_dtype="float32")
    with torch.inference_mode():
        out = mdef.methods["serve"].fn(mdef.to_model(variables).params,
                                       {"image": torch.from_numpy(x)})
    assert out["logits"].dtype == torch.float32 and out["logits"].shape == (2, CLASSES)
    assert rel_err(out["logits"].numpy(), want) <= F32_TOL
    np.testing.assert_array_equal(out["label"].numpy(), np.argmax(want, -1))


def _serve_both(variables, image):
    jdef = jax_model_def("inception_v3", num_classes=CLASSES, image_size=image.shape[1],
                         uint8_input=image.dtype == np.uint8)
    want = jax.jit(jdef.methods["serve"].fn)(variables, {"image": image})
    mdef = get_model_def("inception_v3", num_classes=CLASSES, image_size=image.shape[1],
                         uint8_input=image.dtype == np.uint8)
    with torch.inference_mode():
        got = mdef.methods["serve"].fn(mdef.to_model(variables).params,
                                       {"image": torch.from_numpy(image)})
    return {k: np.asarray(v) for k, v in want.items()}, {k: v.numpy() for k, v in got.items()}


def test_net_bf16_uint8_matches_flax(variables):
    image = np.random.RandomState(2).randint(0, 256, (2, SIZE, SIZE, 3)).astype(np.uint8)
    want, got = _serve_both(variables, image)
    assert got["label"].dtype == np.int32 and got["score"].dtype == np.float32
    assert rel_err(got["logits"], want["logits"]) <= BF16_TOL
    assert np.abs(got["score"] - want["score"]).max() <= BF16_TOL
    assert_labels_agree(got["label"], want["logits"], BF16_TOL)


def test_inception_v3_serve_299(variables):
    """Twin of tests/test_models.py::test_inception_v3_serve, at full
    resolution, batch 1, held to the flax net on the same weights."""
    want, got = _serve_both(variables, np.zeros((1, 299, 299, 3), np.float32))
    assert got["logits"].shape == (1, CLASSES)
    assert float(got["score"][0]) <= 1.0
    assert rel_err(got["logits"], want["logits"]) <= BF16_TOL


def test_inception_uint8_matches_prescaled_float(variables):
    """Twin of tests/test_models.py::test_inception_uint8_matches_prescaled_float:
    uint8 ingestion + on-device normalize == float ingestion of the same
    normalized pixels, up to bf16 rounding (the reference's atol)."""
    kw = dict(num_classes=5, image_size=SIZE)
    params = get_model_def("inception_v3", uint8_input=True, **kw).init_params(0)
    img8 = np.random.RandomState(0).randint(0, 256, (1, SIZE, SIZE, 3)).astype(np.uint8)
    imgf = img8.astype(np.float32) / 127.5 - 1.0
    outs = []
    for uint8, img in ((True, img8), (False, imgf)):
        mdef = get_model_def("inception_v3", uint8_input=uint8, **kw)
        with torch.inference_mode():
            outs.append(mdef.methods["serve"].fn(mdef.to_model(params).params,
                                                 {"image": torch.from_numpy(img)}))
    np.testing.assert_allclose(outs[0]["logits"].numpy(), outs[1]["logits"].numpy(), atol=0.25)


def test_normalize_matches_jax_for_every_uint8_value():
    pixels = np.arange(256, dtype=np.uint8)
    want = np.asarray(jax.jit(jax_normalize)(pixels).astype(jnp.float32))
    got = inception_normalize(torch.from_numpy(pixels))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_initialiser_is_seeded_and_lecun_scaled():
    mdef = get_model_def("inception_v3", num_classes=CLASSES, image_size=SIZE)
    a, b, c = mdef.init_params(3), mdef.init_params(3), mdef.init_params(4)
    wa = a.blocks[0].convs[2].weight.detach()   # 5x5x48 -> 64
    assert torch.equal(wa, b.blocks[0].convs[2].weight)
    assert not torch.equal(wa, c.blocks[0].convs[2].weight)
    assert abs(float(wa.std()) * np.sqrt(5 * 5 * 48) - 1.0) < 0.05
    assert float(wa.abs().max()) <= 2.0 / 0.87962566103423978 / np.sqrt(5 * 5 * 48) + 1e-6
    conv = a.stem[0]
    assert torch.equal(conv.scale, torch.ones(32)) and torch.equal(conv.var, torch.ones(32))
