"""The port's image preprocessing ops held to the JAX package's on the same
numpy batches (NHWC).

Tolerances:

- ``normalize_image`` / ``mnist_normalize`` / ``inception_normalize``:
  exact in f32 and in bf16 (each scalar rounded to the dtype first, as
  the reference's weakly typed scalars are; every uint8 value checked).
- ``central_crop``: exact (a slice); the fraction ``0.29`` of 100 rows is
  29 rows (``round``, where ``int`` would give 28).
- ``resize_bilinear`` in f32: 1e-6 absolute on values in [0, 1), growing
  and shrinking (read at most 1.8e-7: half-pixel centres, and the
  triangle kernel widened by the scale when shrinking, on both sides);
  a uint8 batch comes back f32 on both sides, to 1e-4 (read 4.6e-5 on
  values up to 255); bf16 to one bf16 step at [0, 1), 2**-8 (the port
  resizes in f32 and rounds once; the reference rounds in bf16).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flink_tensorflow_tpu.ops import preprocessing as ref
from flink_tensorflow_tpu_torch import ops
from flink_tensorflow_tpu_torch.ops import preprocessing as port


def _batch(shape, dtype=np.float32, seed=0):
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rng.randint(0, 256, shape).astype(np.uint8)
    return rng.rand(*shape).astype(dtype)


def test_the_ops_are_exported():
    for name in ("normalize_image", "mnist_normalize", "central_crop", "resize_bilinear",
                 "inception_normalize"):
        assert getattr(ops, name) is getattr(port, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normalize_image_matches_for_every_uint8_value(dtype):
    x = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    cases = [
        (ref.normalize_image(jnp.asarray(x), scale=1 / 255.0, offset=0.1, dtype=jdt),
         port.normalize_image(torch.from_numpy(x), scale=1 / 255.0, offset=0.1, dtype=tdt)),
        (ref.normalize_image(jnp.asarray(x), scale=0.37, offset=-3.0, dtype=jdt),
         port.normalize_image(torch.from_numpy(x), scale=0.37, offset=-3.0, dtype=tdt)),
        (ref.mnist_normalize(jnp.asarray(x), dtype=jdt),
         port.mnist_normalize(torch.from_numpy(x), dtype=tdt)),
        (ref.inception_normalize(jnp.asarray(x), dtype=jdt),
         port.inception_normalize(torch.from_numpy(x), dtype=tdt)),
    ]
    for want, got in cases:
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_mnist_normalize_defaults_to_bf16():
    x = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    got = port.mnist_normalize(torch.from_numpy(x))
    want = ref.mnist_normalize(jnp.asarray(x))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("shape,fraction", [((2, 100, 100, 3), 0.29), ((1, 299, 299, 3), 0.875),
                                            ((3, 7, 10, 1), 0.5), ((1, 5, 5, 2), 1.0),
                                            ((1, 3, 3, 1), 0.01), ((4, 6, 6, 3), 0.34)])
def test_central_crop_matches(shape, fraction):
    x = _batch(shape)
    want = np.asarray(ref.central_crop(jnp.asarray(x), fraction))
    got = port.central_crop(torch.from_numpy(x), fraction).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_central_crop_rounds_100_times_0_29_to_29():
    assert 100 * 0.29 < 29
    got = port.central_crop(torch.zeros(1, 100, 100, 3), 0.29)
    assert tuple(got.shape) == (1, 29, 29, 3)


@pytest.mark.parametrize("fraction", [0.0, -0.5, 1.5])
def test_central_crop_refuses_a_fraction_outside_0_1(fraction):
    with pytest.raises(ValueError, match="fraction"):
        port.central_crop(torch.zeros(1, 4, 4, 1), fraction)


@pytest.mark.parametrize("src,size", [((37, 29), (74, 58)), ((37, 29), (16, 11)),
                                      ((20, 20), (9, 9)), ((32, 48), (40, 13)),
                                      ((37, 29), (37, 29)), ((8, 8), (299, 299))],
                         ids=["grow2x", "shrink", "shrink-odd", "mixed", "same", "grow-big"])
def test_resize_bilinear_f32_matches(src, size):
    x = _batch((2,) + src + (3,))
    want = np.asarray(ref.resize_bilinear(jnp.asarray(x), size))
    got = port.resize_bilinear(torch.from_numpy(x), size).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("size", [(74, 58), (16, 11)], ids=["grow", "shrink"])
def test_resize_bilinear_uint8_comes_back_f32(size):
    x = _batch((2, 37, 29, 3), np.uint8)
    want = np.asarray(ref.resize_bilinear(jnp.asarray(x), size))
    got = port.resize_bilinear(torch.from_numpy(x), size).numpy()
    assert got.dtype == want.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-4


@pytest.mark.parametrize("size", [(40, 33), (9, 9)], ids=["grow", "shrink"])
def test_resize_bilinear_bf16_within_one_step(size):
    x = _batch((2, 20, 20, 3))
    want = np.asarray(ref.resize_bilinear(jnp.asarray(x, jnp.bfloat16), size).astype(jnp.float32))
    got = port.resize_bilinear(torch.from_numpy(x).bfloat16(), size)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= 2.0 ** -8


def test_resize_bilinear_keeps_leading_dims():
    x = _batch((2, 3, 12, 10, 3))
    want = np.asarray(ref.resize_bilinear(jnp.asarray(x), (6, 5)))
    got = port.resize_bilinear(torch.from_numpy(x), (6, 5)).numpy()
    assert got.shape == want.shape == (2, 3, 6, 5, 3)
    assert np.abs(got - want).max() <= 1e-6
