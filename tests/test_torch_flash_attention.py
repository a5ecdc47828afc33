"""The port's flash attention held against the JAX package's.

The same numpy inputs (from a seed) go through the JAX functions — the
Pallas kernel in interpret mode, as ``tests/test_ops.py`` runs it — and
through the port's ``device="cpu"`` path (the kernel's plain PyTorch
version).  Tolerances: f32 atol 1e-5 (both compute in f32, in another
summation order); bf16 atol 3e-3 on outputs kept below 0.25, where one
bf16 step is 2**-10, so a last-bit rounding difference stays inside it.
The kernel itself is held to the plain version on the card by the tests
marked ``cuda`` and by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flink_tensorflow_tpu.ops.flash_attention import flash_attention as jax_flash
from flink_tensorflow_tpu.ops.flash_attention import (
    flash_attention_decode as jax_decode,
)
from flink_tensorflow_tpu.parallel import full_attention
from flink_tensorflow_tpu_torch.ops import flash_attention as port


def _qkv(seed, b, t, tk, h, d):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, t, h, d).astype(np.float32)
    k = rng.randn(b, tk, h, d).astype(np.float32)
    v = rng.randn(b, tk, h, d).astype(np.float32)
    return q, k, v


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,tk", [(64, 64), (24, 40), (40, 24), (20, 20), (100, 100)],
                         ids=["square", "tk_longer", "tk_shorter", "t_not_mult_8", "t100"])
def test_flash_matches_jax(causal, t, tk):
    q, k, v = _qkv(0, 2, t, tk, 2, 16)
    want_o, want_lse = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 causal=causal, return_lse=True)
    got_o, got_lse = port.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                          return_lse=True)
    assert got_o.shape == (2, t, 2, 16) and got_lse.shape == (2, 2, t)
    assert got_o.dtype == torch.float32 and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=1e-5)


def test_flash_without_lse_returns_output_only():
    q, k, v = _qkv(1, 1, 16, 16, 2, 8)
    got = port.flash_attention(_t(q), _t(k), _t(v), causal=True)
    want = full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_lse_recombines_split_kv():
    """Two half-K/V calls folded with their log-sum-exps give full
    attention — the contract ring attention builds on."""
    q, k, v = _qkv(3, 2, 32, 32, 2, 8)
    want = full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    o1, l1 = port.flash_attention(_t(q), _t(k[:, :16]), _t(v[:, :16]), return_lse=True)
    o2, l2 = port.flash_attention(_t(q), _t(k[:, 16:]), _t(v[:, 16:]), return_lse=True)
    total = torch.logaddexp(l1, l2)
    w1 = torch.exp(l1 - total).permute(0, 2, 1)[..., None]
    w2 = torch.exp(l2 - total).permute(0, 2, 1)[..., None]
    np.testing.assert_allclose((o1 * w1 + o2 * w2).numpy(), np.asarray(want), atol=1e-5)


def test_bfloat16_compared_in_f32():
    q, k, v = _qkv(2, 1, 32, 32, 2, 16)
    v = v * np.float32(0.1)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    tq, tk_, tv = (_t(x).to(torch.bfloat16) for x in (q, k, v))
    want = jax_flash(jq, jk, jv, causal=True)
    got = port.flash_attention(tq, tk_, tv, causal=True)
    assert got.dtype == torch.bfloat16
    assert float(np.abs(np.asarray(want, np.float32)).max()) < 0.25
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=3e-3)


def test_empty_keys_give_zero_output_and_neg_inf_lse():
    q, _, _ = _qkv(4, 1, 8, 0, 2, 16)
    empty = torch.zeros((1, 0, 2, 16))
    o, lse = port.flash_attention(_t(q), empty, empty, return_lse=True)
    assert torch.equal(o, torch.zeros_like(o))
    assert torch.isneginf(lse).all()


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    """Tensors off the CPU go to the kernel's input checks, never to the
    plain version: a device the kernel does not serve raises."""
    q = torch.zeros((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="kernel takes cuda"):
        port.flash_attention(q, q, q)


@pytest.mark.parametrize("lengths", [[0, 5, 32], [1, 0, 17]])
def test_decode_matches_jax(lengths):
    rng = np.random.RandomState(5)
    b, c, h, d = 3, 32, 2, 16
    q = rng.randn(b, 1, h, d).astype(np.float32)
    k = rng.randn(b, c, h, d).astype(np.float32)
    v = rng.randn(b, c, h, d).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    want_o, want_lse = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(lens), return_lse=True)
    got_o, got_lse = port.flash_attention_decode(_t(q), _t(k), _t(v), _t(lens),
                                                 return_lse=True)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=1e-5)
    np.testing.assert_array_equal(np.isneginf(got_lse.numpy()),
                                  np.isneginf(np.asarray(want_lse)))
    fin = np.isfinite(np.asarray(want_lse))
    np.testing.assert_allclose(got_lse.numpy()[fin], np.asarray(want_lse)[fin], atol=1e-5)
    empty = lens == 0
    assert not got_o.numpy()[empty].any()
    # 3-D q squeezes back to [B, H, D].
    got3 = port.flash_attention_decode(_t(q[:, 0]), _t(k), _t(v), _t(lens))
    np.testing.assert_array_equal(got3.numpy(), got_o.numpy()[:, 0])


def test_decode_rejects_more_than_one_query():
    x = torch.zeros((1, 2, 1, 8))
    with pytest.raises(ValueError, match="exactly one query"):
        port.flash_attention_decode(x, x, x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,causal,t,tk,d", [
    ("float32", True, 16, 16, 16), ("float32", False, 100, 136, 32),
    ("bfloat16", True, 256, 256, 64), ("float16", False, 70, 33, 128)])
def test_kernel_matches_plain_version_on_the_card(dtype, causal, t, tk, d):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = getattr(torch, dtype)
    q = torch.randn(2, t, 4, d, device="cuda", generator=gen).to(dt)
    k = torch.randn(2, tk, 4, d, device="cuda", generator=gen).to(dt)
    v = torch.randn(2, tk, 4, d, device="cuda", generator=gen).to(dt)
    before = port.flash_attention.launches
    o, lse = port.flash_attention(q, k, v, causal=causal, return_lse=True)
    ro, rl = port.flash_attention_reference(q, k, v, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert port.flash_attention.launches == before + 1
    # Both round the same f32 sums to the output type, so a 16-bit output
    # may differ by one step of that type (relative 2**-7 in bf16).
    tol, rtol = (1e-4, 0) if dtype == "float32" else (3e-3, 2 ** -7)
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=rtol)
    torch.testing.assert_close(lse, rl, atol=1e-4, rtol=0)
