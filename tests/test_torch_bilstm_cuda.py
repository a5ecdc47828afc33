"""The BiLSTM's cuDNN routes on the card, as a job runs them outside
``chip_smoke.py`` (which turns TF32 off for the whole process).

- The f32 route keeps TF32 off for its own call whatever the caller set:
  with cuDNN's RNN left at TF32 (PyTorch's default), the card's f32 model
  stays within 1e-4 of its largest |logit| and final state of the CPU's
  plain step loop (the same bound as ``chip_smoke.py:BILSTM_F32_TOL``: 2
  x 256 steps of f32 sums in another order; TF32 rounds ``h`` and the
  kernels to 10 mantissa bits every step, about 1e-3), and the caller's
  setting is back afterwards.
- Both fused routes hand cuDNN one flattened weight buffer, so it never
  warns that it compacts the weights on every call.

This file imports neither jax nor flax, so it runs where they are absent.
"""

import warnings

import numpy as np
import pytest
import torch

from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def

F32_TOL = 1e-4
CFG = dict(vocab_size=1000, embed_dim=128, hidden_dim=256, num_classes=2)


def needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.fixture
def tf32_default():
    """cuDNN's RNN at PyTorch's default (TF32 allowed); the caller's
    settings restored after."""
    rnn = torch.backends.cudnn.rnn
    saved = rnn.fp32_precision if hasattr(rnn, "fp32_precision") else None
    saved_legacy = torch._C._get_cudnn_allow_tf32()
    torch.backends.cudnn.allow_tf32 = True
    yield rnn
    torch.backends.cudnn.allow_tf32 = saved_legacy
    if saved is not None:
        rnn.fp32_precision = saved


def batch(rows=8, steps=128, seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, CFG["vocab_size"], (rows, steps)).astype(np.int32)
    lengths = rng.randint(1, steps + 1, (rows,)).astype(np.int32)
    lengths[0] = steps
    return torch.from_numpy(tokens), torch.from_numpy(lengths)


def rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.cuda
def test_f32_route_keeps_tf32_off_whatever_the_caller_set(tf32_default):
    needs_cuda()
    mdef = get_model_def("bilstm", **CFG, compute_dtype="float32")
    cpu = mdef.to_model(mdef.init_params(0)).params
    card = mdef.to_model(mdef.init_params(0)).params.to("cuda")
    x, n = batch()
    with torch.inference_mode():
        want_states, want = cpu.states(x, n), cpu(x, n)
        got_states = card.states(x.cuda(), n.cuda()).cpu()
        got = card(x.cuda(), n.cuda()).cpu()
    assert rel(got_states, want_states) <= F32_TOL
    assert rel(got, want) <= F32_TOL
    if hasattr(tf32_default, "fp32_precision"):
        assert tf32_default.fp32_precision == "tf32"
    assert torch._C._get_cudnn_allow_tf32()


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["cudnn_f32", "cudnn_bf16"])
def test_fused_routes_give_cudnn_one_weight_buffer(route):
    needs_cuda()
    mdef = get_model_def("bilstm", **CFG)
    module = mdef.to_model(mdef.init_params(0)).params.to("cuda")
    x, n = (t.cuda() for t in batch(steps=32))
    with warnings.catch_warnings(record=True) as caught, torch.inference_mode():
        warnings.simplefilter("always")
        first = module(x, n, route=route)
        second = module(x, n, route=route)
        torch.cuda.synchronize()
    assert not [w for w in caught if "contiguous" in str(w.message)], \
        [str(w.message) for w in caught]
    torch.testing.assert_close(first, second, rtol=0, atol=0)
