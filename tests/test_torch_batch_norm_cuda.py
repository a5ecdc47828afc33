"""The fused train-mode batch norm on the card (``cuda``-marked; they skip
without an NVIDIA GPU).  This file imports neither flax nor the JAX
package, so it collects on a machine that has neither.

The kernel pair (``csrc/batch_norm.cu`` through ``ops/batch_norm.py``) is
held to its plain version run on the card on float64 copies of the same
bf16 inputs (the moments in f32, as the formula takes them), at ResNet-50's shapes (the stem 256x64x112x112,
256x256x56x56, 256x2048x7x7), Inception-v3's (32x80x73x73, 32x192x35x35)
and an odd channel count (32x75x35x35, one element a load), with and
without the ReLU, and once in f32.  Tolerances, each with its reason:

- the output and ``dx``: one rounding to the output type (half a step,
  ``2**-8`` of the rounded value in bf16, ``2**-24`` in f32) plus the f32
  arithmetic before it, whose error is below ``1e-4`` of the magnitudes
  that enter it (``|x - mu| a + |beta|`` for the output; for ``dx``,
  ``|dz a|`` and the terms dmu / M and 2 x dq / M with the magnitudes of
  the sums they are made of in place of the sums; mu and rsqrt come from
  f32 sums over up to 3.2 M rows); where the value before the ReLU lies within 1e-5 of
  those magnitudes of 0 (f32's error there is a few units of 6e-8 of them,
  plus the sums'; at most 1e-4 of the elements), the mask may go either
  way: dx may differ there by ``dout a``, and the channel's two sums by
  that dout (times ``|x - mu|``), which moves dmu and dv, so every dx,
  dscale and dbias of the channel (bf16 values repeat, so such elements
  come in groups: 103 of one channel of 256x256x56x56 on the card);
- the running statistics, ``dscale`` and ``dbias``: f32 sums of up to
  3.2 M terms in the kernel's fixed order, held to ``1e-4`` of the sum of
  the terms' magnitudes (a sum's error grows with its length and with the
  cancellation inside it).

Besides: on a constant channel ``E[x^2] - E[x]^2`` is exactly 0 (0.5 is
exact in bf16 and its sums are exact in f32), the clamp gives variance
0 and the scale's gradient is exactly 0; two calls on the same inputs
give equal bits (no atomics); each call adds one to the launch counter;
and inside ``cross_replica_moments`` over an NCCL group of one the
output, the statistics and every gradient equal those with no group,
bit for bit.
"""

import socket

import pytest
import torch
import torch.distributed as dist

from flink_tensorflow_tpu_torch.ops import batch_norm as bn
from flink_tensorflow_tpu_torch.parallel import collectives

pytestmark = pytest.mark.cuda

RESNET = dict(eps=1e-5, momentum=0.9)
INCEPTION = dict(eps=1e-3, momentum=0.9997)
SHAPES = [
    ((256, 64, 112, 112), RESNET),
    ((256, 256, 56, 56), RESNET),
    ((256, 2048, 7, 7), RESNET),
    ((32, 80, 73, 73), INCEPTION),
    ((32, 192, 35, 35), INCEPTION),
    ((32, 75, 35, 35), INCEPTION),
]
ROUNDING = {torch.bfloat16: 2.0 ** -8, torch.float32: 2.0 ** -24}
ARITH = 1e-4
SUMS = 1e-4
EITHER = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    yield torch.device("cuda", 0)
    torch.cuda.empty_cache()


def case(shape, dtype, device, seed=0, constant_channel=None):
    g = torch.Generator(device=device).manual_seed(seed)
    n, c, h, w = shape
    x = (torch.randn(shape, generator=g, device=device) * 1.5 + 0.3).to(dtype)
    if constant_channel is not None:
        x[:, constant_channel] = 0.5
    x = x.contiguous(memory_format=torch.channels_last)
    dout = torch.randn(shape, generator=g, device=device).to(dtype).contiguous(
        memory_format=torch.channels_last)
    scale = torch.rand(c, generator=g, device=device) + 0.5
    bias = torch.rand(c, generator=g, device=device) - 0.5
    run_mean = torch.rand(c, generator=g, device=device) - 0.5
    run_var = torch.rand(c, generator=g, device=device) + 0.5
    return x, dout, scale, bias, run_mean, run_var


def kernel_run(x, dout, scale, bias, run_mean, run_var, relu, cfg):
    xg = x.detach().requires_grad_()
    sg, bg = scale.detach().requires_grad_(), bias.detach().requires_grad_()
    out, new_mean, new_var = bn.batch_norm_train(xg, sg, bg, run_mean, run_var, relu=relu, **cfg)
    dx, dscale, dbias = torch.autograd.grad(out, (xg, sg, bg), dout)
    torch.cuda.synchronize()
    return out.detach(), new_mean, new_var, dx, dscale, dbias


def truth(x, dout, scale, bias, run_mean, run_var, relu, cfg):
    """The plain version on float64 copies of the inputs (its moments in
    f32, as the formula takes them, the rest in float64), with the
    magnitudes each tolerance scales by."""
    xd = x.double().requires_grad_()
    sd, bd = scale.double().requires_grad_(), bias.double().requires_grad_()
    out, new_mean, new_var = bn.batch_norm_train_reference(
        xd, sd, bd, run_mean.double(), run_var.double(), relu=relu, **cfg)
    dd = dout.double()
    dx, dscale, dbias = torch.autograd.grad(out, (xd, sd, bd), dd)
    with torch.no_grad():
        dims = (0, 2, 3)
        view = (1, -1, 1, 1)
        xv = xd.detach()
        m = xv.numel() // xv.shape[1]
        mu = xv.mean(dims)
        var = ((xv * xv).mean(dims) - mu * mu).clamp(min=0)
        r = torch.rsqrt(var + cfg["eps"])
        a = r * sd.detach()
        centred = (xv - mu.view(view)).abs()
        out_mag = centred * a.abs().view(view) + bd.detach().abs().view(view)
        # Where the value before the ReLU lies within the arithmetic's
        # error of 0, either side is right, and dx may differ by dout * a.
        pre = (xv - mu.view(view)) * a.view(view) + bd.detach().view(view)
        either = (pre.abs() <= EITHER * out_mag) if relu else torch.zeros_like(pre, dtype=bool)
        assert int(either.sum()) <= 1e-4 * either.numel()
        dz = dd * (out > 0) if relu else dd
        # The magnitudes the two sums add up, with either side's dz where
        # the mask may go either way, and what dmu and dv are made of.
        abs_dz = torch.where(either, dd, dz).abs()
        sum_b = abs_dz.sum(dims)
        sum_s = (abs_dz * centred).sum(dims)
        mag_dv = 0.5 * sd.detach().abs() * r ** 3 * sum_s
        mag_dmu = a.abs() * sum_b + 2 * mu.abs() * mag_dv
        # Such an element moves its channel's two sums by up to its dout
        # (times |x - mu|), and through them dmu and dv: in full, not as
        # rounding.
        flip_b = (either * dd.abs()).sum(dims)
        flip_s = (either * dd.abs() * centred).sum(dims)
        flip_dv = 0.5 * sd.detach().abs() * r ** 3 * flip_s
        flip_dx = (((a.abs() * flip_b + 2 * mu.abs() * flip_dv) / m).view(view)
                   + 2 * xv.abs() * (flip_dv / m).view(view) + either * (dd * a.view(view)).abs())
        mags = {"out": out_mag,
                "dx": (abs_dz * a.abs().view(view) + (mag_dmu / m).view(view)
                       + 2 * xv.abs() * (mag_dv / m).view(view) + flip_dx / ARITH),
                "new_mean": (1 - cfg["momentum"]) * xv.abs().mean(dims),
                "new_var": (1 - cfg["momentum"]) * 3 * (xv * xv).mean(dims),
                "dscale": sum_s * r + flip_s * r / SUMS,
                "dbias": sum_b + flip_b / SUMS}
    return (out.detach(), new_mean, new_var, dx, dscale, dbias), mags


def hold(name, got, want, mag, rounding):
    err = (got.double() - want).abs()
    # Half a step of the rounded value, which may lie on either side of want.
    limit = (rounding * torch.maximum(got.double().abs(), want.abs())
             + (ARITH if name in ("out", "dx") else SUMS) * mag)
    over = (err - limit).flatten()
    i = int(over.argmax())
    assert float(over[i]) <= 0, (f"{name}: error exceeds its bound by {float(over[i])} at flat "
                                 f"index {i}: {float(got.flatten()[i])} against "
                                 f"{float(want.flatten()[i])}, bound {float(limit.flatten()[i])}")


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape, cfg", SHAPES, ids=["x".join(map(str, s)) for s, _ in SHAPES])
def test_the_kernel_pair_holds_to_the_plain_version(card, shape, cfg, relu):
    inputs = case(shape, torch.bfloat16, card)
    got = kernel_run(*inputs, relu, cfg)
    want, mags = truth(*inputs, relu, cfg)
    names = ("out", "new_mean", "new_var", "dx", "dscale", "dbias")
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, name
        hold(name, a, b, mags[name], ROUNDING[torch.bfloat16] if name in ("out", "dx") else 1e-7)
    assert got[0].dtype == got[3].dtype == torch.bfloat16
    assert got[0].is_contiguous(memory_format=torch.channels_last)


def test_f32_activations(card):
    cfg = RESNET
    inputs = case((16, 24, 9, 9), torch.float32, card, seed=5)
    got = kernel_run(*inputs, True, cfg)
    want, mags = truth(*inputs, True, cfg)
    for name, a, b in zip(("out", "new_mean", "new_var", "dx", "dscale", "dbias"), got, want):
        hold(name, a, b, mags[name], ROUNDING[torch.float32] if name in ("out", "dx") else 1e-7)


def test_a_constant_channel_has_zero_variance_and_no_scale_gradient(card):
    cfg = RESNET
    x, dout, scale, bias, run_mean, run_var = case((256, 64, 56, 56), torch.bfloat16, card,
                                                   constant_channel=3)
    out, new_mean, new_var, dx, dscale, dbias = kernel_run(x, dout, scale, bias, run_mean,
                                                           run_var, False, cfg)
    m = cfg["momentum"]
    keep = torch.tensor(1 - m, dtype=torch.float32)
    assert float(new_mean[3]) == float(torch.tensor(m) * run_mean[3] + keep * 0.5)
    assert float(new_var[3]) == float(torch.tensor(m) * run_var[3])
    assert float(dscale[3]) == 0.0
    assert torch.equal(out[:, 3], torch.full_like(out[:, 3], float(bias[3].bfloat16())))
    assert float(dscale.abs().max()) > 0


def test_two_calls_give_equal_bits_and_each_counts_one_launch(card):
    inputs = case((256, 256, 56, 56), torch.bfloat16, card, seed=2)
    before = bn.batch_norm_train.launches
    first = kernel_run(*inputs, True, RESNET)
    second = kernel_run(*inputs, True, RESNET)
    assert bn.batch_norm_train.launches == before + 2
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_an_nccl_group_of_one_keeps_the_bits(card):
    inputs = case((32, 192, 35, 35), torch.bfloat16, card, seed=3)
    want = kernel_run(*inputs, True, INCEPTION)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        calls = collectives.calls["all_reduce"]
        with collectives.cross_replica_moments(dist.group.WORLD, 1):
            got = kernel_run(*inputs, True, INCEPTION)
        assert collectives.calls["all_reduce"] == calls + 2   # the moments, their gradients
    finally:
        dist.destroy_process_group()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
