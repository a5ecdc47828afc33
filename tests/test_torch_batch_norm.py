"""Train-mode batch norm on the CPU: ``ops/batch_norm.py``'s plain path.

- ResNet's ``BatchNorm`` (with and without its ReLU) and Inception's
  ``ConvBN`` in train mode route through ``batch_norm_train``'s plain
  version and give the output, the running statistics and the gradients
  of the formula they held before the fused kernel, bit for bit (the
  formula is kept here as a fixture).
- The closed-form backward that ``csrc/batch_norm.cu`` computes (two
  sums per channel, then ``dx = dz a + dmu / M + 2 x dq / M``) equals
  autograd's gradient of the plain formula in float64, with the ReLU's
  mask, on a constant channel (the clamp at 0), and across two simulated
  ranks whose ``(dmu, dq)`` are averaged (``collectives.moment_grads_``'s
  transpose of ``batch_moments``) to within 1e-10 of the largest
  gradient: float64 summed in another order.
- Off the card nothing launches: ``batch_norm_train.launches`` stays 0
  and the traced gang's ``train.launch`` spans read ``bn_launches`` 0.
"""

import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from flink_tensorflow_tpu_torch import StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.functions import train_cell
from flink_tensorflow_tpu_torch.functions.training_function import DPTrainWindowFunction
from flink_tensorflow_tpu_torch.models.zoo import inception, resnet
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.ops import batch_norm as bn
from flink_tensorflow_tpu_torch.parallel import collectives, optim
from flink_tensorflow_tpu_torch.parallel.mesh import make_mesh
from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, spec
from flink_tensorflow_tpu_torch.tensors.value import TensorValue


def fixture_formula(x, scale, bias, running_mean, running_var, eps, momentum):
    """The train-mode formula ResNet's ``BatchNorm`` and Inception's
    ``ConvBN`` held before the fused kernel (without the ReLU)."""
    xf = x.float()
    mean, mean_sq = collectives.batch_moments(xf.mean(dim=(0, 2, 3)),
                                              (xf * xf).mean(dim=(0, 2, 3)))
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    with torch.no_grad():
        new_mean = momentum * running_mean + (1 - momentum) * mean
        new_var = momentum * running_var + (1 - momentum) * var
    shape = (1, -1, 1, 1)
    mul = torch.rsqrt(var + eps) * scale
    return (((x - mean.view(shape)) * mul.view(shape) + bias.view(shape)).to(x.dtype),
            new_mean, new_var)


def activation(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(*shape, generator=g) * 1.5 + 0.3
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


@contextlib.contextmanager
def spied():
    """Counts the calls of the plain version behind ``batch_norm_train``."""
    calls = []
    plain = bn.batch_norm_train_reference

    def spy(*args, **kwargs):
        calls.append(kwargs["relu"])
        return plain(*args, **kwargs)

    bn.batch_norm_train_reference = spy
    launches = bn.batch_norm_train.launches
    try:
        yield calls
    finally:
        bn.batch_norm_train_reference = plain
        assert bn.batch_norm_train.launches == launches


def grads_of(out, leaves, seed=1):
    g = torch.Generator().manual_seed(seed)
    dout = torch.randn(out.shape, generator=g).to(out.dtype)
    return torch.autograd.grad(out, leaves, dout)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("relu", [True, False])
def test_resnet_batch_norm_routes_through_the_plain_path_bit_for_bit(dtype, relu):
    norm = resnet.BatchNorm(12, relu=relu)
    with torch.no_grad():
        norm.scale.copy_(torch.linspace(0.5, 1.5, 12))
        norm.bias.copy_(torch.linspace(-0.2, 0.3, 12))
        norm.mean.copy_(torch.linspace(-0.1, 0.1, 12))
        norm.var.copy_(torch.linspace(0.8, 1.2, 12))
    norm.path = "bn."
    x = activation((4, 12, 5, 6), dtype).requires_grad_()
    stats = {}
    with spied() as calls:
        y = norm(x, stats)
    assert calls == [relu]
    want, want_mean, want_var = fixture_formula(x, norm.scale, norm.bias, norm.mean, norm.var,
                                                resnet.BN_EPSILON, resnet.BN_MOMENTUM)
    if relu:
        want = F.relu(want)
    assert y.dtype == dtype and torch.equal(y, want)
    assert torch.equal(stats["bn.mean"], want_mean) and torch.equal(stats["bn.var"], want_var)
    leaves = (x, norm.scale, norm.bias)
    for got, ref in zip(grads_of(y, leaves), grads_of(want, leaves)):
        assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_inception_conv_bn_routes_through_the_plain_path_bit_for_bit(dtype):
    unit = inception.ConvBN(5, 20, (3, 3), padding="SAME")
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        unit.weight.copy_(torch.randn(unit.weight.shape, generator=g) * 0.3)
        unit.scale.copy_(torch.linspace(0.7, 1.3, 20))
        unit.bias.copy_(torch.linspace(-0.3, 0.2, 20))
    unit.path = "c."
    x = activation((3, 5, 9, 9), dtype, seed=4).requires_grad_()
    stats = {}
    with spied() as calls:
        y = unit(x, stats)
    assert calls == [True]
    conv = F.conv2d(x, unit.weight.to(dtype, memory_format=torch.channels_last), None,
                    unit.stride, unit.padding)
    want, want_mean, want_var = fixture_formula(conv, unit.scale, unit.bias, unit.mean, unit.var,
                                                inception.BN_EPSILON, inception.BN_MOMENTUM)
    want = F.relu(want)
    assert torch.equal(y, want)
    assert torch.equal(stats["c.mean"], want_mean) and torch.equal(stats["c.var"], want_var)
    leaves = (x, unit.weight, unit.scale, unit.bias)
    for got, ref in zip(grads_of(y, leaves), grads_of(want, leaves)):
        assert torch.equal(got, ref)


def test_eval_mode_does_not_call_the_train_path():
    norm = resnet.BatchNorm(4, relu=True)
    x = activation((2, 4, 3, 3), torch.float32)
    with spied() as calls:
        y = norm(x, None)
    assert calls == []
    assert torch.equal(y, F.relu(x * torch.rsqrt(torch.tensor(1 + resnet.BN_EPSILON))))


# -- the kernel's closed-form backward, written out in float64 ----------------

def closed_form(xs, douts, scale, bias, eps, relu):
    """``dx`` per rank, ``dscale`` and ``dbias`` summed over the ranks, as
    ``csrc/batch_norm.cu`` computes them: per rank the two sums, then
    ``(dmu, dq)`` averaged over the ranks, then the elementwise pass."""
    dims = (0, 2, 3)
    m = xs[0].shape[0] * xs[0].shape[2] * xs[0].shape[3]
    mu = sum(x.mean(dims) for x in xs) / len(xs)
    q = sum((x * x).mean(dims) for x in xs) / len(xs)
    diff = q - mu * mu
    r = torch.rsqrt(diff.clamp(min=0) + eps)
    a = r * scale
    view = (1, -1, 1, 1)
    rank_terms, dscale, dbias = [], 0, 0
    for x, dout in zip(xs, douts):
        out = (x - mu.view(view)) * a.view(view) + bias.view(view)
        dz = dout * (out > 0) if relu else dout
        db = dz.sum(dims)
        s = (dz * (x - mu.view(view))).sum(dims)
        dv = torch.where(diff >= 0, -0.5 * scale * r ** 3 * s, torch.zeros_like(s))
        rank_terms.append((dz, -a * db - 2 * mu * dv, dv))
        dscale = dscale + s * r
        dbias = dbias + db
    dmu = sum(t[1] for t in rank_terms) / len(xs)
    dq = sum(t[2] for t in rank_terms) / len(xs)
    dxs = [dz * a.view(view) + (dmu / m).view(view) + 2 * x * (dq / m).view(view)
           for x, (dz, _, _) in zip(xs, rank_terms)]
    return dxs, dscale, dbias


def autograd_truth(xs, douts, scale, bias, eps, relu):
    """Autograd through the plain formula over the ranks' batch joined."""
    x = torch.cat(xs).requires_grad_()
    scale = scale.clone().requires_grad_()
    bias = bias.clone().requires_grad_()
    mean, mean_sq = x.mean((0, 2, 3)), (x * x).mean((0, 2, 3))
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    view = (1, -1, 1, 1)
    y = (x - mean.view(view)) * (torch.rsqrt(var + eps) * scale).view(view) + bias.view(view)
    if relu:
        y = F.relu(y)
    dx, dscale, dbias = torch.autograd.grad(y, (x, scale, bias), torch.cat(douts))
    return list(dx.split(xs[0].shape[0])), dscale, dbias


@pytest.mark.parametrize("ranks", [1, 2])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("constant_channel", [False, True])
def test_the_kernels_closed_form_backward_is_autograds(ranks, relu, constant_channel):
    g = torch.Generator().manual_seed(7)
    c = 6
    xs = [torch.randn(3, c, 4, 5, generator=g, dtype=torch.float64) * 2 + 0.5
          for _ in range(ranks)]
    if constant_channel:
        for x in xs:
            x[:, 2] = 0.5   # E[x^2] - E[x]^2 is exactly 0: the clamp's edge
    douts = [torch.randn(x.shape, generator=g, dtype=torch.float64) for x in xs]
    scale = torch.linspace(0.5, 1.5, c, dtype=torch.float64)
    bias = torch.linspace(-0.5, 0.5, c, dtype=torch.float64)
    got = closed_form(xs, douts, scale, bias, 1e-3, relu)
    want = autograd_truth(xs, douts, scale, bias, 1e-3, relu)
    peak = max(float(t.abs().max()) for t in [*want[0], want[1], want[2]])
    for a, b in zip([*got[0], got[1], got[2]], [*want[0], want[1], want[2]]):
        assert float((a - b).abs().max()) <= 1e-10 * peak
    if constant_channel:
        assert float(got[1][2]) == 0.0   # S = 0 there: no scale gradient


def test_local_batch_statistics_leaves_no_moments_group():
    with train_cell.local_batch_statistics():
        with collectives.cross_replica_moments(object(), 2):
            assert collectives.moments_group() is None
    with collectives.cross_replica_moments("group", 2):
        assert collectives.moments_group() == ("group", 2)
    assert collectives.moments_group() is None


@pytest.mark.parametrize("bad, match", [
    (lambda x: x.to(torch.float16), "dtype"),
    (lambda x: x.contiguous(), "channels_last"),
    (lambda x: x[:, :, :, 0], r"\[N, C, H, W\]"),
])
def test_the_kernel_wrapper_refuses_what_the_kernels_do_not_take(bad, match):
    x = activation((2, 8, 3, 4), torch.bfloat16)
    ones = torch.ones(8)
    with pytest.raises((TypeError, ValueError), match=match):
        bn._check(bad(x), ones, ones, ones, ones)
    with pytest.raises(ValueError, match="scale"):
        bn._check(x, torch.ones(8, dtype=torch.float64), ones, ones, ones)


def test_a_traced_gang_on_the_cpu_launches_no_fused_batch_norm():
    cfg = dict(num_classes=4, image_size=32, width=8, stage_sizes=(1, 1))
    rng = np.random.RandomState(0)
    recs = [TensorValue({"image": rng.rand(32, 32, 3).astype(np.float32),
                         "label": np.int32(i % 4)}) for i in range(16)]
    env = StreamExecutionEnvironment(parallelism=1).configure(trace=True, flight_recorder=False)
    env.set_mesh(make_mesh({"data": 1}, devices=["cpu"]))
    schema = RecordSchema({"image": spec((32, 32, 3)), "label": spec((), np.int32)})
    out = (env.from_collection(recs).count_window(8)
           .apply(DPTrainWindowFunction(get_model_def("resnet50", **cfg), optim.adam(1e-2),
                                        train_schema=schema, global_batch=8), name="dp")
           .sink_to_list())
    before = bn.batch_norm_train.launches
    handle = env.execute_async("gang")
    handle.wait(300)
    assert len(out) == 2
    launches = [e[5] for e in handle.executor.tracer.events() if e[1] == "train.launch"]
    assert [a["bn_launches"] for a in launches] == [0, 0]
    assert bn.batch_norm_train.launches == before
