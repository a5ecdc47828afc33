"""Train-mode batch norm of the conv nets, as a hand-written CUDA kernel pair.

ResNet-50 (``models/zoo/resnet.py:BatchNorm``) and Inception-v3
(``models/zoo/inception.py:ConvBN``) normalise by the batch's moments in
train mode as flax does: ``E[x]`` and ``max(E[x^2] - E[x]^2, 0)`` in f32
(biased), the normalisation in f32 on the ``compute_dtype`` input with one
rounding on the way out, the running statistics moved by ``momentum``.
They differ only in ``eps``, ``momentum`` and whether a ReLU follows, and
both call :func:`batch_norm_train`.

The kernel (``csrc/batch_norm.cu``) replaces no Pallas kernel: the JAX
package leaves batch norm to XLA, which fuses it.  It was added because,
run as PyTorch's separate elementwise and reduction ops (the plain
version below, some 45 kernels per norm and step), train-mode batch norm
held about 78% of ResNet-50's device time on the H100 (the benchmark's
traced resnet50-train breakdown before it).  HBM bytes bound it: the
forward reads the activation for the statistics, then reads it again and
writes the output; the backward reads the gradient and the activation
twice (a reduction, then the input gradient) and writes the input
gradient, 16 bytes an element in bf16.  The ReLU's mask is recomputed
from the activation, so the output is not kept for it.  The sums are
taken in a fixed order with no atomics: the same inputs give the same
bits.

:func:`batch_norm_train` launches the kernels for a CUDA tensor (bf16 or
f32, ``channels_last``) or raises; any other tensor (the CPU, and the meta
tensors of the plan-time walks) runs :func:`batch_norm_train_reference`.
It never falls back.  Each launch of the forward pair adds one to
``batch_norm_train.launches``.

Inside ``collectives.cross_replica_moments`` (a data-parallel group) the
forward's two moments go through ``collectives.batch_moments``, and the
backward's per-channel gradients of them through
``collectives.moment_grads_``, its transpose.  At one rank both keep the
bits.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import typing

import torch
import torch.nn.functional as F

from flink_tensorflow_tpu_torch.parallel import collectives

KERNEL_SOURCE = "batch_norm.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: ``ftt_bn_forward`` / ``ftt_bn_backward`` phases: the reduction, the
#: elementwise pass, or both in one call.
_REDUCE, _APPLY, _BOTH = 1, 2, 3
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def batch_norm_train_reference(x, scale, bias, running_mean, running_var, *, eps: float,
                               momentum: float, relu: bool):
    """The plain PyTorch version: ``(out, new_running_mean,
    new_running_var)`` for ``x`` ``[N, C, H, W]``, with the kernel's
    semantics (module docstring).  Autograd differentiates it."""
    xf = x.float()
    mean, mean_sq = collectives.batch_moments(xf.mean(dim=(0, 2, 3)),
                                              (xf * xf).mean(dim=(0, 2, 3)))
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    with torch.no_grad():
        new_mean = momentum * running_mean + (1 - momentum) * mean
        new_var = momentum * running_var + (1 - momentum) * var
    shape = (1, -1, 1, 1)
    mul = torch.rsqrt(var + eps) * scale
    y = ((x - mean.view(shape)) * mul.view(shape) + bias.view(shape)).to(x.dtype)
    return (F.relu(y) if relu else y), new_mean, new_var


@functools.lru_cache(maxsize=None)
def _library():
    from flink_tensorflow_tpu_torch.ops._build import load_library

    lib = load_library(KERNEL_SOURCE)
    i32, i64, f32, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_float, ctypes.c_void_p
    lib.ftt_bn_partial_rows.restype = i32
    lib.ftt_bn_partial_rows.argtypes = [i32, i64, i32]
    lib.ftt_bn_vector_width.restype = i32
    lib.ftt_bn_vector_width.argtypes = [i32, i32]
    lib.ftt_bn_forward.restype = i32
    lib.ftt_bn_forward.argtypes = [i32, i32, i32, i64, i32, f32, f32, f32] + [ptr] * 10
    lib.ftt_bn_backward.restype = i32
    lib.ftt_bn_backward.argtypes = [i32, i32, i32, i64, i32, f32] + [ptr] * 9
    return lib


@functools.lru_cache(maxsize=None)
def _layout(dtype: torch.dtype, m: int, c: int, device_index: int) -> typing.Tuple[int, int]:
    """(rows of the partial buffer, bytes the activations' pointers must be
    aligned to) for a call on (dtype, M, C) on that card."""
    lib = _library()
    with torch.cuda.device(device_index):
        rows = lib.ftt_bn_partial_rows(_DTYPES[dtype], m, c)
    if rows < 1:
        raise ValueError(f"batch_norm_train: no kernel for {dtype}, M={m}, C={c}")
    return rows, lib.ftt_bn_vector_width(_DTYPES[dtype], c) * (2 if dtype == torch.bfloat16 else 4)


def _activation(t: torch.Tensor, align: int) -> torch.Tensor:
    """``t`` as the kernels read it: ``channels_last``, its pointer aligned."""
    t = t.contiguous(memory_format=torch.channels_last)
    if t.data_ptr() % align:
        t = t.clone(memory_format=torch.channels_last)
    return t


def _check(x, scale, bias, running_mean, running_var) -> None:
    """Everything the kernels do not take raises here, before a launch."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"batch_norm_train: dtype {x.dtype} not supported by the kernel")
    if x.dim() != 4:
        raise ValueError(f"batch_norm_train: x must be [N, C, H, W], got {tuple(x.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("batch_norm_train: the kernel takes channels_last activations")
    c = x.shape[1]
    for name, t in (("scale", scale), ("bias", bias), ("running_mean", running_mean),
                    ("running_var", running_var)):
        if t.dtype != torch.float32 or t.shape != (c,) or not t.is_contiguous():
            raise ValueError(f"batch_norm_train: {name} must be contiguous f32 [{c}], got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"batch_norm_train: {name} is on {t.device}, x on {x.device}")


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"batch_norm_train {what} launch failed: cudaError_t {err}")


def _on_device(device: torch.device):
    """The launches go to the current device: make it ``device``'s."""
    if torch.cuda.current_device() == device.index:
        return contextlib.nullcontext()
    return torch.cuda.device(device.index)


class _BatchNormTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, running_mean, running_var, eps: float, momentum: float,
                relu: bool):
        _check(x, scale, bias, running_mean, running_var)
        n, c, h, w = x.shape
        m = n * h * w
        rows, align = _layout(x.dtype, m, c, x.device.index)
        x = _activation(x, align)
        lib = _library()
        active = collectives.moments_group()
        buf = torch.empty(2 * c * (2 + rows), dtype=torch.float32, device=x.device)
        moments, new_stats, part = buf[:2 * c], buf[2 * c:4 * c], buf[4 * c:]
        out = torch.empty_like(x, memory_format=torch.channels_last)

        def launch(phase, moments):
            _raise_on(lib.ftt_bn_forward(
                _DTYPES[x.dtype], phase, int(relu), m, c, eps, momentum, 1 - momentum,
                x.data_ptr(), out.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                running_mean.data_ptr(), running_var.data_ptr(), moments.data_ptr(),
                new_stats.data_ptr(), part.data_ptr(), _raw_stream(x.device.index)), "forward")

        with _on_device(x.device):
            if active is None:
                launch(_BOTH, moments)
            else:
                launch(_REDUCE, moments)
                moments = torch.cat(collectives.batch_moments(moments[:c], moments[c:]))
                launch(_APPLY, moments)
        batch_norm_train.launches += 1
        ctx.save_for_backward(x, scale, bias, moments)
        ctx.config = (eps, bool(relu), active, m, c, rows, align)
        new_mean, new_var = new_stats[:c], new_stats[c:]
        ctx.mark_non_differentiable(new_mean, new_var)
        return out, new_mean, new_var

    @staticmethod
    def backward(ctx, dout, _new_mean, _new_var):
        x, scale, bias, moments = ctx.saved_tensors
        eps, relu, active, m, c, rows, align = ctx.config
        dout = _activation(dout, align)
        lib = _library()
        dx = torch.empty_like(x, memory_format=torch.channels_last)
        buf = torch.empty(2 * c * (2 + rows), dtype=torch.float32, device=x.device)
        grads, part = buf[:4 * c], buf[4 * c:]

        def launch(phase):
            _raise_on(lib.ftt_bn_backward(
                _DTYPES[x.dtype], phase, int(relu), m, c, eps, x.data_ptr(), dout.data_ptr(),
                dx.data_ptr(), scale.data_ptr(), bias.data_ptr(), moments.data_ptr(),
                grads.data_ptr(), part.data_ptr(), _raw_stream(x.device.index)), "backward")

        with _on_device(x.device):
            if active is None:
                launch(_BOTH)
            else:
                launch(_REDUCE)
                collectives.moment_grads_(grads[2 * c:], active)
                launch(_APPLY)
        return dx, grads[:c], grads[c:2 * c], None, None, None, None, None


def batch_norm_train(x, scale, bias, running_mean, running_var, *, eps: float, momentum: float,
                     relu: bool):
    """Train-mode batch norm of ``x`` ``[N, C, H, W]`` over N, H and W:
    ``(out, new_running_mean, new_running_var)``, ``out`` in ``x``'s dtype
    (ReLU applied with ``relu``), the running statistics f32 and out of
    the graph.  ``scale``, ``bias`` and the running statistics are f32
    ``[C]``.  A CUDA tensor launches the kernels (bf16 or f32,
    ``channels_last``) or raises; any other runs the plain version."""
    if x.device.type != "cuda":
        return batch_norm_train_reference(x, scale, bias, running_mean, running_var, eps=eps,
                                          momentum=momentum, relu=relu)
    return _BatchNormTrain.apply(x, scale, bias, running_mean, running_var, float(eps),
                                 float(momentum), bool(relu))


#: Forward launches of the kernel pair since the last reset (set to 0 by
#: callers that count).
batch_norm_train.launches = 0
