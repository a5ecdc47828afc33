"""The arithmetic the references' convolutions and matmuls run in.

``Exact`` is float32 with TF32 off: the reference proper.  ``Fp8`` is
the control of a bfloat16 configuration, the next precision below it:
every convolution and matmul operand is rounded to float8 with a scale
per tensor (its largest magnitude onto the format's largest value), as
an fp8 port of the program would feed the tensor cores, and the product
is accumulated in float32.  Forward operands take ``e4m3``; in training
the gradients flowing back take ``e5m2``, the usual split.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def no_tf32() -> None:
    """Hold float32 products to float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Exact:
    """Plain float32 convolutions and matmuls."""

    name = "f32"

    def conv(self, x, w, stride, padding):
        return F.conv2d(x, w, None, stride, padding)

    def linear(self, x, w, b):
        return F.linear(x, w, b)


def _quantize(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` under a per-tensor scale, back in f32."""
    top = torch.finfo(dtype).max
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    scale = top / amax
    return (t.float() * scale).to(dtype).float() / scale


class _Fp8Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding):
        xq, wq = _quantize(x, torch.float8_e4m3fn), _quantize(w, torch.float8_e4m3fn)
        ctx.save_for_backward(xq, wq)
        ctx.stride, ctx.padding = stride, padding
        return F.conv2d(xq, wq, None, stride, padding)

    @staticmethod
    def backward(ctx, grad):
        xq, wq = ctx.saved_tensors
        g = _quantize(grad, torch.float8_e5m2)
        gx = torch.nn.grad.conv2d_input(xq.shape, wq, g, ctx.stride, ctx.padding)
        gw = torch.nn.grad.conv2d_weight(xq, wq.shape, g, ctx.stride, ctx.padding)
        return gx, gw, None, None


class _Fp8Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        xq, wq = _quantize(x, torch.float8_e4m3fn), _quantize(w, torch.float8_e4m3fn)
        ctx.save_for_backward(xq, wq)
        return F.linear(xq, wq, b)

    @staticmethod
    def backward(ctx, grad):
        xq, wq = ctx.saved_tensors
        g = _quantize(grad, torch.float8_e5m2)
        return g @ wq, g.t() @ xq, grad.sum(0)


class Fp8:
    """The control: fp8 operands, float32 accumulation."""

    name = "fp8"

    def conv(self, x, w, stride, padding):
        return _Fp8Conv.apply(x, w, tuple(stride), tuple(padding))

    def linear(self, x, w, b):
        return _Fp8Linear.apply(x, w, b)


def by_name(name: str):
    return {"f32": Exact, "fp8": Fp8}[name]()
