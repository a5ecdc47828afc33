"""Inception-v3, plain PyTorch in float32.

Szegedy et al., *Rethinking the Inception Architecture for Computer
Vision* (arXiv:1512.00567), at the widths of its public implementations
(TF-slim's ``inception_v3``, torchvision's ``Inception3``): stem ->
3 x InceptionA (pool features 32, 64, 64) -> ReductionA -> 4 x InceptionB
(7x7 channels 128, 160, 160, 192) -> ReductionB -> 2 x InceptionC ->
global mean -> dropout -> dense.  Every conv is followed by batch norm
(eps 1e-3) and ReLU.

Departures from the paper, each the one the system under test makes:

- no auxiliary classifier and no label smoothing;
- stride-1 convs pad "SAME", which for these odd kernels is symmetric
  (flax's SAME is asymmetric only for even totals, which never occur
  here); strided convs and the 3x3/2 max pools are VALID;
- the branch average pool is 3x3 at stride 1, padded, counting the
  padding in its mean;
- records are HWC uint8 pixels mapped to ``x / 127.5 - 1``;
- dropout (rate 0.2, as the system's) draws its mask as
  ``torch.rand(features) < keep`` from the generator it is given, so the
  caller can hand both sides the same draws.

Parameter order (``parameters()``) is: per conv ``weight`` (OIHW),
``gamma``, ``beta``, stem first, blocks in order, branches in the order
written below; then the head's ``weight`` (out, in) and ``bias``.
"""

from __future__ import annotations

import typing

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.arith import Exact

EPS = 1e-3


class ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, same: bool = False):
        super().__init__()
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        self.weight = nn.Parameter(torch.zeros(cout, cin, kh, kw))
        self.gamma = nn.Parameter(torch.ones(cout))
        self.beta = nn.Parameter(torch.zeros(cout))
        self.register_buffer("running_mean", torch.zeros(cout))
        self.register_buffer("running_var", torch.ones(cout))
        self.stride = (stride, stride)
        self.padding = (kh // 2, kw // 2) if same else (0, 0)

    def forward(self, x, run):
        y = run.arith.conv(x, self.weight, self.stride, self.padding)
        if run.train:
            mean = y.mean(dim=(0, 2, 3))
            var = y.var(dim=(0, 2, 3), unbiased=False)
            if run.moments is not None:
                run.moments[self] = (mean.detach(), var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1, 1, 1)
        y = (y - mean.view(shape)) / torch.sqrt(var.view(shape) + EPS)
        return F.relu(y * self.gamma.view(shape) + self.beta.view(shape))


def _pool_same(x):
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=True)


def _max_valid(x):
    return F.max_pool2d(x, 3, 2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool: int):
        super().__init__()
        self.b1 = ConvBN(cin, 64, 1)
        self.b5_1 = ConvBN(cin, 48, 1)
        self.b5_2 = ConvBN(48, 64, 5, same=True)
        self.b3_1 = ConvBN(cin, 64, 1)
        self.b3_2 = ConvBN(64, 96, 3, same=True)
        self.b3_3 = ConvBN(96, 96, 3, same=True)
        self.bp = ConvBN(cin, pool, 1)
        self.out = 64 + 64 + 96 + pool

    def forward(self, x, run):
        return torch.cat([
            self.b1(x, run),
            self.b5_2(self.b5_1(x, run), run),
            self.b3_3(self.b3_2(self.b3_1(x, run), run), run),
            self.bp(_pool_same(x), run)], 1)


class ReductionA(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.b3 = ConvBN(cin, 384, 3, stride=2)
        self.bd_1 = ConvBN(cin, 64, 1)
        self.bd_2 = ConvBN(64, 96, 3, same=True)
        self.bd_3 = ConvBN(96, 96, 3, stride=2)
        self.out = 384 + 96 + cin

    def forward(self, x, run):
        return torch.cat([
            self.b3(x, run),
            self.bd_3(self.bd_2(self.bd_1(x, run), run), run),
            _max_valid(x)], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.b1 = ConvBN(cin, 192, 1)
        self.b7_1 = ConvBN(cin, c7, 1)
        self.b7_2 = ConvBN(c7, c7, (1, 7), same=True)
        self.b7_3 = ConvBN(c7, 192, (7, 1), same=True)
        self.bd_1 = ConvBN(cin, c7, 1)
        self.bd_2 = ConvBN(c7, c7, (7, 1), same=True)
        self.bd_3 = ConvBN(c7, c7, (1, 7), same=True)
        self.bd_4 = ConvBN(c7, c7, (7, 1), same=True)
        self.bd_5 = ConvBN(c7, 192, (1, 7), same=True)
        self.bp = ConvBN(cin, 192, 1)
        self.out = 4 * 192

    def forward(self, x, run):
        d = x
        for conv in (self.bd_1, self.bd_2, self.bd_3, self.bd_4, self.bd_5):
            d = conv(d, run)
        return torch.cat([
            self.b1(x, run),
            self.b7_3(self.b7_2(self.b7_1(x, run), run), run),
            d,
            self.bp(_pool_same(x), run)], 1)


class ReductionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.b3_1 = ConvBN(cin, 192, 1)
        self.b3_2 = ConvBN(192, 320, 3, stride=2)
        self.b7_1 = ConvBN(cin, 192, 1)
        self.b7_2 = ConvBN(192, 192, (1, 7), same=True)
        self.b7_3 = ConvBN(192, 192, (7, 1), same=True)
        self.b7_4 = ConvBN(192, 192, 3, stride=2)
        self.out = 320 + 192 + cin

    def forward(self, x, run):
        b7 = x
        for conv in (self.b7_1, self.b7_2, self.b7_3, self.b7_4):
            b7 = conv(b7, run)
        return torch.cat([self.b3_2(self.b3_1(x, run), run), b7, _max_valid(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.b1 = ConvBN(cin, 320, 1)
        self.b3 = ConvBN(cin, 384, 1)
        self.b3_a = ConvBN(384, 384, (1, 3), same=True)
        self.b3_b = ConvBN(384, 384, (3, 1), same=True)
        self.bd_1 = ConvBN(cin, 448, 1)
        self.bd_2 = ConvBN(448, 384, 3, same=True)
        self.bd_a = ConvBN(384, 384, (1, 3), same=True)
        self.bd_b = ConvBN(384, 384, (3, 1), same=True)
        self.bp = ConvBN(cin, 192, 1)
        self.out = 320 + 4 * 384 + 192

    def forward(self, x, run):
        b3 = self.b3(x, run)
        bd = self.bd_2(self.bd_1(x, run), run)
        return torch.cat([self.b1(x, run), self.b3_a(b3, run), self.b3_b(b3, run),
                          self.bd_a(bd, run), self.bd_b(bd, run),
                          self.bp(_pool_same(x), run)], 1)


class _Run(typing.NamedTuple):
    train: bool
    arith: typing.Any
    #: Where train mode records each norm's batch mean and variance.
    moments: typing.Optional[dict]


class InceptionV3(nn.Module):
    def __init__(self, num_classes: int = 1000, dropout: float = 0.2, **_):
        super().__init__()
        self.dropout = dropout
        self.stem = nn.ModuleList([ConvBN(3, 32, 3, stride=2), ConvBN(32, 32, 3),
                                   ConvBN(32, 64, 3, same=True), ConvBN(64, 80, 1),
                                   ConvBN(80, 192, 3)])
        blocks, cin = [], 192
        for make in (lambda c: InceptionA(c, 32), lambda c: InceptionA(c, 64),
                     lambda c: InceptionA(c, 64), ReductionA,
                     lambda c: InceptionB(c, 128), lambda c: InceptionB(c, 160),
                     lambda c: InceptionB(c, 160), lambda c: InceptionB(c, 192),
                     ReductionB, InceptionC, InceptionC):
            blocks.append(make(cin))
            cin = blocks[-1].out
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes)

    def forward(self, pixels: torch.Tensor, *, train: bool = False,
                generator: typing.Optional[torch.Generator] = None, arith=None,
                moments: typing.Optional[dict] = None):
        """``pixels`` ``[B, H, W, 3]`` uint8 -> ``[B, classes]`` logits;
        in train mode ``moments`` (a dict) gets each norm's batch moments."""
        run = _Run(train, arith or Exact(), moments)
        x = pixels.permute(0, 3, 1, 2).float() / 127.5 - 1.0
        s = self.stem
        x = s[1](s[0](x, run), run)
        x = _max_valid(s[2](x, run))
        x = _max_valid(s[4](s[3](x, run), run))
        for block in self.blocks:
            x = block(x, run)
        feats = x.mean(dim=(2, 3))
        if train and self.dropout > 0:
            keep = 1.0 - self.dropout
            mask = torch.rand(feats.shape, generator=generator, device=feats.device) < keep
            feats = torch.where(mask, feats / keep, torch.zeros_like(feats))
        return run.arith.linear(feats, self.head.weight, self.head.bias)
