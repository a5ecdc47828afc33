"""ResNet-50, plain PyTorch in float32.

He et al., *Deep Residual Learning for Image Recognition*
(arXiv:1512.03385), Table 1, the 50-layer net: a 7x7/2 stem conv, a 3x3/2
max pool, bottleneck stages of (3, 4, 6, 3) blocks at widths 64, 128,
256, 512 (times 4 out), global mean, a 1000-way dense layer, batch norm
(eps 1e-5) after every conv.

Departures from the paper, each the one the system under test makes:

- the "v1.5" block: a stage's stride sits on the 3x3 conv, not the
  first 1x1; the shortcut projects (1x1 conv + batch norm) wherever the
  shape changes;
- the stride-2 3x3 conv pads "SAME" as flax and XLA do: the odd pixel of
  an even input goes on the high side, (0, 1), not (1, 1); the stem
  conv pads (3, 3) and the max pool (1, 1) with -inf;
- records are HWC uint8 pixels mapped to ``x / 127.5 - 1``;
- train-mode batch norm normalises by the batch's biased variance.

``width`` and ``stage_sizes`` exist only so the CPU tests can run a
small net; the configuration runs the published ones.

Parameter order: the stem conv's ``weight``, its norm's ``gamma`` and
``beta``; per block conv1, bn1, conv2, bn2, conv3, bn3, then the
projection and its norm where present; the head's ``weight`` and
``bias``.
"""

from __future__ import annotations

import typing

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.arith import Exact

EPS = 1e-5


class Norm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(c))
        self.beta = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, y, run):
        if run.train:
            mean = y.mean(dim=(0, 2, 3))
            var = y.var(dim=(0, 2, 3), unbiased=False)
            if run.moments is not None:
                run.moments[self] = (mean.detach(), var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1, 1, 1)
        y = (y - mean.view(shape)) / torch.sqrt(var.view(shape) + EPS)
        return y * self.gamma.view(shape) + self.beta.view(shape)


def _same(size: int, kernel: int, stride: int) -> typing.Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, pad=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel))
        self.kernel, self.stride, self.pad = kernel, stride, pad

    def forward(self, x, run):
        if self.pad is None:     # SAME, high side first
            ph = _same(x.shape[2], self.kernel, self.stride)
            pw = _same(x.shape[3], self.kernel, self.stride)
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            pad = (0, 0)
        else:
            pad = self.pad
        return run.arith.conv(x, self.weight, (self.stride, self.stride), pad)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, f: int, stride: int):
        super().__init__()
        self.conv1, self.bn1 = Conv(cin, f, 1), Norm(f)
        self.conv2, self.bn2 = Conv(f, f, 3, stride), Norm(f)
        self.conv3, self.bn3 = Conv(f, 4 * f, 1), Norm(4 * f)
        if stride != 1 or cin != 4 * f:
            self.proj, self.proj_bn = Conv(cin, 4 * f, 1, stride, (0, 0)), Norm(4 * f)
        else:
            self.proj = self.proj_bn = None

    def forward(self, x, run):
        y = F.relu(self.bn1(self.conv1(x, run), run))
        y = F.relu(self.bn2(self.conv2(y, run), run))
        y = self.bn3(self.conv3(y, run), run)
        short = x if self.proj is None else self.proj_bn(self.proj(x, run), run)
        return F.relu(y + short)


class _Run(typing.NamedTuple):
    train: bool
    arith: typing.Any
    #: Where train mode records each norm's batch mean and variance.
    moments: typing.Optional[dict]


class ResNet50(nn.Module):
    def __init__(self, num_classes: int = 1000, width: int = 64,
                 stage_sizes: typing.Sequence[int] = (3, 4, 6, 3), **_):
        super().__init__()
        self.stem, self.stem_bn = Conv(3, width, 7, 2, (3, 3)), Norm(width)
        blocks, cin = [], width
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                blocks.append(Bottleneck(cin, width * 2 ** i, 2 if i > 0 and j == 0 else 1))
                cin = 4 * width * 2 ** i
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes)

    def forward(self, pixels: torch.Tensor, *, train: bool = False, generator=None,
                arith=None, moments: typing.Optional[dict] = None):
        """``pixels`` ``[B, H, W, 3]`` uint8 -> ``[B, classes]`` logits
        (``generator`` is unused: the net has no dropout); in train mode
        ``moments`` (a dict) gets each norm's batch moments."""
        run = _Run(train, arith or Exact(), moments)
        x = pixels.permute(0, 3, 1, 2).float() / 127.5 - 1.0
        x = F.relu(self.stem_bn(self.stem(x, run), run))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for block in self.blocks:
            x = block(x, run)
        return run.arith.linear(x.mean(dim=(2, 3)), self.head.weight, self.head.bias)
