"""ResNet-50 — the data-parallel training workload.

Port of ``flink_tensorflow_tpu/models/zoo/resnet.py`` (``:28-138``):
stem (7x7/2 conv, BN, ReLU, 3x3/2 max pool) -> bottleneck stages
``(3, 4, 6, 3)`` at width 64 -> global mean -> Dense, 224x224x3 inputs,
1000 classes.  Convs run on ``channels_last`` tensors in
``compute_dtype`` (bf16) on f32 master weights; the head is f32.

What is held equal to the flax definition:

- flax ``"SAME"`` padding is asymmetric at stride 2 on an even input: the
  3x3/2 conv of a block pads ``(0, 1)``, not ``(1, 1)`` (``F.conv2d(padding=1)``
  would shift every window by a pixel), so ``"SAME"`` is padded
  explicitly from the input size; the 1x1/2 projection pads nothing; the
  stem conv's ``(3, 3)`` and the max pool's ``(1, 1)`` padding are
  symmetric (the pool pads with -inf);
- batch norm in train mode is flax's, not ``F.batch_norm``'s: the batch
  mean and variance are taken in f32 as ``E[x]`` and ``max(E[x^2] -
  E[x]^2, 0)`` (biased), the running statistics move as ``0.9 ra + 0.1
  batch`` with that BIASED variance, eps is 1e-5, and the normalisation
  runs in f32 on the ``compute_dtype`` input with one rounding on the
  way out.  Pad rows of a batch enter the statistics (only the loss is
  ``valid``-weighted).  Inside a data-parallel step over a cohort the
  two moments are the global batch's (``parallel.collectives.
  batch_moments``), as XLA computes them over the reference's sharded
  batch.  In eval mode BN uses the running statistics;
- the last BN of each block starts with scale 0;
- the head's mean over H and W accumulates in f32 and rounds to
  ``compute_dtype`` (``jnp.mean`` of a bf16 tensor); the Dense runs in f32.

Train mode: ``forward(x, stats)`` with a dict ``stats`` computes batch
statistics and writes each BN's new running statistics into it under the
buffer's ``state_dict`` name (the module's own buffers are not touched):
the ``batch_stats`` collection that flax returns from
``apply(mutable=["batch_stats"])``.
"""

from __future__ import annotations

import typing

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from flink_tensorflow_tpu_torch.models.base import ModelMethod
from flink_tensorflow_tpu_torch.models.zoo._common import lecun_normal_, weighted_metrics
from flink_tensorflow_tpu_torch.models.zoo.registry import ModelDef, register_model_def
from flink_tensorflow_tpu_torch.ops.preprocessing import inception_normalize
from flink_tensorflow_tpu_torch.parallel import collectives
from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, spec

BN_EPSILON = 1e-5
BN_MOMENTUM = 0.9
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

Stats = typing.Optional[typing.Dict[str, torch.Tensor]]


def same_padding(size: int, kernel: int, stride: int) -> typing.Tuple[int, int]:
    """flax/XLA ``"SAME"`` padding of one spatial dim: ``(low, high)`` with
    the odd pixel on the high side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=compute)``."""

    def __init__(self, features: int, scale_init: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.full((features,), scale_init))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        #: ``state_dict`` prefix, set by the owning :class:`ResNet`.
        self.path = ""

    def forward(self, x: torch.Tensor, stats: Stats) -> torch.Tensor:
        if stats is None:
            mean, var = self.mean, self.var
        else:
            xf = x.float()
            mean, mean_sq = collectives.batch_moments(xf.mean(dim=(0, 2, 3)),
                                                      (xf * xf).mean(dim=(0, 2, 3)))
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            with torch.no_grad():
                stats[self.path + "mean"] = BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mean
                stats[self.path + "var"] = BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + BN_EPSILON) * self.scale
        y = (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False, dtype=compute)``: ``padding`` is
    ``"SAME"`` or explicit ``(pad_h, pad_w)``; the kernel is cast to the
    input's dtype and layout per call (the f32 master weight trains)."""

    def __init__(self, cin: int, features: int, kernel: int, stride: int = 1,
                 padding: typing.Union[str, typing.Tuple[int, int]] = "SAME"):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(features, cin, kernel, kernel))   # OIHW
        self.kernel = kernel
        self.stride = stride
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype, memory_format=torch.channels_last)
        if self.padding == "SAME":
            ph = same_padding(x.shape[2], self.kernel, self.stride)
            pw = same_padding(x.shape[3], self.kernel, self.stride)
            if ph[0] == ph[1] and pw[0] == pw[1]:
                return F.conv2d(x, w, None, self.stride, (ph[0], pw[0]))
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            return F.conv2d(x, w, None, self.stride, 0)
        return F.conv2d(x, w, None, self.stride, self.padding)


class BottleneckBlock(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv(cin, filters, 1)
        self.bn1 = BatchNorm(filters)
        self.conv2 = Conv(filters, filters, 3, stride)
        self.bn2 = BatchNorm(filters)
        self.conv3 = Conv(filters, filters * 4, 1)
        self.bn3 = BatchNorm(filters * 4, scale_init=0.0)
        # flax projects when the residual's shape differs from the output's.
        if stride != 1 or cin != filters * 4:
            self.proj = Conv(cin, filters * 4, 1, stride)
            self.proj_bn = BatchNorm(filters * 4)
        else:
            self.proj = self.proj_bn = None

    def forward(self, x: torch.Tensor, stats: Stats) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), stats))
        y = F.relu(self.bn2(self.conv2(y), stats))
        y = self.bn3(self.conv3(y), stats)
        residual = x if self.proj is None else self.proj_bn(self.proj(x), stats)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """The whole net.  ``forward`` takes ``[B, 3, H, W]`` (a
    ``channels_last`` view of HWC records, any dtype) and returns f32
    logits; ``stats`` (a dict) selects train-mode batch norm."""

    def __init__(self, stage_sizes: typing.Sequence[int] = (3, 4, 6, 3), num_classes: int = 1000,
                 width: int = 64, compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.stem = Conv(3, width, 7, 2, (3, 3))
        self.stem_bn = BatchNorm(width)
        blocks = []
        cin = width
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(BottleneckBlock(cin, width * 2 ** i, stride))
                cin = width * 2 ** i * 4
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes)   # f32, (out, in)
        for name, m in self.named_modules():
            if isinstance(m, BatchNorm):
                m.path = name + "."

    def forward(self, x: torch.Tensor, stats: Stats = None) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        x = F.relu(self.stem_bn(self.stem(x), stats))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for block in self.blocks:
            x = block(x, stats)
        feats = x.mean(dim=(2, 3), dtype=torch.float32).to(self.compute_dtype)
        return self.head(feats.float())


def init_resnet(module: ResNet, generator: torch.Generator) -> ResNet:
    """The port's initialiser: flax's init distributions (lecun-normal
    kernels, zero biases, batch norm scale 1 (0 for each block's last),
    bias 0, running mean 0 and var 1) from ``generator``."""
    for m in module.modules():
        if isinstance(m, Conv):
            o, i, kh, kw = m.weight.shape
            lecun_normal_(m.weight, i * kh * kw, generator)
    lecun_normal_(module.head.weight, module.head.in_features, generator)
    with torch.no_grad():
        module.head.bias.zero_()
    return module


def softmax_cross_entropy_with_integer_labels(logits: torch.Tensor,
                                              labels: torch.Tensor) -> torch.Tensor:
    """``optax.softmax_cross_entropy_with_integer_labels``: per-example
    ``logsumexp(logits) - logits[label]``."""
    return F.cross_entropy(logits, labels.long(), reduction="none")


@register_model_def("resnet50")
def build(num_classes: int = 1000, image_size: int = 224, width: int = 64,
          stage_sizes: typing.Tuple[int, ...] = (3, 4, 6, 3),
          uint8_input: bool = False, compute_dtype: str = "bfloat16") -> ModelDef:
    """``uint8_input=True``: records carry raw uint8 pixels and the model
    normalizes on the device (``x/127.5 - 1``, rounded to bf16 as the
    reference does).  ``compute_dtype`` is the reference's bf16, or
    float32 for the plain f32 path."""
    dtype = _DTYPES[compute_dtype]
    schema = RecordSchema({"image": spec((image_size, image_size, 3),
                                         np.uint8 if uint8_input else np.float32)})

    def make_module() -> ResNet:
        return ResNet(tuple(stage_sizes), num_classes, width, dtype)

    def prep(image: torch.Tensor) -> torch.Tensor:
        x = image.permute(0, 3, 1, 2)   # HWC records -> channels_last NCHW view
        # The reference normalizes to bf16 whatever the compute dtype.
        return inception_normalize(x) if uint8_input else x

    def serve(module: ResNet, inputs):
        logits = module(prep(inputs["image"]))
        return {"logits": logits,
                "label": torch.argmax(logits, dim=-1).to(torch.int32),
                "prob": torch.softmax(logits, dim=-1)}

    def init_fn(seed) -> ResNet:
        return init_resnet(make_module(), torch.Generator().manual_seed(int(seed)))

    def load_fn(params) -> ResNet:
        if isinstance(params, ResNet):
            return params
        from flink_tensorflow_tpu_torch.models.convert import resnet_from_flax

        return resnet_from_flax(params, make_module())

    def loss_fn(module: ResNet, batch, generator):
        stats: typing.Dict[str, torch.Tensor] = {}
        logits = module(prep(batch["image"]), stats)
        labels = batch["label"]
        per_ex = softmax_cross_entropy_with_integer_labels(logits, labels)
        hits = (torch.argmax(logits, -1) == labels).float()
        loss, acc = weighted_metrics(per_ex, hits, batch.get("valid"))
        return loss, ({"batch_stats": stats}, {"loss": loss, "accuracy": acc})

    return ModelDef(
        architecture="resnet50",
        config={"num_classes": num_classes, "image_size": image_size, "width": width,
                "stage_sizes": list(stage_sizes), "uint8_input": uint8_input,
                "compute_dtype": compute_dtype},
        module=ResNet,
        input_schema=schema,
        methods={"serve": ModelMethod(name="serve", input_schema=schema,
                                      output_names=("logits", "label", "prob"), fn=serve)},
        init_fn=init_fn,
        load_fn=load_fn,
        loss_fn=loss_fn,
        make_module=make_module,
    )
