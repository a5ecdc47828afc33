"""Inception-v3 — the north-star workload's model.

Port of ``flink_tensorflow_tpu/models/zoo/inception.py``: stem -> 3x
InceptionA -> ReductionA -> 4x InceptionB -> ReductionB -> 2x InceptionC
-> global mean -> Dense, 299x299x3 inputs, 1000 classes, at the
reference's own layer widths.  Convs, batch norm, pooling and the head
are ``torch.nn.functional`` calls (cuDNN/cuBLAS on the card), as they are
XLA ops in the reference.

What is held equal to the flax definition:

- records are HWC; the batch ``[B, H, W, 3]`` permuted to ``[B, 3, H, W]``
  is already ``channels_last`` in memory, and every conv runs on
  ``channels_last`` tensors, so no layout copy is made;
- a conv runs on ``compute_dtype`` inputs and a ``compute_dtype`` copy of
  its f32 kernel (flax ``nn.Conv(dtype=bf16)``);
- batch norm (``epsilon=1e-3``) normalizes in f32 against f32 running
  statistics, then casts to ``compute_dtype`` (flax ``nn.BatchNorm(dtype=
  bf16)``); BN is not folded into the conv weights;
- ``"SAME"`` convs (all odd kernels at stride 1) pad symmetrically;
  the max pools are VALID 3x3 at stride 2; the 3x3 average pool is
  ``"SAME"`` with the padding counted (flax ``avg_pool`` = torch's
  ``count_include_pad=True``);
- the head's mean over H and W accumulates in f32 and rounds to
  ``compute_dtype`` (``jnp.mean`` of a bf16 tensor); the Dense head runs
  in f32.

Train mode (the reference's ``apply(train=True, mutable=["batch_stats"],
rngs={"dropout": rng})``): ``forward(x, stats, generator)`` with a dict
``stats`` normalizes by the batch's moments, taken in f32 as flax takes
them (``E[x]`` and ``max(E[x^2] - E[x]^2, 0)``, biased; over a cohort the
global batch's, ``parallel.collectives.batch_moments``; on the card a
fused kernel pair, ``ops.batch_norm.batch_norm_train``), and writes each
batch norm's new running statistics, ``0.9997 ra + 0.0003 batch``, into
``stats`` under the buffer's ``state_dict`` name (the module's own
buffers are not touched).  Dropout on the pooled features keeps each
with probability ``1 - dropout_rate``, drawn from ``generator`` (the
caller's ``torch.Generator`` on the features' device), and scales the
kept ones by ``1 / (1 - dropout_rate)``, as flax's ``nn.Dropout``.

Weights: the port's own initialiser (:func:`init_inception`, from an
explicit ``torch.Generator``, the same distributions as flax's init) or
flax ``variables`` carried across by ``models/convert.py``.
"""

from __future__ import annotations

import copy
import typing

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from flink_tensorflow_tpu_torch.models.base import ModelMethod
from flink_tensorflow_tpu_torch.models.zoo._common import lecun_normal_, weighted_metrics
from flink_tensorflow_tpu_torch.models.zoo.registry import ModelDef, register_model_def
from flink_tensorflow_tpu_torch.ops.batch_norm import batch_norm_train
from flink_tensorflow_tpu_torch.ops.preprocessing import _rounded, inception_normalize
from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, spec

BN_EPSILON = 1e-3
BN_MOMENTUM = 0.9997

Stats = typing.Optional[typing.Dict[str, torch.Tensor]]


class ConvBN(nn.Module):
    """conv -> batchnorm -> relu, the Inception "BasicConv2d" unit."""

    def __init__(self, cin: int, features: int, kernel: typing.Tuple[int, int],
                 strides: typing.Tuple[int, int] = (1, 1), padding: str = "VALID"):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(features, cin, *kernel))   # OIHW
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.stride = tuple(strides)
        self.padding = (kernel[0] // 2, kernel[1] // 2) if padding == "SAME" else (0, 0)
        #: ``state_dict`` prefix, set by the owning :class:`InceptionV3`.
        self.path = ""

    def forward(self, x: torch.Tensor, stats: Stats = None) -> torch.Tensor:
        w = self.weight.to(x.dtype, memory_format=torch.channels_last)
        y = F.conv2d(x, w, None, self.stride, self.padding)
        if stats is None:
            # Mixed-type batch norm: bf16 in, f32 statistics and
            # arithmetic, one rounding to bf16 on the way out.
            y = F.batch_norm(y, self.mean, self.var, self.scale, self.bias, False, 0.0,
                             BN_EPSILON)
            return F.relu(y, inplace=True)
        y, stats[self.path + "mean"], stats[self.path + "var"] = batch_norm_train(
            y, self.scale, self.bias, self.mean, self.var, eps=BN_EPSILON,
            momentum=BN_MOMENTUM, relu=True)
        return y


def _avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, padding=1)


def _max_pool_valid(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.convs = nn.ModuleList([
            ConvBN(cin, 64, (1, 1)),
            ConvBN(cin, 48, (1, 1)),
            ConvBN(48, 64, (5, 5), padding="SAME"),
            ConvBN(cin, 64, (1, 1)),
            ConvBN(64, 96, (3, 3), padding="SAME"),
            ConvBN(96, 96, (3, 3), padding="SAME"),
            ConvBN(cin, pool_features, (1, 1)),
        ])
        self.out_channels = 64 + 64 + 96 + pool_features

    def forward(self, x, stats: Stats = None):
        c = self.convs
        b1 = c[0](x, stats)
        b5 = c[2](c[1](x, stats), stats)
        b3 = c[5](c[4](c[3](x, stats), stats), stats)
        bp = c[6](_avg_pool_same(x), stats)
        return torch.cat([b1, b5, b3, bp], 1)


class ReductionA(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.convs = nn.ModuleList([
            ConvBN(cin, 384, (3, 3), strides=(2, 2)),
            ConvBN(cin, 64, (1, 1)),
            ConvBN(64, 96, (3, 3), padding="SAME"),
            ConvBN(96, 96, (3, 3), strides=(2, 2)),
        ])
        self.out_channels = 384 + 96 + cin

    def forward(self, x, stats: Stats = None):
        c = self.convs
        b3 = c[0](x, stats)
        bd = c[3](c[2](c[1](x, stats), stats), stats)
        return torch.cat([b3, bd, _max_pool_valid(x)], 1)


class InceptionB(nn.Module):
    """The 17x17 blocks with factorized 7x7 (1x7 then 7x1) convs."""

    def __init__(self, cin: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.convs = nn.ModuleList([
            ConvBN(cin, 192, (1, 1)),
            ConvBN(cin, c7, (1, 1)),
            ConvBN(c7, c7, (1, 7), padding="SAME"),
            ConvBN(c7, 192, (7, 1), padding="SAME"),
            ConvBN(cin, c7, (1, 1)),
            ConvBN(c7, c7, (7, 1), padding="SAME"),
            ConvBN(c7, c7, (1, 7), padding="SAME"),
            ConvBN(c7, c7, (7, 1), padding="SAME"),
            ConvBN(c7, 192, (1, 7), padding="SAME"),
            ConvBN(cin, 192, (1, 1)),
        ])
        self.out_channels = 4 * 192

    def forward(self, x, stats: Stats = None):
        c = self.convs
        b1 = c[0](x, stats)
        b7 = c[3](c[2](c[1](x, stats), stats), stats)
        bd = c[8](c[7](c[6](c[5](c[4](x, stats), stats), stats), stats), stats)
        bp = c[9](_avg_pool_same(x), stats)
        return torch.cat([b1, b7, bd, bp], 1)


class ReductionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.convs = nn.ModuleList([
            ConvBN(cin, 192, (1, 1)),
            ConvBN(192, 320, (3, 3), strides=(2, 2)),
            ConvBN(cin, 192, (1, 1)),
            ConvBN(192, 192, (1, 7), padding="SAME"),
            ConvBN(192, 192, (7, 1), padding="SAME"),
            ConvBN(192, 192, (3, 3), strides=(2, 2)),
        ])
        self.out_channels = 320 + 192 + cin

    def forward(self, x, stats: Stats = None):
        c = self.convs
        b3 = c[1](c[0](x, stats), stats)
        b7 = c[5](c[4](c[3](c[2](x, stats), stats), stats), stats)
        return torch.cat([b3, b7, _max_pool_valid(x)], 1)


class InceptionC(nn.Module):
    """The 8x8 blocks with split 1x3/3x1 branches."""

    def __init__(self, cin: int):
        super().__init__()
        self.convs = nn.ModuleList([
            ConvBN(cin, 320, (1, 1)),
            ConvBN(cin, 384, (1, 1)),
            ConvBN(384, 384, (1, 3), padding="SAME"),
            ConvBN(384, 384, (3, 1), padding="SAME"),
            ConvBN(cin, 448, (1, 1)),
            ConvBN(448, 384, (3, 3), padding="SAME"),
            ConvBN(384, 384, (1, 3), padding="SAME"),
            ConvBN(384, 384, (3, 1), padding="SAME"),
            ConvBN(cin, 192, (1, 1)),
        ])
        self.out_channels = 320 + 4 * 384 + 192

    def forward(self, x, stats: Stats = None):
        c = self.convs
        b1 = c[0](x, stats)
        b3 = c[1](x, stats)
        bd = c[5](c[4](x, stats), stats)
        bp = c[8](_avg_pool_same(x), stats)
        return torch.cat([b1, c[2](b3, stats), c[3](b3, stats), c[6](bd, stats),
                          c[7](bd, stats), bp], 1)


class InceptionV3(nn.Module):
    """The whole net.  ``forward`` takes ``[B, 3, H, W]`` (any dtype; a
    ``channels_last`` view of HWC records) and returns f32 logits;
    ``stats`` (a dict) selects train mode, ``generator`` feeds dropout."""

    def __init__(self, num_classes: int = 1000, compute_dtype: torch.dtype = torch.bfloat16,
                 dropout_rate: float = 0.2):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.dropout_rate = dropout_rate
        self.stem = nn.ModuleList([
            ConvBN(3, 32, (3, 3), strides=(2, 2)),
            ConvBN(32, 32, (3, 3)),
            ConvBN(32, 64, (3, 3), padding="SAME"),
            ConvBN(64, 80, (1, 1)),
            ConvBN(80, 192, (3, 3)),
        ])
        blocks: typing.List[nn.Module] = []
        cin = 192
        for make in (lambda c: InceptionA(c, 32), lambda c: InceptionA(c, 64),
                     lambda c: InceptionA(c, 64), ReductionA,
                     lambda c: InceptionB(c, 128), lambda c: InceptionB(c, 160),
                     lambda c: InceptionB(c, 160), lambda c: InceptionB(c, 192),
                     ReductionB, InceptionC, InceptionC):
            block = make(cin)
            blocks.append(block)
            cin = block.out_channels
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes)   # f32, (out, in)
        for name, m in self.named_modules():
            if isinstance(m, ConvBN):
                m.path = name + "."

    def forward(self, x: torch.Tensor, stats: Stats = None,
                generator: typing.Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        s = self.stem
        x = s[1](s[0](x, stats), stats)
        x = _max_pool_valid(s[2](x, stats))
        x = _max_pool_valid(s[4](s[3](x, stats), stats))
        for block in self.blocks:
            x = block(x, stats)
        feats = x.mean(dim=(2, 3), dtype=torch.float32).to(self.compute_dtype)
        if stats is not None and self.dropout_rate > 0:
            keep = 1.0 - self.dropout_rate
            mask = torch.rand(feats.shape, generator=generator, device=feats.device) < keep
            feats = torch.where(mask, feats / _rounded(keep, feats.dtype),
                                torch.zeros((), dtype=feats.dtype, device=feats.device))
        return self.head(feats.float())


def init_inception(module: InceptionV3, generator: torch.Generator) -> InceptionV3:
    """The port's initialiser: flax's init distributions (lecun-normal
    kernels, zero biases, identity batch norm) from ``generator``."""
    for m in module.modules():
        if isinstance(m, ConvBN):
            o, i, kh, kw = m.weight.shape
            lecun_normal_(m.weight, i * kh * kw, generator)
    lecun_normal_(module.head.weight, module.head.in_features, generator)
    with torch.no_grad():
        module.head.bias.zero_()
    return module


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@register_model_def("inception_v3")
def build(num_classes: int = 1000, image_size: int = 299, uint8_input: bool = False,
          compute_dtype: str = "bfloat16") -> ModelDef:
    """``uint8_input=True``: records carry raw uint8 pixels and the model
    normalizes on the device (``x/127.5 - 1``).  ``compute_dtype`` is the
    reference's bf16, or float32 for the plain f32 path."""
    dtype = _DTYPES[compute_dtype]
    schema = RecordSchema({"image": spec((image_size, image_size, 3),
                                         np.uint8 if uint8_input else np.float32)})

    def serve(module: InceptionV3, inputs):
        x = inputs["image"].permute(0, 3, 1, 2)   # HWC records -> channels_last NCHW view
        if uint8_input:
            x = inception_normalize(x, module.compute_dtype)
        logits = module(x)
        prob = torch.softmax(logits, dim=-1)
        return {"logits": logits,
                "label": torch.argmax(logits, dim=-1).to(torch.int32),
                "score": prob.max(dim=-1).values}

    def make_module() -> InceptionV3:
        return InceptionV3(num_classes, dtype)

    def init_fn(seed) -> InceptionV3:
        gen = torch.Generator().manual_seed(int(seed))
        return init_inception(make_module(), gen)

    def load_fn(params) -> InceptionV3:
        if isinstance(params, InceptionV3):
            if params.compute_dtype == dtype:
                return params
            module = copy.deepcopy(params)   # the same weights at this def's dtype
            module.compute_dtype = dtype
            return module
        from flink_tensorflow_tpu_torch.models.convert import inception_from_flax

        return inception_from_flax(params, InceptionV3(num_classes, dtype))

    def loss_fn(module: InceptionV3, batch, generator):
        stats: typing.Dict[str, torch.Tensor] = {}
        x = batch["image"].permute(0, 3, 1, 2)
        if uint8_input:
            x = inception_normalize(x, module.compute_dtype)
        logits = module(x, stats, generator)
        labels = batch["label"]
        per_ex = F.cross_entropy(logits, labels.long(), reduction="none")
        hits = (torch.argmax(logits, -1) == labels).float()
        loss, acc = weighted_metrics(per_ex, hits, batch.get("valid"))
        return loss, ({"batch_stats": stats}, {"loss": loss, "accuracy": acc})

    return ModelDef(
        architecture="inception_v3",
        config={"num_classes": num_classes, "image_size": image_size,
                "uint8_input": uint8_input, "compute_dtype": compute_dtype},
        module=InceptionV3,
        input_schema=schema,
        methods={"serve": ModelMethod(name="serve", input_schema=schema,
                                      output_names=("logits", "label", "score"), fn=serve)},
        init_fn=init_fn,
        load_fn=load_fn,
        loss_fn=loss_fn,
        make_module=make_module,
    )
