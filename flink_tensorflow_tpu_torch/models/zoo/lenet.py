"""LeNet-5 — the MNIST windowed micro-batch workload.

Port of ``flink_tensorflow_tpu/models/zoo/lenet.py`` (``:22-91``): a 5x5
``"SAME"`` conv (6), ReLU, a 2x2 ``"VALID"`` average pool, a 5x5
``"VALID"`` conv (16), ReLU, a pool, then Dense 120 -> 84 -> classes.
Convs and dense products are ``torch.nn.functional`` calls (cuDNN and
cuBLAS on the card), as they are XLA ops in the reference.

What is held equal to the flax definition:

- records are HWC (``[28, 28, 1]`` f32); the batch permuted to NCHW is a
  ``channels_last`` view, and the convs run on it without a layout copy;
- convs and the hidden Dense layers run in ``compute_dtype`` (input,
  kernel and bias cast; flax ``dtype=bf16``); the pools sum and divide by
  4; the head runs in f32;
- ``"SAME"`` at stride 1 pads 2 on each side;
- the flatten before ``Dense_0`` is in (H, W, C) order, flax's NHWC
  reshape: ``Dense_0.kernel`` rows carry over as they are.

Parameter names (``state_dict``): ``conv1``, ``conv2`` (OIHW), ``fc1``,
``fc2``, ``head`` (``(out, in)``); flax ``Conv_0``, ``Conv_1`` (HWIO),
``Dense_0``, ``Dense_1``, ``Dense_2``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from flink_tensorflow_tpu_torch.models.base import ModelMethod
from flink_tensorflow_tpu_torch.models.zoo._common import lecun_normal_, weighted_metrics
from flink_tensorflow_tpu_torch.models.zoo.registry import ModelDef, register_model_def
from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, spec

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class LeNet(nn.Module):
    """``forward`` takes ``[B, C, H, W]`` (a ``channels_last`` view of HWC
    records, any float dtype) and returns f32 logits."""

    def __init__(self, num_classes: int = 10, image_size: int = 28, channels: int = 1,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = nn.Conv2d(channels, 6, 5, padding=2)
        self.conv2 = nn.Conv2d(6, 16, 5)
        side = (image_size // 2 - 4) // 2
        self.fc1 = nn.Linear(16 * side * side, 120)
        self.fc2 = nn.Linear(120, 84)
        self.head = nn.Linear(84, num_classes)

    def _conv(self, x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
        dt = self.compute_dtype
        w = conv.weight.to(dt, memory_format=torch.channels_last)
        return F.relu(F.conv2d(x, w, conv.bias.to(dt), 1, conv.padding))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = x.to(dt)
        x = F.avg_pool2d(self._conv(x, self.conv1), 2, 2)
        x = F.avg_pool2d(self._conv(x, self.conv2), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # flax's NHWC flatten
        for layer in (self.fc1, self.fc2):
            x = F.relu(F.linear(x, layer.weight.to(dt), layer.bias.to(dt)))
        return self.head(x.float())


def init_lenet(module: LeNet, generator: torch.Generator) -> LeNet:
    """The port's initialiser: flax's defaults (lecun-normal kernels, zero
    biases) from ``generator``."""
    for layer in (module.conv1, module.conv2, module.fc1, module.fc2, module.head):
        lecun_normal_(layer.weight, layer.weight[0].numel(), generator)
        with torch.no_grad():
            layer.bias.zero_()
    return module


@register_model_def("lenet")
def build(num_classes: int = 10, image_size: int = 28, channels: int = 1,
          compute_dtype: str = "bfloat16") -> ModelDef:
    """``compute_dtype`` is the reference's bf16, or float32 for the plain
    f32 path."""
    dtype = _DTYPES[compute_dtype]
    schema = RecordSchema({"image": spec((image_size, image_size, channels), np.float32)})

    def make_module() -> LeNet:
        return LeNet(num_classes, image_size, channels, dtype)

    def logits_of(module: LeNet, image: torch.Tensor) -> torch.Tensor:
        return module(image.permute(0, 3, 1, 2))   # HWC records -> channels_last NCHW view

    def serve(module: LeNet, inputs):
        logits = logits_of(module, inputs["image"])
        return {"logits": logits,
                "label": torch.argmax(logits, dim=-1).to(torch.int32),
                "prob": torch.softmax(logits, dim=-1)}

    def init_fn(seed) -> LeNet:
        return init_lenet(make_module(), torch.Generator().manual_seed(int(seed)))

    def load_fn(params) -> LeNet:
        if isinstance(params, LeNet):
            if params.compute_dtype == dtype:
                return params
            module = make_module()   # the same weights at this def's dtype
            module.load_state_dict(params.state_dict())
            return module
        from flink_tensorflow_tpu_torch.models.convert import lenet_from_flax

        return lenet_from_flax(params, make_module())

    def loss_fn(module: LeNet, batch, generator):
        logits = logits_of(module, batch["image"])
        labels = batch["label"].long()
        per_ex = F.cross_entropy(logits, labels, reduction="none")
        hits = (torch.argmax(logits, -1) == labels).float()
        loss, acc = weighted_metrics(per_ex, hits, batch.get("valid"))
        return loss, ({}, {"loss": loss, "accuracy": acc})

    return ModelDef(
        architecture="lenet",
        config={"num_classes": num_classes, "image_size": image_size, "channels": channels,
                "compute_dtype": compute_dtype},
        module=LeNet,
        input_schema=schema,
        methods={"serve": ModelMethod(name="serve", input_schema=schema,
                                      output_names=("logits", "label", "prob"), fn=serve)},
        init_fn=init_fn,
        load_fn=load_fn,
        loss_fn=loss_fn,
        make_module=make_module,
    )
