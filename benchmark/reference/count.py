"""Operations and bytes of a configuration's convolutions and matmuls.

The count runs the reference module of a configuration on meta tensors
(nothing is allocated or computed) under ``torch.utils.flop_counter``'s
``FlopCounterMode`` and a dispatch mode of its own that records, per
convolution and matmul (forward and, for training, backward), the bytes
of every operand and output once.  Convolution operands count at the
configuration's compute dtype; matmuls (the dense head, which the
system runs in float32) at 4 bytes an element.  So the count is the
same whatever implements the work, and a later change to the program
cannot move it.

Peaks: NVIDIA's H100 SXM data sheet, dense bfloat16 and HBM3.
"""

from __future__ import annotations

import dataclasses
import typing

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

PEAK_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}

_aten = torch.ops.aten
_CONV = {_aten.convolution.default, _aten.convolution_backward.default}
_MM = {_aten.mm.default, _aten.addmm.default, _aten.bmm.default}


@dataclasses.dataclass
class Work:
    """One conv or matmul: its FLOPs and its bytes."""

    op: str
    flops: float
    bytes: float

    @property
    def least_s(self) -> float:
        return max(self.flops / PEAK_FLOPS, self.bytes / PEAK_BYTES_PER_S)


def _tensors(tree) -> typing.Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)


@dataclasses.dataclass
class Count:
    """Per record: every conv and matmul's work, and every op's FLOPs."""

    work: typing.List[Work]
    total_flops: float

    @property
    def flops(self) -> float:
        return sum(w.flops for w in self.work)

    @property
    def bytes(self) -> float:
        return sum(w.bytes for w in self.work)

    @property
    def least_s(self) -> float:
        return sum(w.least_s for w in self.work)


def count(module_cls, model_config: typing.Mapping[str, typing.Any], *, batch: int,
          image_size: int, train: bool) -> Count:
    """The work of one batch of ``batch`` records, divided by ``batch``:
    the forward pass, or for ``train`` the forward, the loss and the
    backward pass.  ``model_config`` holds the reference's keyword
    arguments and ``compute_dtype``."""
    itemsize = _ITEMSIZE[model_config["compute_dtype"]]
    with torch.device("meta"):
        module = module_cls(**model_config)
        pixels = torch.zeros((batch, image_size, image_size, 3), dtype=torch.uint8)
        labels = torch.zeros((batch,), dtype=torch.long)
    flop_mode = FlopCounterMode(display=False)
    replay = _Replay(itemsize)
    with flop_mode, replay:
        logits = module(pixels, train=train)
        if train:
            loss = F.cross_entropy(logits, labels)
            torch.autograd.grad(loss, list(module.parameters()))
    total = float(sum(flop_mode.get_flop_counts().get("Global", {}).values()))
    return Count([Work(name, flops / batch, nbytes / batch) for name, flops, nbytes in replay.ops],
                 total / batch)


class _Replay(TorchDispatchMode):
    """Each conv and matmul call with its own FLOPs (flop_counter's
    formula for that op) and bytes."""

    def __init__(self, itemsize: int):
        super().__init__()
        self.registry = flop_registry
        self.itemsize = itemsize
        self.ops: typing.List[typing.Tuple[str, float, float]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if (func in _CONV or func in _MM) and packet in self.registry:
            flops = self.registry[packet](*args, **kwargs, out_val=out)
            size = self.itemsize if func in _CONV else 4
            elems = sum(t.numel() for t in _tensors(list(args) + [out]))
            self.ops.append((packet.__name__, float(flops), float(elems * size)))
        return out
