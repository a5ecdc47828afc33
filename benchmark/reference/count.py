"""Operations and bytes of a configuration's convolutions and matmuls.

The count runs the reference module of a configuration on meta tensors
(nothing is allocated or computed) under ``torch.utils.flop_counter``'s
``FlopCounterMode`` and a dispatch mode of its own that records, per
convolution and matmul (forward and, for training, backward), the bytes
of every operand and output once.  Convolution operands count at the
configuration's compute dtype; matmuls at 4 bytes an element unless the
caller names their dtype (the image models' dense head runs in float32).
So the count is the same whatever implements the work, and a later
change to the program cannot move it.

``count_work`` counts any call on meta tensors: a job kind prices its
own record with it (``jobs.Job.work_count``).  ``count`` is the image
models' record: one image forward, or a training step's batch.

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


def count_work(run: typing.Callable[[], typing.Any], *, compute_dtype: str, records: int,
               matmul_dtype: str = "float32") -> Count:
    """The work of ``run()``, divided by ``records``: every conv and
    matmul it calls (forward and, where it calls ``autograd.grad``,
    backward) with its FLOPs and bytes, convolutions' operands at
    ``compute_dtype`` and matmuls' at ``matmul_dtype``.  ``run`` works on
    meta tensors, so nothing is allocated or computed; it builds its own
    inputs, so a record may be an image, a step's batch or a served
    request (a prefill and its decode steps over the growing cache)."""
    flop_mode = FlopCounterMode(display=False)
    replay = _Replay(_ITEMSIZE[compute_dtype], _ITEMSIZE[matmul_dtype])
    with flop_mode, replay:
        run()
    total = float(sum(flop_mode.get_flop_counts().get("Global", {}).values()))
    return Count([Work(name, flops / records, nbytes / records)
                  for name, flops, nbytes in replay.ops], total / records)


def count(module_cls, model_config: typing.Mapping[str, typing.Any], *, batch: int,
          image_size: int, train: bool) -> Count:
    """The work of one batch of ``batch`` images, divided by ``batch``:
    the forward pass, or for ``train`` the forward, the loss and the
    backward pass.  ``model_config`` holds the reference's keyword
    arguments and ``compute_dtype``."""
    with torch.device("meta"):
        module = module_cls(**model_config)
        pixels = torch.zeros((batch, image_size, image_size, 3), dtype=torch.uint8)
        labels = torch.zeros((batch,), dtype=torch.long)

    def step() -> None:
        logits = module(pixels, train=train)
        if train:
            loss = F.cross_entropy(logits, labels)
            torch.autograd.grad(loss, list(module.parameters()))

    return count_work(step, compute_dtype=model_config["compute_dtype"], records=batch)


class _Replay(TorchDispatchMode):
    """Each conv and matmul call with its own FLOPs (flop_counter's
    formula for that op) and bytes."""

    def __init__(self, itemsize: int, matmul_itemsize: int):
        super().__init__()
        self.registry = flop_registry
        self.itemsize = itemsize
        self.matmul_itemsize = matmul_itemsize
        self.ops: typing.List[typing.Tuple[str, float, float]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if (func in _CONV or func in _MM) and packet in self.registry:
            flops = self.registry[packet](*args, **kwargs, out_val=out)
            size = self.itemsize if func in _CONV else self.matmul_itemsize
            elems = sum(t.numel() for t in _tensors(list(args) + [out]))
            self.ops.append((packet.__name__, float(flops), float(elems * size)))
        return out
