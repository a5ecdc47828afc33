"""Device meshes — the one-device subset.

Port of ``flink_tensorflow_tpu/parallel/mesh.py``: ``make_mesh``
(``:104``), ``batch_sharding`` (``:141``), ``shard_batch`` (``:177``) and
``replicate`` (``:199``).  In the reference a mesh is a
``jax.sharding.Mesh`` and XLA emits the collectives; in the port a mesh of
one device is that device, a "sharding" is a placement on it, and a
multi-device mesh (data parallelism across cards over
``torch.distributed``/NCCL) is a later slice: ``ROADMAP.md`` queue item 5.
"""

from __future__ import annotations

import dataclasses
import math
import typing

import numpy as np
import torch

from flink_tensorflow_tpu_torch.utils.device import resolve_device

#: The reference's canonical axis order (``mesh.py:AXIS_ORDER``).
AXIS_ORDER = ("pipe", "data", "fsdp", "expert", "seq", "model", "tp")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over devices.  ``shape`` maps axis -> size, as
    ``jax.sharding.Mesh.shape`` does."""

    shape: typing.Mapping[str, int]
    devices: typing.Tuple[torch.device, ...]

    @property
    def device(self) -> torch.device:
        """The one device of a one-device mesh."""
        return self.devices[0]


def make_mesh(axes: typing.Mapping[str, int], devices=None) -> Mesh:
    """``make_mesh({"data": 1})`` -> a mesh on ``cuda:0`` (raises without a
    card); ``devices=["cpu"]`` puts it on the CPU."""
    unknown = set(axes) - set(AXIS_ORDER)
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}; known: {AXIS_ORDER}")
    for name, size in axes.items():
        if size < 1:
            raise ValueError(f"axis {name} must be >=1, got {size}")
    n = math.prod(axes.values())
    if n != 1:
        raise NotImplementedError(
            f"mesh {dict(axes)} spans {n} devices: multi-GPU data parallelism "
            "(torch.distributed + NCCL) is not ported yet — ROADMAP.md queue item 5 "
            "(with ring/Ulysses attention); use a one-device mesh such as {'data': 1}")
    if devices is not None and len(devices) != 1:
        raise ValueError(f"mesh {dict(axes)} needs 1 device, got {len(devices)}")
    device = resolve_device("cuda:0" if devices is None else devices[0])
    names = tuple(a for a in AXIS_ORDER if a in axes)
    return Mesh({a: axes[a] for a in names}, (device,))


def batch_sharding(mesh: Mesh) -> torch.device:
    """Where a batch's dim 0 lives: on one device, the device itself."""
    return mesh.device


def shard_batch(mesh: Mesh, arrays: typing.Mapping[str, typing.Any]
                ) -> typing.Dict[str, torch.Tensor]:
    """Place a host batch (numpy arrays or tensors) on the mesh."""
    device = batch_sharding(mesh)
    out = {}
    for name, a in arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
        out[name] = t.to(device, non_blocking=True)
    return out


def replicate(mesh: Mesh, tree):
    """A COPY of every tensor of ``tree`` on the mesh device (dicts, lists
    and tuples walked; other leaves kept).  Always a copy, also where the
    tensor is already there: the train step updates its state in place,
    and must never write through to the caller's tree (a restored
    snapshot, another function's state)."""
    device = mesh.device
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=True)
    if isinstance(tree, dict):
        return {k: replicate(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(mesh, v) for v in tree)
    return tree
