"""Device meshes over one device, or over a cohort of processes.

Port of ``flink_tensorflow_tpu/parallel/mesh.py``: ``make_mesh``
(``:104``), ``batch_sharding`` (``:141``), ``spans_processes``
(``:158``), ``shard_batch`` (``:177``) and ``replicate`` (``:199``).  In
the reference a mesh is a ``jax.sharding.Mesh`` and XLA emits the
collectives.  In the port:

- a mesh of one device is that device, and a "sharding" a placement on
  it (no process group: the single-process path);
- a mesh over a ``torch.distributed`` cohort (``parallel.multihost.
  initialize``) has ONE device per process and as many processes as the
  axes' product.  Processes are laid out row-major over the axes in the
  reference's canonical order (``AXIS_ORDER``: ``data`` outside ``seq``),
  as the reference lays out devices off a TPU.  Each axis gets its
  process group (the default group when the axis spans the whole mesh,
  else one sub-group per line of the axis), which the collectives of
  ``parallel/collectives.py`` run over.  A mesh of one over a cohort of
  one is such a mesh too: its collectives are copies.
"""

from __future__ import annotations

import dataclasses
import math
import typing

import numpy as np
import torch
import torch.distributed as dist

from flink_tensorflow_tpu_torch.parallel import collectives
from flink_tensorflow_tpu_torch.utils.device import resolve_device

#: The reference's canonical axis order (``mesh.py:AXIS_ORDER``).
AXIS_ORDER = ("pipe", "data", "fsdp", "expert", "seq", "model", "tp")
DATA_AXIS = "data"
SEQ_AXIS = "seq"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over devices.  ``shape`` maps axis -> size, as
    ``jax.sharding.Mesh.shape`` does; ``devices`` holds this process's
    device.  Over a cohort, ``coords`` is this process's index on each
    axis and ``groups`` each axis's process group."""

    shape: typing.Mapping[str, int]
    devices: typing.Tuple[torch.device, ...]
    coords: typing.Mapping[str, int] = dataclasses.field(default_factory=dict)
    groups: typing.Mapping[str, typing.Any] = dataclasses.field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        """This process's device."""
        return self.devices[0]

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def distributed(self) -> bool:
        """Built over a ``torch.distributed`` cohort (collectives run)."""
        return bool(self.groups)

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        """The process group of ``axis`` (None off a cohort)."""
        return self.groups.get(axis)


def _axis_groups(names, sizes, rank: int) -> typing.Dict[str, typing.Any]:
    """One process group per axis line holding ``rank``.  Every process
    creates every sub-group, in the same order, as ``new_group`` needs."""
    total = math.prod(sizes)
    grid = np.arange(total).reshape(sizes)
    groups = {}
    for ax, name in enumerate(names):
        if sizes[ax] == total:
            groups[name] = dist.group.WORLD
            continue
        if sizes[ax] == 1:
            continue
        lines = np.moveaxis(grid, ax, -1).reshape(-1, sizes[ax])
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[name] = g
    return groups


def make_mesh(axes: typing.Mapping[str, int], devices=None) -> Mesh:
    """``make_mesh({"data": 1})`` -> a mesh on ``cuda:0`` (raises without a
    card); ``devices=["cpu"]`` puts it on the CPU.  Inside a cohort of as
    many processes as the axes' product (``multihost.initialize``) it
    spans them, one device per process: ``devices`` then names this
    process's device (default: its card, ``multihost.local_device``)."""
    unknown = set(axes) - set(AXIS_ORDER)
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}; known: {AXIS_ORDER}")
    for name, size in axes.items():
        if size < 1:
            raise ValueError(f"axis {name} must be >=1, got {size}")
    names = tuple(a for a in AXIS_ORDER if a in axes)
    shape = {a: axes[a] for a in names}
    n = math.prod(shape.values())
    in_cohort = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if in_cohort else 1
    if devices is not None and len(devices) != 1:
        raise ValueError(f"mesh {dict(axes)} takes this process's one device, "
                         f"got {len(devices)}")
    if n == 1 and world != 1:
        # One device of a larger cohort: a local mesh, no collectives.
        in_cohort = False
    if not in_cohort:
        if n != 1:
            raise ValueError(
                f"mesh {dict(axes)} spans {n} processes (one device each): join a cohort "
                "of that size with parallel.multihost.initialize first")
        device = resolve_device("cuda:0" if devices is None else devices[0])
        return Mesh(shape, (device,))
    if world != n:
        raise ValueError(f"mesh {dict(axes)} needs {n} processes, the cohort has {world}")
    from flink_tensorflow_tpu_torch.parallel.multihost import local_device

    device = local_device(None if devices is None else devices[0])
    rank = dist.get_rank()
    sizes = [shape[a] for a in names]
    coords = dict(zip(names, (int(c) for c in np.unravel_index(rank, sizes))))
    return Mesh(shape, (device,), coords, _axis_groups(names, sizes, rank))


def spans_processes(mesh: Mesh) -> bool:
    """True when the mesh's devices live in more than one process: each
    process then holds only its own rows of a batch."""
    return mesh.distributed and mesh.size > 1


def batch_sharding(mesh: Mesh) -> torch.device:
    """Where this process's rows of a batch live: its device."""
    return mesh.device


def shard_batch(mesh: Mesh, arrays: typing.Mapping[str, typing.Any]
                ) -> typing.Dict[str, torch.Tensor]:
    """Place this process's rows of a batch (numpy arrays or tensors) on
    its device.  On one device that is the whole batch; over a cohort it
    is this process's shard of the global batch (each process ingests
    its own partition), as the reference's multi-process ``shard_batch``."""
    device = batch_sharding(mesh)
    out = {}
    for name, a in arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
        out[name] = t.to(device, non_blocking=True)
    return out


def _tensors(tree) -> typing.Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _copy_to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=True)
    if isinstance(tree, dict):
        return {k: _copy_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy_to(v, device) for v in tree)
    return tree


def replicate(mesh: Mesh, tree):
    """A COPY of every tensor of ``tree`` on this process's device (dicts,
    lists and tuples walked; other leaves kept).  Always a copy, also where
    the tensor is already there: the train step updates its state in
    place, and must never write through to the caller's tree.  Over a
    cohort, rank 0's tensors are broadcast to every process (one broadcast
    per dtype), so all replicas start from the same bits."""
    out = _copy_to(tree, mesh.device)
    if mesh.distributed:
        collectives.broadcast_(list(_tensors(out)), src=0)
    return out

