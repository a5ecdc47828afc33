"""Process cohorts over ``torch.distributed`` — one process per device.

Port of ``flink_tensorflow_tpu/parallel/multihost.py``: ``HostTopology``
(``:29``), ``initialize`` (``:38``) and ``global_mesh`` (``:141``).  In
the reference every host runs the same job and ``jax.distributed``
forms the cohort; here every process runs the same job and joins a
``torch.distributed`` process group, given its address, world size and
rank (nothing discovers them).  Each process owns ONE device: the card
``cuda:<rank mod cards>`` (so ranks share a card when there are more
ranks than cards), or the CPU when the caller asks for it.

The backend follows the device: ``nccl`` for a card, ``gloo`` for the
CPU (``backend=`` overrides it: gloo also sums and broadcasts CUDA
tensors).  The reference's ``hybrid_device_array`` (``:103``) lays one
global ``jax.Array`` out over slices; torch has no global array: each
rank holds its own rows (``parallel.mesh.shard_batch``), and the
collectives over the mesh's process groups combine them.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import typing

import torch
import torch.distributed as dist

from flink_tensorflow_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

#: The port's own variables for a launcher (the reference reads
#: ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``).
ENV_ADDRESS = "FLINK_TPU_TORCH_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "FLINK_TPU_TORCH_NUM_PROCESSES"
ENV_PROCESS_ID = "FLINK_TPU_TORCH_PROCESS_ID"


@dataclasses.dataclass(frozen=True)
class HostTopology:
    """This process's view of the cohort after :func:`initialize`."""

    process_id: int
    num_processes: int
    local_devices: int
    global_devices: int


def _env_int(name: str) -> typing.Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def topology() -> HostTopology:
    """The cohort as it stands: a single process when no group is formed."""
    if not (dist.is_available() and dist.is_initialized()):
        return HostTopology(0, 1, 1, 1)
    world = dist.get_world_size()
    return HostTopology(dist.get_rank(), world, 1, world)


def initialize(coordinator_address: typing.Optional[str] = None,
               num_processes: typing.Optional[int] = None,
               process_id: typing.Optional[int] = None, *,
               device=None, backend: typing.Optional[str] = None,
               timeout_s: float = 300.0) -> HostTopology:
    """Join the cohort: ``init_process_group`` at ``tcp://<address>``
    (``host:port``; a full ``tcp://`` URL is taken as it is).  Arguments
    default from ``FLINK_TPU_TORCH_COORDINATOR_ADDRESS``,
    ``FLINK_TPU_TORCH_NUM_PROCESSES`` and ``FLINK_TPU_TORCH_PROCESS_ID``.

    Idempotent: a process already in a group gets its topology back.  A
    world of one with no address is a no-op, as in the reference; with an
    address it forms a real group of one (its collectives are copies).
    ``device`` is where this process runs (None: the card, which must
    exist; ``"cpu"`` selects gloo)."""
    address = coordinator_address or os.environ.get(ENV_ADDRESS)
    world = num_processes if num_processes is not None else _env_int(ENV_NUM_PROCESSES)
    rank = process_id if process_id is not None else _env_int(ENV_PROCESS_ID)
    if dist.is_initialized():
        if world is not None and world != dist.get_world_size():
            raise ValueError(f"this process is already in a cohort of {dist.get_world_size()}, "
                             f"not {world}")
        return topology()
    if address is None:
        if world in (None, 1):
            return topology()
        raise ValueError(f"a cohort of {world} processes needs a coordinator address "
                         f"(argument or {ENV_ADDRESS})")
    world = 1 if world is None else world
    if rank is None:
        if world != 1:
            raise ValueError(f"process_id is required in a cohort of {world} "
                             f"(argument or {ENV_PROCESS_ID})")
        rank = 0
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} outside [0, {world})")
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(local_device(dev, rank=rank))
    init_method = address if "://" in address else f"tcp://{address}"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    logger.info("joined cohort: process %d/%d via %s (%s)", rank, world, init_method, backend)
    return topology()


def shutdown() -> None:
    """Leave the cohort (destroys the default group and every sub-group)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def local_device(device=None, *, rank: typing.Optional[int] = None) -> torch.device:
    """This process's one device: ``device`` when given (a bare ``cuda``
    takes the rank's card), else ``cuda:<rank mod cards>``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        if rank is None:
            rank = dist.get_rank() if dist.is_initialized() else 0
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def global_mesh(axes: typing.Mapping[str, int], *, device=None):
    """A mesh over the whole cohort (one device per process), after
    :func:`initialize`: ``parallel.mesh.make_mesh`` with this process's
    device.  The reference's ``dcn_axis`` has no counterpart: the
    processes are laid out row-major over the axes."""
    from flink_tensorflow_tpu_torch.parallel.mesh import make_mesh

    if not dist.is_initialized():
        raise RuntimeError("global_mesh needs a cohort: call multihost.initialize first")
    return make_mesh(axes, devices=[local_device(device)])
