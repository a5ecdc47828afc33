"""Typed job configuration.

Port of ``flink_tensorflow_tpu/core/config.py``: ``CheckpointConfig``
(``:27``) and ``JobConfig`` (``:85``) with the fields the ported runtime
reads, the gang operators' ``mesh`` (``:224``) among them, operator
``chaining`` (``:101-107``), ``device_resident`` (``:153-162``) and
``wire_dtype`` (``:170``, validated as ``:286-292``) with the reference's
defaults.
"""

from __future__ import annotations

import dataclasses
import typing

from flink_tensorflow_tpu_torch.tensors.serde import WIRE_DTYPES


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """Where and how often aligned snapshots persist."""

    #: Directory for persisted snapshots; None disables persistence.
    dir: typing.Optional[str] = None
    #: Periodic trigger interval; None means manual triggers only.
    interval_s: typing.Optional[float] = None
    #: Count-based triggers: each source injects barrier k after its
    #: k*N-th record, so barrier positions are a deterministic function
    #: of the stream.  Mutually exclusive with interval_s; disables manual
    #: triggers.
    every_n_records: typing.Optional[int] = None
    #: Budget for one aligned checkpoint to drain.
    timeout_s: float = 60.0
    #: Keep only the newest N completed checkpoints on disk (Flink's
    #: retained-checkpoints policy); None keeps everything.  Pruning runs
    #: after a newer checkpoint is durable.
    retain_last: typing.Optional[int] = None

    def validate(self) -> None:
        if self.interval_s is not None:
            if self.dir is None:
                raise ValueError("checkpoint.interval_s requires checkpoint.dir")
            if self.interval_s <= 0:
                raise ValueError(f"checkpoint.interval_s must be > 0, got {self.interval_s}")
        if self.every_n_records is not None:
            if self.dir is None:
                raise ValueError("checkpoint.every_n_records requires checkpoint.dir")
            if self.interval_s is not None:
                raise ValueError(
                    "checkpoint.every_n_records and interval_s are mutually "
                    "exclusive (count-based barriers must stay deterministic)")
            if self.every_n_records < 1:
                raise ValueError(
                    f"checkpoint.every_n_records must be >= 1, got {self.every_n_records}")
        if self.timeout_s <= 0:
            raise ValueError(f"checkpoint.timeout_s must be > 0, got {self.timeout_s}")
        if self.retain_last is not None:
            if self.dir is None:
                raise ValueError("checkpoint.retain_last requires checkpoint.dir")
            if self.retain_last < 1:
                raise ValueError(f"checkpoint.retain_last must be >= 1, got {self.retain_last}")


@dataclasses.dataclass(frozen=True)
class JobConfig:
    #: Default operator parallelism.
    parallelism: int = 1
    #: Key-group count (Flink's maxParallelism): the upper bound on keyed
    #: parallelism, fixed for the job's lifetime so keyed state can be
    #: redistributed when a restart changes parallelism.
    max_parallelism: int = 128
    #: Bounded capacity of inter-subtask channels (records).
    channel_capacity: int = 1024
    #: Operator chaining (``analysis/chaining.py``): forward neighbours at
    #: equal parallelism fuse into one subtask thread and records pass by
    #: direct call instead of a queue hop.  False is the comparison
    #: layout: one thread and one input gate per operator subtask.
    #: Per-operator opt-outs: ``stream.start_new_chain()`` /
    #: ``stream.disable_chaining()``.
    chaining: bool = True
    #: Device-resident dataflow (``tensors/transfer.py:DeviceBatch``): a
    #: model fused ahead of an operator that consumes device batches
    #: (another model, a ``DeviceMapFunction``) hands it the batch on the
    #: card, with no D2H and no H2D in between; the first host-only
    #: consumer materializes it once.  Per-function override:
    #: ``ModelMapFunction(device_resident=True/False)``.
    device_resident: bool = False
    #: Narrower H2D dtype for float fields (``"bf16"``, ``"f16"``,
    #: ``"int8"``; None or ``"f32"`` ships them as they are): model
    #: runners narrow host-side into the pinned staging slot and widen
    #: back to the declared dtype as the first step of the call.  Per
    #: function: ``ModelWindowFunction(wire_dtype=...)``.  The environment
    #: variable ``FLINK_TPU_WIRE_DTYPE`` applies when this is None.
    wire_dtype: typing.Optional[str] = None
    #: Sleep between source emissions — test/backpressure pacing.
    source_throttle_s: float = 0.0
    #: ``(task_name, subtask_index) -> device`` (``"cpu"``, ``"cuda:0"``,
    #: a ``torch.device``).  None: model subtasks take
    #: ``utils.device.resolve_device(None)`` — the GPU, or an error.
    device_provider: typing.Optional[typing.Callable[[str, int], typing.Any]] = None
    #: ``parallel.mesh.Mesh`` shared with gang operators (the DP trainer);
    #: ``env.set_mesh``.
    mesh: typing.Optional[typing.Any] = None
    #: Aligned snapshots: directory, trigger mode, retention.
    checkpoint: CheckpointConfig = dataclasses.field(default_factory=CheckpointConfig)

    def validate(self) -> "JobConfig":
        if self.parallelism < 1:
            raise ValueError(f"parallelism must be >= 1, got {self.parallelism}")
        if self.max_parallelism < 1:
            raise ValueError(f"max_parallelism must be >= 1, got {self.max_parallelism}")
        if self.channel_capacity < 1:
            raise ValueError(f"channel_capacity must be >= 1, got {self.channel_capacity}")
        for flag in ("chaining", "device_resident"):
            if not isinstance(getattr(self, flag), bool):
                raise ValueError(f"{flag} must be a bool, got {getattr(self, flag)!r}")
        if self.wire_dtype is not None and self.wire_dtype not in WIRE_DTYPES:
            raise ValueError(f"wire_dtype must be one of {WIRE_DTYPES} or None, "
                             f"got {self.wire_dtype!r}")
        if self.source_throttle_s < 0:
            raise ValueError(f"source_throttle_s must be >= 0, got {self.source_throttle_s}")
        if self.device_provider is not None and not callable(self.device_provider):
            raise ValueError("device_provider must be callable (task, idx) -> device")
        if self.mesh is not None and not (hasattr(self.mesh, "shape")
                                          and hasattr(self.mesh, "devices")):
            raise ValueError("mesh must be a parallel.mesh.Mesh (make_mesh), got "
                             f"{type(self.mesh).__name__}")
        self.checkpoint.validate()
        return self
