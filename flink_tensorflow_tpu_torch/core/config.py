"""Typed job configuration.

Port of ``flink_tensorflow_tpu/core/config.py:JobConfig`` (``:85``) with
the fields the ported runtime reads.  The port always runs with chaining
off — the reference's ``JobConfig(chaining=False)`` layout: one thread
and one input gate per operator subtask.
"""

from __future__ import annotations

import dataclasses
import typing


@dataclasses.dataclass(frozen=True)
class JobConfig:
    #: Default operator parallelism.
    parallelism: int = 1
    #: Bounded capacity of inter-subtask channels (records).
    channel_capacity: int = 1024
    #: Sleep between source emissions — test/backpressure pacing.
    source_throttle_s: float = 0.0
    #: ``(task_name, subtask_index) -> device`` (``"cpu"``, ``"cuda:0"``,
    #: a ``torch.device``).  None: model subtasks take
    #: ``utils.device.resolve_device(None)`` — the GPU, or an error.
    device_provider: typing.Optional[typing.Callable[[str, int], typing.Any]] = None

    def validate(self) -> "JobConfig":
        if self.parallelism < 1:
            raise ValueError(f"parallelism must be >= 1, got {self.parallelism}")
        if self.channel_capacity < 1:
            raise ValueError(f"channel_capacity must be >= 1, got {self.channel_capacity}")
        if self.source_throttle_s < 0:
            raise ValueError(f"source_throttle_s must be >= 0, got {self.source_throttle_s}")
        if self.device_provider is not None and not callable(self.device_provider):
            raise ValueError("device_provider must be callable (task, idx) -> device")
        return self
