"""Stream elements — the wire protocol between operator subtasks.

Port of ``flink_tensorflow_tpu/core/elements.py``: records, checkpoint
barriers and end of partition (watermarks come with event time).
Records crossing a channel or a checkpoint carry host values only.
"""

from __future__ import annotations

import dataclasses
import typing


@dataclasses.dataclass(slots=True)
class StreamRecord:
    """A data record with an optional event-time timestamp."""

    value: typing.Any
    timestamp: typing.Optional[float] = None


@dataclasses.dataclass(slots=True, frozen=True)
class CheckpointBarrier:
    """Chandy-Lamport snapshot barrier (Flink-style aligned checkpointing).

    Injected at sources by the checkpoint coordinator; operators align
    barriers across their input channels, snapshot state, then forward the
    barrier downstream."""

    checkpoint_id: int


@dataclasses.dataclass(slots=True, frozen=True)
class EndOfPartition:
    """Sent once per output channel when an upstream subtask finishes."""


StreamElement = typing.Union[StreamRecord, CheckpointBarrier, EndOfPartition]
