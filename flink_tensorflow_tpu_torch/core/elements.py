"""Stream elements — the wire protocol between operator subtasks.

Port of ``flink_tensorflow_tpu/core/elements.py``: records, event-time
watermarks (``:43``), checkpoint barriers, end of partition, the
``SideOutput`` envelope (``:70``), the record's ``trace`` context that routes a record to a named side
stream, and ``SOURCE_IDLE`` (``:83-93``), the heartbeat a waiting source
yields.  Records crossing a channel or a checkpoint carry host values
only.
"""

from __future__ import annotations

import dataclasses
import typing


@dataclasses.dataclass(slots=True)
class StreamRecord:
    """A data record with an optional event-time timestamp.

    ``trace`` carries the span tracer's per-record context
    (``tracing.TraceContext``) when the job runs traced AND this record
    was sampled at its source; None otherwise.  It rides through channel
    queues with the record (JAX ``core/elements.py:30-39``); a columnar
    frame of the record plane carries values and timestamps only."""

    value: typing.Any
    timestamp: typing.Optional[float] = None
    trace: typing.Optional[typing.Any] = None


@dataclasses.dataclass(slots=True, frozen=True)
class Watermark:
    """Event-time watermark: no record with a timestamp <= ``timestamp``
    follows on this channel."""

    timestamp: float


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


StreamElement = typing.Union[StreamRecord, Watermark, CheckpointBarrier, EndOfPartition]


@dataclasses.dataclass(slots=True, frozen=True)
class SideOutput:
    """A value routed to the side output ``tag`` (late records of an
    event-time window, Flink's ``sideOutputLateData``).  An operator
    emits it on its regular output; ``DataStream.side_output(tag)`` taps
    and unwraps it, and the main stream filters it out."""

    tag: str
    value: typing.Any


class SourceIdle:
    """What a source function yields while it waits (a pacing sleep): no
    record is emitted, but the source loop gets a turn to serve
    checkpoint barriers and notifications, which it can only do between
    yields."""

    __slots__ = ()


SOURCE_IDLE = SourceIdle()
