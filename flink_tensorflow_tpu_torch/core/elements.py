"""Stream elements — the wire protocol between operator subtasks.

Port of ``flink_tensorflow_tpu/core/elements.py``: the element types the
serving operator and its subtask loop touch (watermarks and barriers come
with the runtime slice).  Records crossing a channel or a checkpoint
carry host values only.
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
class EndOfPartition:
    """Sent once per output channel when an upstream subtask finishes."""


StreamElement = typing.Union[StreamRecord, EndOfPartition]
