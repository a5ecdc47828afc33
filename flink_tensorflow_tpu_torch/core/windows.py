"""Count triggers and the window buffer — the micro-batching building blocks.

Copy of ``flink_tensorflow_tpu/core/windows.py``: ``CountTrigger``
(``:82``) fires at B elements; ``CountOrTimeoutTrigger`` (``:92``) fires
at B elements or ``timeout_s`` after the first one, so a sparse stream
never waits longer than that for a full batch; ``WindowBuffer``
(``:252``) holds one open window.
"""

from __future__ import annotations

import dataclasses
import time
import typing


@dataclasses.dataclass(frozen=True)
class CountWindow:
    """Identifies the n-th tumbling count window of a subtask."""

    index: int


class Trigger:
    """Decides when a window fires (fire-and-purge)."""

    def on_element(self, window_state: "WindowBuffer") -> bool:
        raise NotImplementedError

    def deadline(self, window_state: "WindowBuffer") -> typing.Optional[float]:
        """Processing-time deadline at which the window must flush, or None."""
        return None

    def has_deadlines(self) -> bool:
        """Whether this trigger can ever declare a wall-clock deadline:
        arrival-driven triggers keep the base ``deadline`` and say no, so
        their windows may fuse into a source chain."""
        return type(self).deadline is not Trigger.deadline


class CountTrigger(Trigger):
    def __init__(self, count: int):
        if count <= 0:
            raise ValueError(f"count must be positive, got {count}")
        self.count = count

    def on_element(self, window_state):
        return len(window_state.elements) >= self.count


class CountOrTimeoutTrigger(Trigger):
    """Fire at ``count`` elements or ``timeout_s`` after the first one."""

    def __init__(self, count: int, timeout_s: float):
        if count <= 0:
            raise ValueError(f"count must be positive, got {count}")
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be positive, got {timeout_s}")
        self.count = count
        self.timeout_s = timeout_s

    def on_element(self, window_state):
        return len(window_state.elements) >= self.count

    def deadline(self, window_state):
        if not window_state.elements:
            return None
        return window_state.first_element_time + self.timeout_s


@dataclasses.dataclass
class WindowBuffer:
    """Accumulating contents of one in-flight window."""

    window: typing.Any
    elements: typing.List[typing.Any] = dataclasses.field(default_factory=list)
    timestamps: typing.List[typing.Optional[float]] = dataclasses.field(default_factory=list)
    first_element_time: float = 0.0

    def add(self, value: typing.Any, timestamp: typing.Optional[float]) -> None:
        if not self.elements:
            self.first_element_time = time.monotonic()
        self.elements.append(value)
        self.timestamps.append(timestamp)
