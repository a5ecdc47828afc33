"""Triggers, window identities and the window buffer — the
micro-batching and windowing building blocks.

Copy of ``flink_tensorflow_tpu/core/windows.py``: ``CountWindow`` and
``TimeWindow`` (``:25-35``); the ``Trigger`` protocol with its retention
hooks for sliding windows (``:46-80``); ``CountTrigger`` (``:82``) fires
at B elements; ``CountOrTimeoutTrigger`` (``:92``) fires at B elements or
``timeout_s`` after the first one, so a sparse stream never waits longer
than that for a full batch; ``AdaptiveLatencyTrigger`` (``:118-223``)
fires a partial window as soon as an EWMA of the arrival gaps says it
cannot fill inside a latency budget; ``SlidingCountTrigger`` (``:224``) fires every
``slide`` elements with the last ``size``; ``WindowBuffer`` (``:252``)
holds one open window, and ``snapshot_buffers`` / ``restore_buffers``
(``:274-296``) carry open windows through a checkpoint.
"""

from __future__ import annotations

import dataclasses
import time
import typing


@dataclasses.dataclass(frozen=True)
class CountWindow:
    """Identifies the n-th tumbling count window of a key or subtask."""

    index: int


@dataclasses.dataclass(frozen=True)
class TimeWindow:
    """An event-time window ``[start, end)``."""

    start: float
    end: float


class Trigger:
    """Decides when a window fires (fire-and-purge, or fire-and-retain for
    a sliding trigger)."""

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

    def clone(self) -> "Trigger":
        """Per-subtask copy: stateless triggers are shared; one with
        estimator state returns a fresh copy, so subtasks never share it."""
        return self

    def retains(self) -> bool:
        """Whether a fire carries elements over into the next window."""
        return False

    def fire_elements(self, window_state: "WindowBuffer") -> typing.List[typing.Any]:
        """The elements a fire hands to the function."""
        return window_state.elements

    def retain_count(self, window_state: "WindowBuffer") -> int:
        """How many trailing elements seed the next window."""
        return 0


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


class AdaptiveLatencyTrigger(Trigger):
    """Latency-targeted batching: fire at ``count`` elements, and fire a
    partial window early once it provably cannot fill inside
    ``latency_budget_s``.

    Per open window, with an EWMA of the inter-arrival gap:

    - full (``n >= count``): fire;
    - projected fill ``last_arrival + (count - n) * gap`` within
      ``first_arrival + latency_budget_s``: wait for the count;
    - otherwise fire one expected gap after the last arrival (so a burst
      still coalesces), never after the budget.

    The budget is end to end, so a service time fed back by the window
    operator (``observe_service_time``: the model runner's per-batch EWMA)
    pulls that deadline forward to ``hard - service``, but never before
    one expected gap after the first arrival (windows of one record
    would cost more calls than the offered rate allows).  The EWMA is
    per subtask (``clone``) and pools the keys of a keyed window."""

    def __init__(self, count: int, latency_budget_s: float, *, ewma_alpha: float = 0.25):
        if count <= 0:
            raise ValueError(f"count must be positive, got {count}")
        if latency_budget_s <= 0:
            raise ValueError(f"latency_budget_s must be positive, got {latency_budget_s}")
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1], got {ewma_alpha}")
        self.count = count
        self.latency_budget_s = latency_budget_s
        self.ewma_alpha = ewma_alpha
        self._gap_ewma: typing.Optional[float] = None
        self._last_arrival: typing.Optional[float] = None
        self._service_ewma: typing.Optional[float] = None

    def clone(self) -> "AdaptiveLatencyTrigger":
        return AdaptiveLatencyTrigger(self.count, self.latency_budget_s,
                                      ewma_alpha=self.ewma_alpha)

    def observe_service_time(self, service_s: float) -> None:
        """The observed per-batch service time (dispatch -> results)."""
        self._service_ewma = service_s

    def on_element(self, window_state):
        now = time.monotonic()
        if self._last_arrival is not None:
            gap = now - self._last_arrival
            self._gap_ewma = (gap if self._gap_ewma is None
                              else (1.0 - self.ewma_alpha) * self._gap_ewma
                              + self.ewma_alpha * gap)
        self._last_arrival = now
        if len(window_state.elements) >= self.count:
            return True
        d = self.deadline(window_state)
        return d is not None and now >= d

    def deadline(self, window_state):
        if not window_state.elements:
            return None
        hard = window_state.first_element_time + self.latency_budget_s
        if self._gap_ewma is None or self._last_arrival is None:
            return hard  # no rate estimate yet: a plain timeout
        remaining = self.count - len(window_state.elements)
        if self._last_arrival + remaining * self._gap_ewma <= hard:
            return hard  # on track to fill: the count fires it
        d = min(hard, self._last_arrival + self._gap_ewma)
        if self._service_ewma is not None:
            reserved = hard - self._service_ewma
            d = min(d, max(reserved, window_state.first_element_time + self._gap_ewma))
        return d


class SlidingCountTrigger(Trigger):
    """Fire every ``slide`` new elements with the last ``size`` (Flink's
    ``countWindow(size, slide)``): the first fires are partial, and each
    fire carries the trailing ``size - slide`` elements forward."""

    def __init__(self, size: int, slide: int):
        if size <= 0 or slide <= 0:
            raise ValueError(f"size and slide must be positive, got {size}, {slide}")
        self.size = size
        self.slide = slide

    def on_element(self, window_state):
        return len(window_state.elements) - window_state.retained >= self.slide

    def retains(self):
        return True

    def fire_elements(self, window_state):
        return window_state.elements[-self.size:]

    def retain_count(self, window_state):
        return min(len(window_state.elements), max(0, self.size - self.slide))


@dataclasses.dataclass
class WindowBuffer:
    """Accumulating contents of one in-flight window."""

    window: typing.Any
    elements: typing.List[typing.Any] = dataclasses.field(default_factory=list)
    timestamps: typing.List[typing.Optional[float]] = dataclasses.field(default_factory=list)
    first_element_time: float = 0.0
    #: Leading elements carried over from the previous fire (sliding
    #: windows): a trigger counts the arrivals past them.
    retained: int = 0
    #: The window fired at least once (an event-time window kept alive by
    #: allowed lateness re-fires on a late arrival; end of input does not
    #: fire it again).
    fired: bool = False

    def add(self, value: typing.Any, timestamp: typing.Optional[float]) -> None:
        if not self.elements:
            self.first_element_time = time.monotonic()
        self.elements.append(value)
        self.timestamps.append(timestamp)


def snapshot_buffers(buffers: typing.Mapping[typing.Any, WindowBuffer]) -> dict:
    """Picklable snapshot of open windows (the count and the event-time
    window operators share it), in the JAX package's layout."""
    return {
        key: (buf.window, list(buf.elements), list(buf.timestamps), buf.retained, buf.fired)
        for key, buf in buffers.items()
    }


def restore_buffers(snap: dict) -> typing.Dict[typing.Any, WindowBuffer]:
    out: typing.Dict[typing.Any, WindowBuffer] = {}
    for key, (window, elements, timestamps, *rest) in snap.items():
        # A snapshot without the retained count and fired flag restores
        # them as 0 and False.
        buf = WindowBuffer(window=window, retained=rest[0] if rest else 0,
                           fired=rest[1] if len(rest) > 1 else False)
        buf.elements = list(elements)
        buf.timestamps = list(timestamps)
        # A restart resets the processing-time clock: a timeout counts
        # from the restore, not from the wall time before the crash.
        buf.first_element_time = time.monotonic()
        out[key] = buf
    return out
