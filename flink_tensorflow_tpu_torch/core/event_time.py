"""Event time: timestamp assignment, watermarks, event-time windows.

Port of ``flink_tensorflow_tpu/core/event_time.py``:

- :class:`TimestampAssignerOperator` (``:77``) stamps records with event
  time from a user function and emits a bounded-out-of-orderness
  watermark (``max_ts - slack``) every ``watermark_every`` records, and
  ``Watermark(inf)`` at end of input;
- :class:`EventTimeWindowOperator` (``:126``): tumbling or sliding
  windows, keyed or global, fired in window order as the watermark passes
  their end, with window starts in integer nanoseconds (``:167-183``),
  late records to a side output (``late_tag``) and re-fires inside
  ``allowed_lateness_s``;
- :class:`SessionWindowOperator` (``:315``): per-key sessions with a fixed
  inactivity gap, merged when they touch;
- :func:`_min_watermark` (``:31``): the watermark a rescale restores.

The runtime merges watermarks per input channel (the minimum over live
channels, ``core/runtime.py``) and the snapshot protocol covers open
windows and sessions, so event-time jobs get exactly-once windows.

Results of a window are stamped with the window's end.  The reference
stamps the results of a pipelined model function with the end of the
window whose fire drained them, which is a later one at
``pipeline_depth > 1``, hands end of input an unstamped collector, and
forwards a watermark while batches are still in flight.  Here a window
function emits each result to the collector of its own window
(``ModelWindowFunction``), the operator flushes the function's in-flight
work before it forwards a watermark (``flush_in_flight``), end of input
drains into the same per-window collectors, and the operator serves the
function's ``next_deadline`` / ``fire_due`` timers as ``WindowOperator``
does.
"""

from __future__ import annotations

import math
import typing

from flink_tensorflow_tpu_torch.core import elements as el
from flink_tensorflow_tpu_torch.core import functions as fn
from flink_tensorflow_tpu_torch.core.operators import (
    Operator,
    StateNotRescalable,
    _FunctionOperator,
)
from flink_tensorflow_tpu_torch.core.windows import (
    TimeWindow,
    WindowBuffer,
    restore_buffers,
    snapshot_buffers,
)

GLOBAL_KEY = "__subtask__"


def _min_watermark(states: typing.List[typing.Any]) -> float:
    """The watermark of a rescale restore: the minimum over the old
    subtasks is safe on every new one."""
    marks = [s["watermark"] for s in states if s]
    return min(marks) if marks else -math.inf


def _end_stamped_collector(output, end: float) -> fn.Collector:
    """Results carry the window's end unless the function stamps one."""
    return fn.Collector(lambda v, ts=None: output.emit(v, end if ts is None else ts))


def _require_timestamp(name: str, what: str, record: el.StreamRecord) -> float:
    if record.timestamp is None:
        raise ValueError(f"{name}: {what} got a record without a timestamp — add "
                         ".assign_timestamps(...) upstream")
    return record.timestamp


class _WatermarkLag:
    """Watermark metrics: the ``watermarks`` counter (emitted by an
    assigner, taken by a window), and the ``watermark_lag_s`` gauge, how
    far the watermark trails the newest event time this operator saw
    (``max_event_ts - watermark``, in event time), sampled at each finite
    watermark and held."""

    _max_event_ts: float = -math.inf
    _last_lag_s: typing.Optional[float] = None
    _watermarks = None

    def _register_lag_gauge(self) -> None:
        if self.ctx is not None:
            self.ctx.metrics.gauge("watermark_lag_s", lambda: self._last_lag_s)
            self._watermarks = self.ctx.metrics.counter("watermarks")

    def _note_event_ts(self, ts: float) -> None:
        if ts > self._max_event_ts:
            self._max_event_ts = ts

    def _note_watermark(self, watermark_ts: float) -> None:
        if self._watermarks is not None:
            self._watermarks.inc()
        if math.isfinite(watermark_ts) and math.isfinite(self._max_event_ts):
            self._last_lag_s = max(0.0, self._max_event_ts - watermark_ts)


class TimestampAssignerOperator(_WatermarkLag, Operator):
    """Stamps records with ``ts_fn(value)`` and emits periodic watermarks.

    ``out_of_orderness_s`` is the lateness bound: the watermark trails the
    largest timestamp seen by that much, so records up to that far out of
    order still land in their window.  A watermark goes out every
    ``watermark_every`` records, and only when it advances."""

    def __init__(self, name: str, ts_fn: typing.Callable[[typing.Any], float],
                 out_of_orderness_s: float = 0.0, watermark_every: int = 32):
        super().__init__(name)
        self.ts_fn = ts_fn
        self.slack = out_of_orderness_s
        self.watermark_every = max(1, watermark_every)
        self._max_ts = -math.inf
        self._emitted_wm = -math.inf
        self._since_wm = 0

    def open(self) -> None:
        self._register_lag_gauge()

    def process_record(self, record: el.StreamRecord) -> None:
        ts = float(self.ts_fn(record.value))
        self.output.emit(record.value, ts)
        self._max_ts = max(self._max_ts, ts)
        self._note_event_ts(ts)
        self._since_wm += 1
        if self._since_wm >= self.watermark_every:
            self._since_wm = 0
            wm = self._max_ts - self.slack
            if wm > self._emitted_wm:
                self._emitted_wm = wm
                self._note_watermark(wm)
                self.output.broadcast_element(el.Watermark(wm))

    def process_watermark(self, watermark: el.Watermark) -> None:
        pass  # this operator's watermarks replace the upstream ones

    def finish(self) -> None:
        # Close the stream's event time: every window downstream fires.
        self.output.broadcast_element(el.Watermark(math.inf))

    def _operator_snapshot(self):
        return {"max_ts": self._max_ts, "emitted_wm": self._emitted_wm}

    def _operator_restore(self, state):
        self._max_ts = state["max_ts"]
        self._emitted_wm = state["emitted_wm"]


class _EventTimeWindowBase(_WatermarkLag, _FunctionOperator):
    """What the time and session window operators share: the collector,
    the function's timers, and its in-flight flush ahead of a watermark."""

    def __init__(self, name: str, function: fn.WindowFunction, key_selector, late_tag):
        super().__init__(name, function)
        self.key_selector = key_selector
        #: Records too late for every window they belong to go out as
        #: ``SideOutput(late_tag, value)`` instead of being dropped.
        self.late_tag = late_tag
        self._watermark = -math.inf
        self._collector: typing.Optional[fn.Collector] = None

    def open(self) -> None:
        self._collector = fn.Collector(self.output.emit)
        self._register_lag_gauge()
        super().open()

    def _key_of(self, value):
        return self.key_selector(value) if self.key_selector is not None else GLOBAL_KEY

    def _emit_late(self, value, ts: float) -> None:
        if self.late_tag is not None:
            self.output.emit(el.SideOutput(self.late_tag, value), ts)

    def _call(self, key, window: TimeWindow, elements) -> None:
        if self.key_selector is not None:
            self.keyed_state.current_key = key
        self.function.process_window(key if self.key_selector is not None else None,
                                     window, elements,
                                     _end_stamped_collector(self.output, window.end))

    def _advance(self, watermark: el.Watermark) -> None:
        self._watermark = max(self._watermark, watermark.timestamp)
        self._note_watermark(self._watermark)

    def _forward(self, watermark: el.Watermark) -> None:
        # Every result of a window the watermark closed goes out first.
        self.function.flush_in_flight()
        self.output.broadcast_element(watermark)

    @property
    def uses_timers(self):
        return getattr(self.function, "next_deadline", None) is not None

    def next_deadline(self):
        hook = getattr(self.function, "next_deadline", None)
        return hook() if hook is not None else None

    def fire_due(self, now):
        hook = getattr(self.function, "fire_due", None)
        if hook is not None:
            hook(now)


class EventTimeWindowOperator(_EventTimeWindowBase):
    """Tumbling or sliding event-time windows, keyed or global.

    ``slide_s=None`` is tumbling; with a slide each record lands in every
    window ``[start, start + size)`` that contains it.  Windows fire in
    ``(start, key)`` order as the watermark passes their end.  With
    ``allowed_lateness_s`` a fired window's state lives until the
    watermark passes ``end + lateness``: a late record inside that horizon
    joins it and re-fires it at once with the updated contents."""

    def __init__(self, name: str, function: fn.WindowFunction, size_s: float,
                 key_selector=None, slide_s: typing.Optional[float] = None,
                 late_tag: typing.Optional[str] = None, allowed_lateness_s: float = 0.0):
        super().__init__(name, function, key_selector, late_tag)
        if size_s <= 0:
            raise ValueError(f"window size must be positive, got {size_s}")
        if slide_s is not None and slide_s <= 0:
            raise ValueError(f"window slide must be positive, got {slide_s}")
        if allowed_lateness_s < 0:
            raise ValueError(f"allowed lateness must be >= 0, got {allowed_lateness_s}")
        self.size = float(size_s)
        self.slide = float(slide_s) if slide_s is not None else float(size_s)
        self.lateness = float(allowed_lateness_s)
        self._buffers: typing.Dict[typing.Tuple[typing.Any, float], WindowBuffer] = {}

    def _windows_for(self, ts: float) -> typing.Iterator[typing.Tuple[float, float]]:
        """``(start, end)`` of every window that holds ``ts``, in integer
        nanoseconds: float floor and product mis-assign a record on a
        slide boundary that is not binary-representable (0.3 / 0.1)."""
        ts_ns = round(ts * 1e9)
        slide_ns = round(self.slide * 1e9)
        size_ns = round(self.size * 1e9)
        start_ns = (ts_ns // slide_ns) * slide_ns
        while start_ns > ts_ns - size_ns:
            # The end comes from the same integers, so assignment and
            # firing agree on boundaries.
            yield start_ns / 1e9, (start_ns + size_ns) / 1e9
            start_ns -= slide_ns

    def process_record(self, record: el.StreamRecord) -> None:
        ts = _require_timestamp(self.name, "event-time window", record)
        self._note_event_ts(ts)
        key = self._key_of(record.value)
        covered = assigned = False
        for start, end in self._windows_for(ts):
            covered = True
            if end + self.lateness <= self._watermark:
                continue  # past the lateness horizon
            assigned = True
            buf = self._buffers.get((key, start))
            if buf is None:
                buf = self._buffers[(key, start)] = WindowBuffer(window=TimeWindow(start, end))
            buf.add(record.value, ts)
            if end <= self._watermark:
                # Late, inside the horizon: re-fire with the new contents.
                self._fire((key, start))
        # A record in a gap between hopping windows (slide > size) belongs
        # to no window: dropped, never late.
        if covered and not assigned:
            self._emit_late(record.value, ts)

    def process_watermark(self, watermark: el.Watermark) -> None:
        self._advance(watermark)
        due = sorted((k for k, buf in self._buffers.items()
                      if buf.window.end <= self._watermark and not buf.fired),
                     key=lambda k: (k[1], str(k[0])))
        for k in due:
            self._fire(k)
        # Windows past the lateness horizon take no more records.
        for k in [k for k, buf in self._buffers.items()
                  if buf.window.end + self.lateness <= self._watermark]:
            del self._buffers[k]
        self._forward(watermark)

    def _fire(self, k) -> None:
        buf = self._buffers[k]
        buf.fired = True
        self._call(k[0], buf.window, buf.elements)

    def finish(self) -> None:
        # Fired windows kept for lateness already emitted their result.
        for k in sorted((k for k, buf in self._buffers.items() if not buf.fired),
                        key=lambda k: (k[1], str(k[0]))):
            self._fire(k)
        self._buffers.clear()
        self.function.on_finish(self._collector)

    def _operator_snapshot(self):
        return {"watermark": self._watermark, "buffers": snapshot_buffers(self._buffers)}

    def _operator_restore(self, state):
        self._watermark = state["watermark"]
        self._buffers = restore_buffers(state["buffers"])
        # A rescale restores the minimum of the old watermarks: a window
        # fired under a later one fires again when the watermark passes
        # its end (replayed records would otherwise join a fired window
        # and be purged unseen).
        for buf in self._buffers.values():
            if buf.fired and buf.window.end > self._watermark:
                buf.fired = False

    def _rescale_operator_state(self, states, mine):
        buffers = {}
        for s in states:
            if not s:
                continue
            for (key, start), payload in s["buffers"].items():
                if key == GLOBAL_KEY:
                    raise StateNotRescalable(
                        f"operator {self.name!r}: non-keyed time-window buffers are per-subtask")
                if mine(key):
                    buffers[(key, start)] = payload
        return {"watermark": _min_watermark(states), "buffers": buffers}


class SessionWindowOperator(_EventTimeWindowBase):
    """Event-time session windows with a fixed inactivity gap.

    A record at ``t`` opens or extends a session ``[t, t + gap)``;
    sessions that touch merge.  A session fires when the watermark passes
    its end, with its elements in timestamp order."""

    def __init__(self, name: str, function: fn.WindowFunction, gap_s: float,
                 key_selector=None, late_tag: typing.Optional[str] = None):
        super().__init__(name, function, key_selector, late_tag)
        if gap_s <= 0:
            raise ValueError(f"session gap must be positive, got {gap_s}")
        self.gap = float(gap_s)
        #: Per key, its open sessions (each window's end includes the gap).
        self._sessions: typing.Dict[typing.Any, typing.List[WindowBuffer]] = {}

    def process_record(self, record: el.StreamRecord) -> None:
        ts = _require_timestamp(self.name, "session window", record)
        self._note_event_ts(ts)
        key = self._key_of(record.value)
        sessions = self._sessions.setdefault(key, [])
        start, end = ts, ts + self.gap
        overlaps = any(s.window.start <= end and start <= s.window.end for s in sessions)
        if not overlaps and end <= self._watermark:
            # Late only if it can neither merge into an open session nor
            # stand alone.
            self._emit_late(record.value, ts)
            return
        merged = WindowBuffer(window=TimeWindow(start, end))
        merged.add(record.value, ts)
        keep = []
        for s in sessions:
            # Touching counts (Flink's inclusive intersects): records
            # exactly a gap apart chain into one session.
            if s.window.start <= merged.window.end and merged.window.start <= s.window.end:
                nxt = WindowBuffer(window=TimeWindow(min(s.window.start, merged.window.start),
                                                     max(s.window.end, merged.window.end)))
                nxt.elements = s.elements + merged.elements
                nxt.timestamps = s.timestamps + merged.timestamps
                nxt.first_element_time = min(s.first_element_time, merged.first_element_time)
                merged = nxt
            else:
                keep.append(s)
        keep.append(merged)
        self._sessions[key] = keep

    def _fire_sorted(self, due) -> None:
        for key, s in sorted(due, key=lambda ks: (ks[1].window.end, str(ks[0]))):
            order = sorted(range(len(s.elements)), key=lambda i: s.timestamps[i])
            self._call(key, s.window, [s.elements[i] for i in order])

    def process_watermark(self, watermark: el.Watermark) -> None:
        self._advance(watermark)
        due = []
        for key, sessions in self._sessions.items():
            due.extend((key, s) for s in sessions if s.window.end <= self._watermark)
            # Remove by identity: element lists of arrays do not compare.
            self._sessions[key] = [s for s in sessions if s.window.end > self._watermark]
        self._sessions = {k: v for k, v in self._sessions.items() if v}
        self._fire_sorted(due)
        self._forward(watermark)

    def finish(self) -> None:
        self._fire_sorted([(key, s) for key, sessions in self._sessions.items()
                           for s in sessions])
        self._sessions.clear()
        self.function.on_finish(self._collector)

    def _operator_snapshot(self):
        return {"watermark": self._watermark,
                "sessions": {key: [(s.window, list(s.elements), list(s.timestamps))
                                   for s in sessions]
                             for key, sessions in self._sessions.items()}}

    def _operator_restore(self, state):
        self._watermark = state["watermark"]
        self._sessions = {}
        for key, sessions in state["sessions"].items():
            out = []
            for window, elements, timestamps in sessions:
                s = WindowBuffer(window=window)
                s.elements, s.timestamps = list(elements), list(timestamps)
                out.append(s)
            self._sessions[key] = out

    def _rescale_operator_state(self, states, mine):
        sessions: typing.Dict[typing.Any, list] = {}
        for s in states:
            if not s:
                continue
            for key, payload in s["sessions"].items():
                if key == GLOBAL_KEY:
                    raise StateNotRescalable(
                        f"operator {self.name!r}: non-keyed sessions are per-subtask")
                if mine(key):
                    sessions.setdefault(key, []).extend(payload)
        return {"watermark": _min_watermark(states), "sessions": sessions}
