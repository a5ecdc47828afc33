"""Two-input joins over event time: the window join and the interval join.

Port of ``flink_tensorflow_tpu/core/joins.py``: a **window join**
(:class:`WindowJoinOperator`, ``:37``) pairs every left and right element
that share a key and a tumbling event-time window, once the watermark
passes the window's end; an **interval join**
(:class:`IntervalJoinOperator`, ``:153``) pairs each left element with
the right elements whose timestamp lies in ``[l.ts + lower, l.ts +
upper]``, at arrival.  Both run on the runtime's indexed dispatch
(``process_record_from``), with keyed buffers that snapshot, restore and
rescale by key group.
"""

from __future__ import annotations

import math
import typing

from flink_tensorflow_tpu_torch.core import elements as el
from flink_tensorflow_tpu_torch.core import functions as fn
from flink_tensorflow_tpu_torch.core.event_time import _min_watermark, _require_timestamp
from flink_tensorflow_tpu_torch.core.operators import _TwoInputOperator


class _LambdaJoin(fn.JoinFunction):
    def __init__(self, f):
        self.f = f

    def join(self, left, right):
        return self.f(left, right)


def as_join_function(f) -> fn.JoinFunction:
    return f if isinstance(f, fn.JoinFunction) else _LambdaJoin(f)


class WindowJoinOperator(_TwoInputOperator):
    """Tumbling event-time window join: for each (key, window), emits
    ``join(l, r)`` for every left x right pair once the watermark passes
    the window's end, stamped with that end."""

    def __init__(self, name: str, function: fn.JoinFunction, size_s: float,
                 key_selector1, key_selector2):
        super().__init__(name, function)
        if size_s <= 0:
            raise ValueError(f"window size must be positive, got {size_s}")
        self.size = float(size_s)
        #: Assignment, firing, the late check and the stamp all derive
        #: from integer nanoseconds.
        self._size_ns = round(self.size * 1e9)
        self.key_selectors = (key_selector1, key_selector2)
        #: ``{(key, start): (end, left elements, right elements)}``: the end
        #: computed at assignment is the one every later check uses.
        self._buffers: typing.Dict[typing.Tuple[typing.Any, float],
                                   typing.Tuple[float, list, list]] = {}
        self._watermark = -math.inf

    def process_record_from(self, input_index, record: el.StreamRecord) -> None:
        ts = _require_timestamp(self.name, "window join", record)
        start_ns = (round(ts * 1e9) // self._size_ns) * self._size_ns
        start, end = start_ns / 1e9, (start_ns + self._size_ns) / 1e9
        if end <= self._watermark:
            return  # late: its window already fired
        key = self.key_selectors[input_index](record.value)
        buf = self._buffers.get((key, start))
        if buf is None:
            buf = self._buffers[(key, start)] = (end, [], [])
        buf[1 + input_index].append(record.value)

    def process_watermark(self, watermark: el.Watermark) -> None:
        self._watermark = max(self._watermark, watermark.timestamp)
        due = sorted((k for k, buf in self._buffers.items() if buf[0] <= self._watermark),
                     key=lambda k: (k[1], str(k[0])))
        for k in due:
            self._fire(k)
        self.output.broadcast_element(watermark)

    def _fire(self, k) -> None:
        end, left, right = self._buffers.pop(k)
        self.keyed_state.current_key = k[0]
        for lv in left:
            for rv in right:
                self.output.emit(self.function.join(lv, rv), end)

    def finish(self) -> None:
        for k in sorted(self._buffers, key=lambda k: (k[1], str(k[0]))):
            self._fire(k)

    def _operator_snapshot(self):
        return {"watermark": self._watermark,
                "buffers": {k: (end, list(lv), list(rv))
                            for k, (end, lv, rv) in self._buffers.items()}}

    def _operator_restore(self, state):
        self._watermark = state["watermark"]
        self._buffers = {tuple(k): (end, list(lv), list(rv))
                         for k, (end, lv, rv) in state["buffers"].items()}

    def _rescale_operator_state(self, states, mine):
        buffers = {}
        for s in states:
            if s:
                buffers.update({k: buf for k, buf in s["buffers"].items() if mine(k[0])})
        return {"watermark": _min_watermark(states), "buffers": buffers}


class IntervalJoinOperator(_TwoInputOperator):
    """Event-time interval join (Flink's ``intervalJoin``): emits
    ``join(l, r)`` whenever ``l.ts + lower <= r.ts <= l.ts + upper``,
    stamped ``max(l.ts, r.ts)``.  Each side buffers per key, an arrival
    probes the other side at once, and the watermark evicts what no
    future arrival can match."""

    def __init__(self, name: str, function: fn.JoinFunction, lower_s: float, upper_s: float,
                 key_selector1, key_selector2):
        super().__init__(name, function)
        if lower_s > upper_s:
            raise ValueError(f"interval lower {lower_s} > upper {upper_s}")
        self.lower = float(lower_s)
        self.upper = float(upper_s)
        # Retention slack: equal to (lower, upper) for an interval that
        # holds zero, clamped to 0 for one that excludes it (Flink's
        # bound: a left lives until wm > lts + upper, a right until
        # wm > rts - lower).  With lower > 0, an on-time right at
        # rts >= wm still pairs a left as old as rts - upper.
        self._lo_slack = min(self.lower, 0.0)
        self._hi_slack = max(self.upper, 0.0)
        self.key_selectors = (key_selector1, key_selector2)
        #: Per key: ([(ts, left value)], [(ts, right value)]).
        self._state: typing.Dict[typing.Any, typing.Tuple[list, list]] = {}
        self._watermark = -math.inf

    def process_record_from(self, input_index, record: el.StreamRecord) -> None:
        ts = _require_timestamp(self.name, "interval join", record)
        # An arrival is dead only when nothing retained or still to come
        # on the other side can pair with it (the retention bound).
        if input_index == 0:
            dead = ts + self.upper < self._watermark + self._lo_slack
        else:
            dead = ts - self.lower < self._watermark - self._hi_slack
        if dead:
            return
        key = self.key_selectors[input_index](record.value)
        sides = self._state.get(key)
        if sides is None:
            sides = self._state[key] = ([], [])
        sides[input_index].append((ts, record.value))
        self.keyed_state.current_key = key
        if input_index == 0:
            for rts, rv in sides[1]:
                if ts + self.lower <= rts <= ts + self.upper:
                    self.output.emit(self.function.join(record.value, rv), max(ts, rts))
        else:
            for lts, lv in sides[0]:
                if lts + self.lower <= ts <= lts + self.upper:
                    self.output.emit(self.function.join(lv, record.value), max(ts, lts))

    def process_watermark(self, watermark: el.Watermark) -> None:
        self._watermark = max(self._watermark, watermark.timestamp)
        wm = self._watermark
        for key, (left, right) in list(self._state.items()):
            # Keep what an admissible arrival could still pair with: a
            # left while lts + upper >= wm + lo_slack, a right while
            # rts - lower >= wm - hi_slack.
            left[:] = [(ts, v) for ts, v in left if ts + self.upper >= wm + self._lo_slack]
            right[:] = [(ts, v) for ts, v in right if ts - self.lower >= wm - self._hi_slack]
            if not left and not right:
                del self._state[key]
        # Held back by the interval's span: a retained left can still
        # emit a pair stamped as old as wm - (upper - lower).
        self.output.broadcast_element(el.Watermark(wm - (self.upper - self.lower)))

    def _operator_snapshot(self):
        return {"watermark": self._watermark,
                "state": {k: (list(lv), list(rv)) for k, (lv, rv) in self._state.items()}}

    def _operator_restore(self, state):
        self._watermark = state["watermark"]
        self._state = {k: (list(lv), list(rv)) for k, (lv, rv) in state["state"].items()}

    def _rescale_operator_state(self, states, mine):
        merged: typing.Dict[typing.Any, typing.Tuple[list, list]] = {}
        for s in states:
            if not s:
                continue
            for key, (lv, rv) in s["state"].items():
                if mine(key):
                    dst = merged.setdefault(key, ([], []))
                    dst[0].extend(lv)
                    dst[1].extend(rv)
        return {"watermark": _min_watermark(states), "state": merged}
