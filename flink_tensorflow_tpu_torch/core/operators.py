"""Runtime operators — ``Output``, the ``Operator`` base, and the
operators the Quick-start job runs.

Port of ``flink_tensorflow_tpu/core/operators.py``: ``Output`` and
``Operator`` (``:48-271``), ``_FunctionOperator`` (``:274``),
``MapOperator`` (``:319``, synchronous maps), ``FilterOperator``,
``WindowOperator`` (``:587``, with the ``ingest_element`` /
``next_deadline`` / ``fire_due`` hooks a model function uses),
``SinkOperator`` (``:772``) and ``SourceOperator`` (``:787``).
Operators are host-side control code: each instance runs on one subtask
thread, processes stream elements and takes part in snapshots.
"""

from __future__ import annotations

import typing

from flink_tensorflow_tpu_torch.core import elements as el
from flink_tensorflow_tpu_torch.core import functions as fn
from flink_tensorflow_tpu_torch.core.state import KeyedStateStore
from flink_tensorflow_tpu_torch.core.windows import CountWindow, Trigger, WindowBuffer

if typing.TYPE_CHECKING:
    from flink_tensorflow_tpu_torch.core.runtime_context import RuntimeContext


class Output:
    """Downstream emitter for one subtask.

    ``edges`` is a list of ``(partitioner, writers)``: the partitioner's
    ``select(value, n)`` names the writer indices, and each writer's
    ``write(element)`` takes the element."""

    def __init__(self, edges):
        self._edges = edges

    def emit(self, value: typing.Any, timestamp: typing.Optional[float] = None) -> None:
        record = el.StreamRecord(value, timestamp)
        for partitioner, writers in self._edges:
            for idx in partitioner.select(value, len(writers)):
                writers[idx].write(record)

    def broadcast_element(self, element: el.StreamElement) -> None:
        """Control elements (end of partition) go to every downstream channel."""
        for _, writers in self._edges:
            for w in writers:
                w.write(element)


class Operator:
    """Base runtime operator."""

    def __init__(self, name: str):
        self.name = name
        self.ctx: typing.Optional["RuntimeContext"] = None
        self.output: typing.Optional[Output] = None
        self.keyed_state: typing.Optional[KeyedStateStore] = None

    # -- lifecycle -----------------------------------------------------
    def setup(self, ctx: "RuntimeContext", output: Output,
              keyed_state: KeyedStateStore) -> None:
        self.ctx = ctx
        self.output = output
        self.keyed_state = keyed_state

    def open(self) -> None:  # noqa: B027
        pass

    def close(self) -> None:  # noqa: B027
        pass

    # -- element processing -------------------------------------------
    def process_record(self, record: el.StreamRecord) -> None:
        raise NotImplementedError

    def finish(self) -> None:  # noqa: B027
        """End of input: flush any buffered elements."""

    # -- timers --------------------------------------------------------
    def next_deadline(self) -> typing.Optional[float]:
        """Earliest monotonic time this operator must be poked, or None."""
        return None

    def fire_due(self, now: float) -> None:  # noqa: B027
        """Called by the subtask loop when ``next_deadline`` has passed."""

    # -- snapshot protocol ----------------------------------------------
    def snapshot(self, checkpoint_id: typing.Optional[int] = None) -> typing.Dict[str, typing.Any]:
        """The function hook runs FIRST: it may flush work into keyed
        state, which must be captured after it."""
        function = self._function_snapshot(checkpoint_id)
        return {
            "keyed": self.keyed_state.snapshot(),
            "function": function,
            "operator": self._operator_snapshot(),
        }

    def restore(self, snap: typing.Dict[str, typing.Any]) -> None:
        self.keyed_state.restore(snap["keyed"])
        self._function_restore(snap["function"])
        self._operator_restore(snap["operator"])

    def _function_snapshot(self, checkpoint_id: typing.Optional[int] = None) -> typing.Any:
        return None

    def _function_restore(self, state: typing.Any) -> None:
        pass

    def _operator_snapshot(self) -> typing.Any:
        return None

    def _operator_restore(self, state: typing.Any) -> None:
        pass


class _FunctionOperator(Operator):
    """Operator wrapping one rich user function (a per-subtask clone)."""

    def __init__(self, name: str, function: fn.Function):
        super().__init__(name)
        self.function = function.clone()

    def open(self) -> None:
        if isinstance(self.function, fn.RichFunction):
            self.function.open(self.ctx)

    def close(self) -> None:
        if isinstance(self.function, fn.RichFunction):
            self.function.close()

    def _function_snapshot(self, checkpoint_id=None):
        if isinstance(self.function, fn.RichFunction):
            return self.function.snapshot_state()
        return None

    def _function_restore(self, state):
        if state is not None and isinstance(self.function, fn.RichFunction):
            self.function.restore_state(state)


class MapOperator(_FunctionOperator):
    """Hosts a MapFunction (one result per record)."""

    def process_record(self, record):
        self.output.emit(self.function.map(record.value), record.timestamp)


class FilterOperator(_FunctionOperator):
    def process_record(self, record):
        if self.function.filter(record.value):
            self.output.emit(record.value, record.timestamp)


class WindowOperator(_FunctionOperator):
    """Count / count-or-timeout windows per subtask.

    This operator IS the micro-batcher: a fired window hands its elements
    to a WindowFunction in one call — one batched device call."""

    def __init__(self, name, function: fn.WindowFunction, trigger: Trigger):
        super().__init__(name, function)
        self.trigger = trigger
        self._buffer: typing.Optional[WindowBuffer] = None
        self._seq = 0
        self._collector: typing.Optional[fn.Collector] = None

    def open(self) -> None:
        self._collector = fn.Collector(self.output.emit)
        super().open()

    def process_record(self, record):
        if self._buffer is None:
            self._buffer = WindowBuffer(window=CountWindow(self._seq))
        value = record.value
        # Ingestion hook: a tensor window function may take the payload at
        # arrival and buffer a token instead (None keeps the value).
        ingest = getattr(self.function, "ingest_element", None)
        if ingest is not None:
            token = ingest(value, self._collector)
            if token is not None:
                value = token
        self._buffer.add(value, record.timestamp)
        if self.trigger.on_element(self._buffer):
            self._fire()

    def _fire(self) -> None:
        buf, self._buffer = self._buffer, None
        self._seq += 1
        self.function.process_window(None, buf.window, buf.elements, self._collector)

    def next_deadline(self):
        deadlines = []
        if self._buffer is not None:
            d = self.trigger.deadline(self._buffer)
            if d is not None:
                deadlines.append(d)
        # Functions with async in-flight work (pipelined model batches)
        # declare their own wake-up so results never strand in a lull.
        fn_deadline = getattr(self.function, "next_deadline", None)
        if fn_deadline is not None and (d := fn_deadline()) is not None:
            deadlines.append(d)
        return min(deadlines) if deadlines else None

    def fire_due(self, now):
        if self._buffer is not None:
            d = self.trigger.deadline(self._buffer)
            if d is not None and d <= now:
                self._fire()
        fn_fire = getattr(self.function, "fire_due", None)
        if fn_fire is not None:
            fn_fire(now)

    def finish(self):
        if self._buffer is not None and self._buffer.elements:
            self._fire()
        self._buffer = None
        self.function.on_finish(self._collector)


class SinkOperator(_FunctionOperator):
    def process_record(self, record):
        self.function.invoke(record.value)


class SourceOperator(_FunctionOperator):
    """Source: the subtask loop iterates its function (no offsets are
    tracked until checkpoints are ported)."""

    def iterate(self) -> typing.Iterator[typing.Any]:
        return self.function.run()

    def process_record(self, record):  # pragma: no cover - sources have no input
        raise RuntimeError("SourceOperator has no input")
