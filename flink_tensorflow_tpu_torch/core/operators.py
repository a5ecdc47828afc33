"""Runtime operators — ``Output`` and the ``Operator`` base.

Port of ``flink_tensorflow_tpu/core/operators.py:48-271`` (the part the
serving operator needs; the other operators wait for the runtime slice).
Operators are host-side control code: each instance runs on one subtask
thread, processes stream elements and takes part in snapshots.
"""

from __future__ import annotations

import typing

from flink_tensorflow_tpu_torch.core import elements as el
from flink_tensorflow_tpu_torch.core.state import KeyedStateStore

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
