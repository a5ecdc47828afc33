"""The loop that drives one keyed worker subtask.

Port of the part of ``flink_tensorflow_tpu/core/runtime.py`` that runs
one operator: ``setup`` (``:1170``) -> optional ``restore`` -> ``open``
-> records interleaved with ``fire_due`` whenever ``next_deadline()`` is
due (the worker loop, ``:462-471``) -> ``finish`` (``:400``) ->
``close``.  These are the calls the JAX runtime makes on an operator, so
an operator driven here behaves as it does inside a job.  Channels,
chaining and the checkpoint coordinator come with the runtime slice;
here the subtask's output is collected in a list, and a snapshot is
taken by calling :meth:`KeyedSubtask.snapshot` between records.
"""

from __future__ import annotations

import time
import typing

from flink_tensorflow_tpu_torch.core import elements as el
from flink_tensorflow_tpu_torch.core.operators import Operator, Output
from flink_tensorflow_tpu_torch.core.runtime_context import RuntimeContext
from flink_tensorflow_tpu_torch.core.state import KeyedStateStore


class _Forward:
    """Partitioner of a single downstream writer."""

    @staticmethod
    def select(value, n: int) -> typing.Tuple[int, ...]:
        return (0,)


class _ListWriter:
    def __init__(self) -> None:
        self.elements: typing.List[el.StreamElement] = []

    def write(self, element: el.StreamElement) -> None:
        self.elements.append(element)


class KeyedSubtask:
    """One worker subtask running ``operator`` over records fed to it.

    ``emitted`` lists the values the operator emitted, in order."""

    def __init__(self, operator: Operator):
        self.operator = operator
        self.ctx = RuntimeContext(operator.name)
        self.keyed_state = KeyedStateStore()
        self._sink = _ListWriter()
        operator.setup(self.ctx, Output([(_Forward, [self._sink])]), self.keyed_state)

    @property
    def emitted(self) -> typing.List[typing.Any]:
        return [e.value for e in self._sink.elements if isinstance(e, el.StreamRecord)]

    def open(self, restore: typing.Optional[typing.Dict[str, typing.Any]] = None) -> None:
        if restore is not None:
            self.operator.restore(restore)
        self.operator.open()

    def fire_due(self) -> bool:
        """Fire the operator's timers if its deadline has passed."""
        deadline = self.operator.next_deadline()
        now = time.monotonic()
        if deadline is not None and now >= deadline:
            self.operator.fire_due(now)
            return True
        return False

    def process(self, value: typing.Any, timestamp: typing.Optional[float] = None) -> None:
        """One arrival, then one turn of the timers (the worker loop
        alternates gate polls with due timers)."""
        self.operator.process_record(el.StreamRecord(value, timestamp))
        self.fire_due()

    def snapshot(self, checkpoint_id: typing.Optional[int] = None) -> typing.Dict[str, typing.Any]:
        return self.operator.snapshot(checkpoint_id)

    def finish(self) -> None:
        self.operator.finish()
        self.operator.output.broadcast_element(el.EndOfPartition())

    def close(self) -> None:
        self.operator.close()

    def run(self, values: typing.Iterable[typing.Any], *,
            restore: typing.Optional[typing.Dict[str, typing.Any]] = None) -> typing.List[typing.Any]:
        """open -> every value -> finish -> close; returns ``emitted``."""
        self.open(restore)
        try:
            for value in values:
                self.process(value)
            self.finish()
        finally:
            self.close()
        return self.emitted
