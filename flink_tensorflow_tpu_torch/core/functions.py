"""User-function interfaces for the streaming layer.

Copy of ``flink_tensorflow_tpu/core/functions.py`` (``Function`` ...
``FlatMapFunction`` ``:66``, ``AsyncMapFunction`` ``:71``,
``ProcessFunction`` ``:123``, ``WindowFunction`` ``:154``, the two-input
``CoMapFunction`` / ``CoFlatMapFunction`` / ``CoProcessFunction``
``:175-212``, ``JoinFunction`` ``:213``, ``SourceFunction`` ``:220``,
``SinkFunction`` ``:227``, ``ReduceFunction`` ``:240``).  ``open()`` is
where a model function builds its runner and moves its weights to the
device; ``close()`` releases them.
"""

from __future__ import annotations

import abc
import typing

if typing.TYPE_CHECKING:
    from flink_tensorflow_tpu_torch.core.runtime_context import RuntimeContext


class Function:
    """Base of all user functions (marker)."""

    def clone(self) -> "Function":
        """Per-subtask copy (each subtask gets its own).  Default is a
        deepcopy; override to share on purpose (collecting sinks) or to
        skip members that ``open()`` builds anyway."""
        import copy

        return copy.deepcopy(self)


class RichFunction(Function):
    """Function with a managed lifecycle and access to runtime context."""

    def open(self, ctx: "RuntimeContext") -> None:  # noqa: B027
        """Called once per subtask before any element is processed."""

    def close(self) -> None:  # noqa: B027
        """Called once per subtask after the last element (or on cancel)."""

    def snapshot_state(self) -> typing.Any:  # noqa: B027
        """Return a picklable snapshot of function state (or None)."""
        return None

    def restore_state(self, state: typing.Any) -> None:  # noqa: B027
        """Restore from a snapshot produced by :meth:`snapshot_state`."""


class MapFunction(RichFunction, abc.ABC):
    @abc.abstractmethod
    def map(self, value: typing.Any) -> typing.Any: ...


class FlatMapFunction(RichFunction, abc.ABC):
    @abc.abstractmethod
    def flat_map(self, value: typing.Any) -> typing.Iterable[typing.Any]: ...


class AsyncMapFunction(RichFunction, abc.ABC):
    """One-in/one-out map whose results may be emitted later.

    ``stream.map(f)`` hosts it like a :class:`MapFunction`, but hands
    ``map_async`` a collector instead of taking a return value, so the
    function may buffer the record (into an in-flight device batch) and
    emit its result on a later call.  The contract the operator relies on:

    - **FIFO**: results are collected in arrival order (result i is for
      record i); the operator re-attaches record timestamps by position;
    - ``flush(out)`` emits everything buffered or in flight; it is called
      at end of input and before every state snapshot, so no result is in
      limbo across a barrier;
    - ``next_deadline`` / ``fire_due`` bound a record's wait in a lull
      (the idle flush), as the window-function hooks do.
    """

    @abc.abstractmethod
    def map_async(self, value: typing.Any, out: "Collector") -> None: ...

    def flush(self, out: "Collector") -> None:  # noqa: B027
        """Emit every buffered and in-flight result now."""

    def next_deadline(self) -> typing.Optional[float]:
        return None

    def fire_due(self, now: float) -> None:  # noqa: B027
        pass


class FilterFunction(RichFunction, abc.ABC):
    @abc.abstractmethod
    def filter(self, value: typing.Any) -> bool: ...


class Collector:
    """Downstream emitter handed to process-style functions."""

    __slots__ = ("_emit",)

    def __init__(self, emit: typing.Callable[[typing.Any, typing.Optional[float]], None]):
        self._emit = emit

    def collect(self, value: typing.Any, timestamp: typing.Optional[float] = None) -> None:
        self._emit(value, timestamp)


class ProcessFunction(RichFunction, abc.ABC):
    """Low-level per-record function with a collector (non-keyed or keyed)."""

    @abc.abstractmethod
    def process_element(self, value: typing.Any, ctx: "ProcessContext", out: Collector) -> None: ...

    def on_timer(self, timestamp: float, ctx: "ProcessContext", out: Collector) -> None:  # noqa: B027
        """Called when a registered processing-time timer fires."""

    def on_finish(self, out: Collector) -> None:  # noqa: B027
        """End of input: flush buffered work (e.g. partial mini-batches)."""


class ProcessContext:
    """Per-element context: timestamp, current key, timers, keyed state."""

    __slots__ = ("timestamp", "current_key", "_runtime")

    def __init__(self, runtime):
        self.timestamp: typing.Optional[float] = None
        self.current_key: typing.Any = None
        self._runtime = runtime

    def state(self, descriptor):
        """Keyed state access (scoped to :attr:`current_key`)."""
        return self._runtime.get_value_state(descriptor)

    def register_timer(self, timestamp: float) -> None:
        self._runtime.register_timer(self.current_key, timestamp)


class WindowFunction(RichFunction, abc.ABC):
    """Invoked with the full contents of a fired window (the micro-batch
    hook a model function occupies)."""

    @abc.abstractmethod
    def process_window(
        self,
        key: typing.Any,
        window: typing.Any,
        elements: typing.Sequence[typing.Any],
        out: Collector,
    ) -> None: ...

    def on_finish(self, out: Collector) -> None:  # noqa: B027
        """End of input, after all remaining windows fired: flush any
        asynchronously in-flight work (pipelined model batches)."""

    def flush_in_flight(self) -> None:  # noqa: B027
        """Emit every result still in flight, each to the collector of the
        window that produced it.  A window operator calls it before it
        forwards a watermark, so no result trails the watermark that
        closed its window."""


class CoMapFunction(RichFunction, abc.ABC):
    """Two-input map (``s1.connect(s2).map(f)``): one method per input,
    one function state."""

    @abc.abstractmethod
    def map1(self, value: typing.Any) -> typing.Any: ...

    @abc.abstractmethod
    def map2(self, value: typing.Any) -> typing.Any: ...


class CoFlatMapFunction(RichFunction, abc.ABC):
    @abc.abstractmethod
    def flat_map1(self, value: typing.Any) -> typing.Iterable[typing.Any]: ...

    @abc.abstractmethod
    def flat_map2(self, value: typing.Any) -> typing.Iterable[typing.Any]: ...


class CoProcessFunction(RichFunction, abc.ABC):
    """Two-input process function; keyed state and timers are shared
    across both inputs."""

    @abc.abstractmethod
    def process_element1(self, value, ctx: "ProcessContext", out: Collector) -> None: ...

    @abc.abstractmethod
    def process_element2(self, value, ctx: "ProcessContext", out: Collector) -> None: ...

    def on_timer(self, timestamp: float, ctx: "ProcessContext", out: Collector) -> None:  # noqa: B027
        pass

    def on_finish(self, out: Collector) -> None:  # noqa: B027
        pass


class JoinFunction(RichFunction, abc.ABC):
    """Combines one left and one right element of a matched pair."""

    @abc.abstractmethod
    def join(self, left: typing.Any, right: typing.Any) -> typing.Any: ...


class ReduceFunction(RichFunction, abc.ABC):
    @abc.abstractmethod
    def reduce(self, acc: typing.Any, value: typing.Any) -> typing.Any: ...


class SourceFunction(RichFunction, abc.ABC):
    """Pull-based source: yields values."""

    @abc.abstractmethod
    def run(self) -> typing.Iterator[typing.Any]: ...


class SinkFunction(RichFunction, abc.ABC):
    @abc.abstractmethod
    def invoke(self, value: typing.Any) -> None: ...
