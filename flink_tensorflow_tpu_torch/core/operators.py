"""Runtime operators — ``Output``, the ``Operator`` base, and the
one- and two-input operators of the DataStream surface.

Port of ``flink_tensorflow_tpu/core/operators.py``: ``Output`` and
``Operator`` (``:48-271``, with the snapshot, checkpoint-notification and
key-group rescale protocol, ``process_record_from`` ``:142`` for
operators with several inputs and ``process_watermark`` ``:148``),
``StateNotRescalable`` (``:110``), ``_FunctionOperator`` (``:274``),
``MapOperator`` (``:319``, synchronous maps and the async branch an
``AsyncMapFunction`` needs, which flushes its in-flight micro-batches
before it forwards a watermark, ``:367-377``), ``FlatMapOperator``
(``:405``), ``FilterOperator``, ``ProcessOperator`` (``:417``, keyed state
and timers), ``CoMapOperator`` / ``CoFlatMapOperator`` /
``CoProcessOperator`` (``:486-585``), ``WindowOperator`` (``:587``, count,
count-or-timeout and sliding count windows per key or per subtask, with
the ``next_deadline`` / ``fire_due`` hooks a model function uses),
``SinkOperator`` (``:772``, where watermarks end and a transactional
sink commits its tail at end of input) and ``SourceOperator`` (``:787``,
a replayable offset).  Operators are host-side control code: each
instance runs on one subtask thread, processes stream elements and takes
part in snapshots.  ``Output`` is a host boundary (``:68``): a
``DeviceBatch`` emitted into a channel materializes there, once, and
leaves as per-record host values.  ``uses_timers`` marks the operators
the chaining pass keeps out of source chains: async maps, process
functions, and windows whose trigger or function declares deadlines.

Where the reference's ``WindowOperator`` forwards a watermark while its
model function still has batches in flight (it inherits the base
``process_watermark``), the port's flushes them first, as the async map
does, so no result trails a watermark.
"""

from __future__ import annotations

import collections
import time
import typing

from flink_tensorflow_tpu_torch.core import elements as el
from flink_tensorflow_tpu_torch.core import functions as fn
from flink_tensorflow_tpu_torch.core.state import KeyedStateStore
from flink_tensorflow_tpu_torch.core.windows import (
    CountWindow,
    Trigger,
    WindowBuffer,
    restore_buffers,
    snapshot_buffers,
)

if typing.TYPE_CHECKING:
    from flink_tensorflow_tpu_torch.core.runtime_context import RuntimeContext


class Output:
    """Downstream emitter for one subtask (the tail of its chain).

    ``edges`` is a list of ``(partitioner, writers)``: the partitioner's
    ``select(value, n)`` names the writer indices, and each writer's
    ``write(element)`` takes the element.  ``meter`` (optional) counts the
    records emitted."""

    def __init__(self, edges, meter=None):
        self._edges = edges
        self._meter = meter

    def emit(self, value: typing.Any, timestamp: typing.Optional[float] = None) -> None:
        if getattr(value, "is_device_batch", False):
            # A channel is a host boundary: keyed routing needs per-record
            # keys and a checkpoint needs host objects, so the batch's D2H
            # runs here, once, and its records leave one by one.
            ts = timestamp if timestamp is not None else value.timestamp
            for tv in value.materialize():
                self.emit(tv, ts)
            return
        if self._meter is not None:
            self._meter.mark()
        record = el.StreamRecord(value, timestamp)
        for partitioner, writers in self._edges:
            for idx in partitioner.select(value, len(writers)):
                writers[idx].write(record)

    def broadcast_element(self, element: el.StreamElement) -> None:
        """Control elements (watermarks, barriers, end of partition) go to
        every downstream channel."""
        for _, writers in self._edges:
            for w in writers:
                w.write(element)


class StateNotRescalable(RuntimeError):
    """Raised when a restore changes an operator's parallelism but its
    snapshot holds per-subtask state that cannot be redistributed by key
    (source offsets, non-keyed timers).  Keep that operator's parallelism
    fixed across restarts."""


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

    def process_record_from(self, input_index: int, record: el.StreamRecord) -> None:
        """A record with the index of the input edge it came through:
        operators with two inputs override it, the others ignore it."""
        self.process_record(record)

    def process_watermark(self, watermark: el.Watermark) -> None:
        self.output.broadcast_element(watermark)

    def finish(self) -> None:  # noqa: B027
        """End of input: flush any buffered elements."""

    # -- timers --------------------------------------------------------
    def next_deadline(self) -> typing.Optional[float]:
        """Earliest monotonic time this operator must be poked, or None."""
        return None

    def fire_due(self, now: float) -> None:  # noqa: B027
        """Called by the subtask loop when ``next_deadline`` has passed."""

    @property
    def uses_timers(self) -> bool:
        """Whether this operator may ever declare a wall-clock deadline
        (``next_deadline`` / ``fire_due``).  The chaining pass never fuses
        such an operator into a source chain: a source loop blocks in the
        user's iterator and cannot serve deadlines, while a worker chain
        waits until the chain's earliest one."""
        return False

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

    def notify_checkpoint_complete(self, checkpoint_id: int) -> None:  # noqa: B027
        """Checkpoint ``checkpoint_id`` is complete and durable (Flink's
        CheckpointListener).  Delivered on the subtask thread; one that
        completes as the job ends is delivered from the join thread after
        ``close()``."""

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

    # -- rescaling (restore with a different parallelism) -----------------
    def rescale(self, old: typing.Dict[int, typing.Any], index: int, parallelism: int,
                max_parallelism: int) -> typing.Dict[str, typing.Any]:
        """Build THIS subtask's snapshot from all old subtasks' snapshots.

        Keyed state redistributes by key group (the routing the
        HashPartitioner uses, so state lands where records will);
        function/operator state goes through the per-operator hooks, which
        raise :class:`StateNotRescalable` for per-subtask state."""
        from flink_tensorflow_tpu_torch.core.partitioning import subtask_for_key

        def mine(key) -> bool:
            return subtask_for_key(key, parallelism, max_parallelism) == index

        snaps = [s for s in old.values() if s is not None]
        keyed: typing.Dict[str, typing.Dict[typing.Any, typing.Any]] = {}
        for snap in snaps:
            for name, table in snap["keyed"].items():
                for key, value in table.items():
                    if mine(key):
                        keyed.setdefault(name, {})[key] = value
        return {
            "keyed": keyed,
            "function": self._rescale_function_state([s["function"] for s in snaps], mine),
            "operator": self._rescale_operator_state([s["operator"] for s in snaps], mine),
        }

    def _rescale_function_state(self, states: typing.List[typing.Any], mine) -> typing.Any:
        if any(s is not None for s in states):
            raise StateNotRescalable(
                f"operator {self.name!r}: function state is per-subtask and "
                "cannot be redistributed — restore with the original parallelism")
        return None

    def _rescale_operator_state(self, states: typing.List[typing.Any], mine) -> typing.Any:
        if any(s is not None for s in states):
            raise StateNotRescalable(
                f"operator {self.name!r}: operator state is per-subtask and "
                "cannot be redistributed — restore with the original parallelism")
        return None


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
            # A two-phase-commit sink binds what it staged to the id.
            hook = getattr(self.function, "snapshot_state_for_checkpoint", None)
            if hook is not None:
                return hook(checkpoint_id)
            return self.function.snapshot_state()
        return None

    def _function_restore(self, state):
        if state is not None and isinstance(self.function, fn.RichFunction):
            self.function.restore_state(state)

    def notify_checkpoint_complete(self, checkpoint_id: int) -> None:
        hook = getattr(self.function, "notify_checkpoint_complete", None)
        if hook is not None:
            hook(checkpoint_id)

    def _rescale_function_state(self, states, mine):
        if all(s is None for s in states):
            return None
        hook = getattr(self.function, "rescale_state", None)
        if hook is None:
            raise StateNotRescalable(
                f"operator {self.name!r}: {type(self.function).__name__} "
                "snapshots per-subtask state and defines no rescale_state "
                "hook — restore with the original parallelism")
        return hook(states, mine)


class MapOperator(_FunctionOperator):
    """Hosts a MapFunction, or an AsyncMapFunction whose results surface
    later.

    For an async function the operator keeps a FIFO of input timestamps
    and re-attaches them by position as results surface (the function's
    FIFO contract), flushes in-flight work at end of input and before
    every barrier (``_function_snapshot``), and forwards the idle-flush
    timer hooks."""

    def __init__(self, name, function):
        super().__init__(name, function)
        self._async = isinstance(self.function, fn.AsyncMapFunction)
        self._collector: typing.Optional[fn.Collector] = None
        self._ts_fifo: typing.Deque[typing.Optional[float]] = collections.deque()

    def open(self) -> None:
        if self._async:
            def emit(value, _ts):
                fifo = self._ts_fifo
                ts = fifo.popleft() if fifo else None
                if getattr(value, "is_device_batch", False):
                    # One emission answers num_records inputs: consume
                    # their timestamps and stamp the batch with the
                    # oldest (its records leave under it).
                    for _ in range(value.num_records - 1):
                        if fifo:
                            fifo.popleft()
                    value.timestamp = ts
                self.output.emit(value, ts)

            self._collector = fn.Collector(emit)
        super().open()

    def process_record(self, record):
        if self._async:
            value = record.value
            if getattr(value, "is_device_batch", False):
                # A device batch is num_records inputs: keep the FIFO of
                # timestamps one per record.
                self._ts_fifo.extend([record.timestamp] * value.num_records)
            else:
                self._ts_fifo.append(record.timestamp)
            self.function.map_async(value, self._collector)
        else:
            self.output.emit(self.function.map(record.value), record.timestamp)

    def process_watermark(self, watermark):
        # No result may trail the watermark: downstream event-time
        # operators would take it as late.  With watermark_every smaller
        # than the micro-batch upstream, this cuts the batches short.
        if self._async:
            self.function.flush(self._collector)
        super().process_watermark(watermark)

    def finish(self):
        if self._async:
            self.function.flush(self._collector)

    def _function_snapshot(self, checkpoint_id=None):
        # The barrier contract, held at the operator: everything in flight
        # is emitted before the snapshot, so the timestamp FIFO is empty
        # and no operator-side state is left to snapshot.
        if self._async:
            self.function.flush(self._collector)
        return super()._function_snapshot(checkpoint_id)

    def next_deadline(self):
        return self.function.next_deadline() if self._async else None

    def fire_due(self, now):
        if self._async:
            self.function.fire_due(now)

    @property
    def uses_timers(self):
        return self._async


class FlatMapOperator(_FunctionOperator):
    def process_record(self, record):
        for out in self.function.flat_map(record.value):
            self.output.emit(out, record.timestamp)


class FilterOperator(_FunctionOperator):
    def process_record(self, record):
        if self.function.filter(record.value):
            self.output.emit(record.value, record.timestamp)


class _TimerMixin:
    """Processing-time timers of the process-function operators, keyed by
    ``(key, timestamp)``; ``_key_selectors`` says whether they are keyed."""

    def register_timer(self, key, timestamp: float) -> None:
        self._timers[(key, timestamp)] = None

    def get_value_state(self, descriptor):
        return self.keyed_state.value_state(descriptor)

    @property
    def uses_timers(self):
        return True  # the ProcessContext may register a timer at any record

    def next_deadline(self):
        if not self._timers:
            return None
        return min(ts for (_, ts) in self._timers)

    def fire_due(self, now):
        due = [(k, ts) for (k, ts) in self._timers if ts <= now]
        for key, ts in sorted(due, key=lambda x: x[1]):
            del self._timers[(key, ts)]
            self.keyed_state.current_key = key
            self._pctx.current_key = key
            self._pctx.timestamp = ts
            self.function.on_timer(ts, self._pctx, self._collector)

    def _operator_snapshot(self):
        return {"timers": list(self._timers.keys())}

    def _operator_restore(self, state):
        self._timers = {tuple(t): None for t in state["timers"]}

    def _rescale_operator_state(self, states, mine):
        timers = []
        for s in states:
            if s:
                timers.extend(tuple(t) for t in s["timers"])
        if timers and not self._keyed:
            raise StateNotRescalable(
                f"operator {self.name!r}: non-keyed timers are per-subtask")
        return {"timers": [t for t in timers if mine(t[0])]}


class ProcessOperator(_TimerMixin, _FunctionOperator):
    """Hosts a ProcessFunction; keyed if ``key_selector`` is set."""

    def __init__(self, name, function, key_selector=None):
        super().__init__(name, function)
        self.key_selector = key_selector
        self._keyed = key_selector is not None
        self._collector: typing.Optional[fn.Collector] = None
        self._pctx: typing.Optional[fn.ProcessContext] = None
        self._timers: typing.Dict[typing.Tuple[typing.Any, float], None] = {}

    def open(self) -> None:
        self._collector = fn.Collector(self.output.emit)
        self._pctx = fn.ProcessContext(self)
        super().open()

    def process_record(self, record):
        if self.key_selector is not None:
            key = self.key_selector(record.value)
            self.keyed_state.current_key = key
            self._pctx.current_key = key
        self._pctx.timestamp = record.timestamp
        self.function.process_element(record.value, self._pctx, self._collector)

    def finish(self):
        self.function.on_finish(self._collector)


class _TwoInputOperator(_FunctionOperator):
    """An operator fed by two input edges through ``process_record_from``."""

    def process_record(self, record):
        raise RuntimeError(f"{self.name}: a two-input operator takes process_record_from")


class CoMapOperator(_TwoInputOperator):
    """Input 0 through ``map1``, input 1 through ``map2``."""

    def process_record_from(self, input_index, record):
        f = self.function.map1 if input_index == 0 else self.function.map2
        self.output.emit(f(record.value), record.timestamp)


class CoFlatMapOperator(_TwoInputOperator):
    def process_record_from(self, input_index, record):
        f = self.function.flat_map1 if input_index == 0 else self.function.flat_map2
        for out in f(record.value):
            self.output.emit(out, record.timestamp)


class CoProcessOperator(_TimerMixin, _TwoInputOperator):
    """Two-input process function; keyed when both key selectors are set
    (both inputs then hash into one key space and share keyed state)."""

    def __init__(self, name, function, key_selector1=None, key_selector2=None):
        super().__init__(name, function)
        if (key_selector1 is None) != (key_selector2 is None):
            raise ValueError("connect: key both inputs or neither")
        self.key_selectors = (key_selector1, key_selector2)
        self._keyed = key_selector1 is not None
        self._collector: typing.Optional[fn.Collector] = None
        self._pctx: typing.Optional[fn.ProcessContext] = None
        self._timers: typing.Dict[typing.Tuple[typing.Any, float], None] = {}

    def open(self) -> None:
        self._collector = fn.Collector(self.output.emit)
        self._pctx = fn.ProcessContext(self)
        super().open()

    def process_record_from(self, input_index, record):
        selector = self.key_selectors[input_index]
        if selector is not None:
            key = selector(record.value)
            self.keyed_state.current_key = key
            self._pctx.current_key = key
        self._pctx.timestamp = record.timestamp
        handler = (self.function.process_element1 if input_index == 0
                   else self.function.process_element2)
        handler(record.value, self._pctx, self._collector)

    def finish(self):
        self.function.on_finish(self._collector)


class WindowOperator(_FunctionOperator):
    """Count, count-or-timeout and sliding count windows, per key (with a
    ``key_selector``) or per subtask.

    This operator IS the micro-batcher: a fired window hands its elements
    to a WindowFunction in one call — one batched device call.  Its
    results carry no timestamp.  A watermark passes only after the
    function's in-flight batches were emitted.

    As the reference's (JAX ``:608-661``, ``:741``): each subtask clones
    the trigger; a trigger with ``observe_service_time`` is fed the
    function's ``service_time_estimate`` at every arrival and timer; a
    function with ``stamp_stages`` gets each record with its arrival time
    here in ``meta["__arrive_ts__"]`` (on a copy of the record); on a
    non-keyed, non-sliding window a function with ``ingest_element``
    takes each record's payload at arrival (into its ring) and the buffer
    keeps the token it returns; a snapshot first has the function's
    ``materialize_tokens`` turn tokens back into records."""

    GLOBAL_KEY = "__subtask__"

    def __init__(self, name, function: fn.WindowFunction, trigger: Trigger, key_selector=None):
        super().__init__(name, function)
        self.trigger = trigger.clone()
        self.key_selector = key_selector
        self._buffers: typing.Dict[typing.Any, WindowBuffer] = {}
        self._window_seq: typing.Dict[typing.Any, int] = {}
        self._collector: typing.Optional[fn.Collector] = None
        self._svc_feed = None
        self._arrival_stamp = False
        self._ingest = None

    def open(self) -> None:
        self._collector = fn.Collector(self.output.emit)
        super().open()
        observe = getattr(self.trigger, "observe_service_time", None)
        estimate = getattr(self.function, "service_time_estimate", None)
        self._svc_feed = ((estimate, observe)
                          if observe is not None and estimate is not None else None)
        self._arrival_stamp = bool(getattr(self.function, "stamp_stages", False))
        ingest = getattr(self.function, "ingest_element", None)
        # A token holds no payload: retained (sliding) elements must keep
        # theirs, and a keyed window's buffers are not one FIFO.
        if ingest is not None and self.key_selector is None and not self.trigger.retains():
            self._ingest = ingest

    def _feed_service_time(self) -> None:
        if self._svc_feed is not None:
            est = self._svc_feed[0]()
            if est is not None:
                self._svc_feed[1](est)

    def process_record(self, record):
        key = self.key_selector(record.value) if self.key_selector is not None else self.GLOBAL_KEY
        buf = self._buffers.get(key)
        if buf is None:
            buf = WindowBuffer(window=CountWindow(self._window_seq.get(key, 0)))
            self._buffers[key] = buf
        value = record.value
        if self._arrival_stamp and hasattr(value, "with_meta"):
            value = value.with_meta(__arrive_ts__=time.monotonic())
        if self._ingest is not None:
            token = self._ingest(value, self._collector)
            if token is not None:
                value = token
        buf.add(value, record.timestamp)
        self._feed_service_time()
        if self.trigger.on_element(buf):
            self._fire(key, buf)

    def _fire(self, key, buf: WindowBuffer) -> None:
        del self._buffers[key]
        seq = self._window_seq.get(key, 0) + 1
        self._window_seq[key] = seq
        if self.key_selector is not None:
            self.keyed_state.current_key = key
        self.function.process_window(
            key if self.key_selector is not None else None, buf.window,
            self.trigger.fire_elements(buf), self._collector)
        # A sliding window seeds the next buffer with the trailing overlap.
        keep = self.trigger.retain_count(buf)
        if keep:
            nxt = WindowBuffer(window=CountWindow(seq), retained=keep)
            nxt.elements = list(buf.elements[-keep:])
            nxt.timestamps = list(buf.timestamps[-keep:])
            nxt.first_element_time = time.monotonic()
            self._buffers[key] = nxt

    def process_watermark(self, watermark):
        self.function.flush_in_flight()
        super().process_watermark(watermark)

    @property
    def uses_timers(self):
        return (self.trigger.has_deadlines()
                or getattr(self.function, "next_deadline", None) is not None)

    def next_deadline(self):
        deadlines = [d for d in (self.trigger.deadline(b) for b in self._buffers.values())
                     if d is not None]
        # Functions with async in-flight work (pipelined model batches)
        # declare their own wake-up so results never strand in a lull.
        fn_deadline = getattr(self.function, "next_deadline", None)
        if fn_deadline is not None and (d := fn_deadline()) is not None:
            deadlines.append(d)
        return min(deadlines) if deadlines else None

    def fire_due(self, now):
        self._feed_service_time()
        due = [key for key, buf in self._buffers.items()
               if (d := self.trigger.deadline(buf)) is not None and d <= now]
        for key in due:
            self._fire(key, self._buffers[key])
        fn_fire = getattr(self.function, "fire_due", None)
        if fn_fire is not None:
            fn_fire(now)

    def finish(self):
        for key in list(self._buffers):
            buf = self._buffers[key]
            # A buffer of carried-over elements only (sliding retention)
            # emitted them all already: only new arrivals fire.
            if len(buf.elements) > buf.retained:
                self._fire(key, buf)
        self._buffers.clear()
        self.function.on_finish(self._collector)

    def _operator_snapshot(self):
        # Ring tokens hold no payload: the buffered records are copied out
        # of the arena first, so a checkpoint never holds a token (the run
        # goes on with the copies; new arrivals enter the ring again).
        materialize = getattr(self.function, "materialize_tokens", None)
        if materialize is not None:
            for buf in self._buffers.values():
                buf.elements = materialize(buf.elements)
        return {"buffers": snapshot_buffers(self._buffers), "seq": dict(self._window_seq)}

    def _operator_restore(self, state):
        self._buffers = restore_buffers(state["buffers"])
        self._window_seq = dict(state["seq"])

    def _rescale_operator_state(self, states, mine):
        buffers, seq = {}, {}
        for s in states:
            if not s:
                continue
            for key, payload in s["buffers"].items():
                if key == self.GLOBAL_KEY:
                    raise StateNotRescalable(
                        f"operator {self.name!r}: non-keyed window buffers are per-subtask "
                        "— restore with the original parallelism")
                if mine(key):
                    buffers[key] = payload
            for key, n in s["seq"].items():
                if key != self.GLOBAL_KEY and mine(key):
                    seq[key] = max(seq.get(key, 0), n)
        return {"buffers": buffers, "seq": seq}


class SinkOperator(_FunctionOperator):
    def process_record(self, record):
        self.function.invoke(record.value)

    def process_watermark(self, watermark):
        pass  # the stream ends here

    def finish(self):
        # A transactional sink commits its tail at a clean end of input;
        # close() alone commits nothing (it also runs on cancel).
        hook = getattr(self.function, "finish", None)
        if hook is not None:
            hook()


class SourceOperator(_FunctionOperator):
    """Replayable source: tracks an offset, skips on restore (Flink's
    source-with-offset contract that makes aligned snapshots exactly-once
    end to end)."""

    def __init__(self, name, function: fn.SourceFunction):
        super().__init__(name, function)
        self.offset = 0
        self._restored_offset = 0

    def iterate(self) -> typing.Iterator[typing.Any]:
        """Yields values; the caller calls :meth:`record_emitted` after each
        downstream emit, so a barrier between yield and emit never counts
        the in-flight record as emitted."""
        # Replay: skip the records emitted before the restored snapshot.
        # A source that can reposition (``PacedSource``, which must not
        # sleep through the skipped records' schedule) has ``seek``; any
        # other is replayed by consuming its iterator (JAX ``:804-823``).
        if self._restored_offset and hasattr(self.function, "seek"):
            self.function.seek(self._restored_offset)
            it = self.function.run()
        else:
            it = self.function.run()
            skipped = 0
            while skipped < self._restored_offset:
                v = next(it, _END)
                if v is _END:
                    break
                if isinstance(v, el.SourceIdle):
                    continue  # a heartbeat, not a record
                skipped += 1
        self.offset = self._restored_offset
        yield from it

    def record_emitted(self) -> None:
        self.offset += 1

    def process_record(self, record):  # pragma: no cover - sources have no input
        raise RuntimeError("SourceOperator has no input")

    def _operator_snapshot(self):
        return {"offset": self.offset}

    def _operator_restore(self, state):
        self._restored_offset = state["offset"]

    def rescale(self, old, index, parallelism, max_parallelism):
        raise StateNotRescalable(
            f"source {self.name!r}: offsets are bound to the source's record "
            "partitioning (subtask i emits every P-th record) — changing "
            "source parallelism invalidates them; keep source parallelism "
            "fixed and rescale the keyed operators downstream")


_END = object()
