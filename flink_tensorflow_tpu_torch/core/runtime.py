"""Subtask loops and the local executor.

Port of ``flink_tensorflow_tpu/core/runtime.py``:

- :class:`KeyedSubtask` drives one operator in the calling thread:
  ``setup`` -> optional ``restore`` -> ``open`` -> records interleaved
  with ``fire_due`` whenever ``next_deadline()`` is due -> ``finish`` ->
  ``close``, with the output collected in a list and snapshots taken by
  :meth:`KeyedSubtask.snapshot` between records (the serving phase).
- :class:`LocalExecutor` (``:692``) runs a whole dataflow graph: one
  thread per operator subtask (:class:`_Subtask`, ``:166``), one input
  gate per non-source subtask, outputs routed by each edge's
  partitioner.  This is the reference's ``JobConfig(chaining=False)``
  layout, with the same outputs as the chained one.  There is no
  checkpoint coordinator and no device-resident handoff yet.
"""

from __future__ import annotations

import copy
import logging
import threading
import time
import typing

from flink_tensorflow_tpu_torch.core import elements as el
from flink_tensorflow_tpu_torch.core.channels import ChannelWriter, InputGate
from flink_tensorflow_tpu_torch.core.graph import DataflowGraph, Transformation
from flink_tensorflow_tpu_torch.core.operators import Operator, Output, SourceOperator
from flink_tensorflow_tpu_torch.core.partitioning import ForwardPartitioner
from flink_tensorflow_tpu_torch.core.runtime_context import RuntimeContext
from flink_tensorflow_tpu_torch.core.state import KeyedStateStore
from flink_tensorflow_tpu_torch.metrics.registry import MetricRegistry

logger = logging.getLogger(__name__)


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


class JobFailure(RuntimeError):
    pass


class JobTimeout(JobFailure):
    """join() deadline expired — not an operator failure."""


class _Subtask:
    """One executor thread running one operator subtask."""

    def __init__(self, executor: "LocalExecutor", t: Transformation, index: int,
                 operator: Operator, gate: typing.Optional[InputGate], num_input_channels: int):
        self.executor = executor
        self.t = t
        self.index = index
        self.operator = operator
        self.gate = gate
        self.num_input_channels = num_input_channels
        self.thread: typing.Optional[threading.Thread] = None

    @property
    def scope(self) -> str:
        return f"{self.t.name}.{self.index}"

    def _fire_due(self) -> None:
        deadline = self.operator.next_deadline()
        now = time.monotonic()
        if deadline is not None and now >= deadline:
            self.operator.fire_due(now)

    def run_source(self) -> None:
        op = typing.cast(SourceOperator, self.operator)
        executor = self.executor
        throttle = executor.source_throttle_s
        try:
            op.open()
            for value in op.iterate():
                if executor.cancelled.is_set():
                    break
                op.output.emit(value)
                if throttle:
                    time.sleep(throttle)
            if not executor.cancelled.is_set():
                op.finish()
                op.output.broadcast_element(el.EndOfPartition())
            op.close()
        except BaseException as exc:  # noqa: BLE001 - reported through join()
            self._fail(exc)

    def run_worker(self) -> None:
        op = self.operator
        gate = self.gate
        executor = self.executor
        active = self.num_input_channels
        try:
            op.open()
            while active > 0 and not executor.cancelled.is_set():
                # Event-driven wait: a put / wake / close, or the
                # operator's earliest deadline.
                deadline = op.next_deadline()
                timeout = None if deadline is None else max(0.0, deadline - time.monotonic())
                item = gate.poll(timeout=timeout)
                self._fire_due()
                if item is None:
                    continue
                _, element = item
                if isinstance(element, el.StreamRecord):
                    op.process_record(element)
                elif isinstance(element, el.EndOfPartition):
                    active -= 1
            if not executor.cancelled.is_set():
                op.finish()
                op.output.broadcast_element(el.EndOfPartition())
            op.close()
        except BaseException as exc:  # noqa: BLE001 - reported through join()
            self._fail(exc)

    def _fail(self, exc: BaseException) -> None:
        self.executor.fail(self, exc)
        try:
            # Release what open() acquired (a model runner's threads and
            # device memory); the first error is the one reported.
            self.operator.close()
        except Exception:  # noqa: BLE001
            logger.warning("close after failure of %s failed", self.scope, exc_info=True)


class LocalExecutor:
    """Builds the physical plan of a DataflowGraph and runs it."""

    def __init__(self, graph: DataflowGraph, *, channel_capacity: int = 1024,
                 metric_registry: typing.Optional[MetricRegistry] = None,
                 device_provider: typing.Optional[typing.Callable[[str, int], typing.Any]] = None,
                 source_throttle_s: float = 0.0):
        self.graph = graph
        self.channel_capacity = channel_capacity
        self.metrics = metric_registry or MetricRegistry()
        self.device_provider = device_provider
        self.source_throttle_s = source_throttle_s
        self.cancelled = threading.Event()
        self._error: typing.Optional[BaseException] = None
        self._error_lock = threading.Lock()
        self.subtasks: typing.List[_Subtask] = []
        self._gates: typing.List[InputGate] = []
        self._build()

    def _build(self) -> None:
        order = self.graph.topological_order()
        # Channel layout per transformation: a forward edge contributes one
        # channel to each gate, any other edge one per upstream subtask.
        channel_base: typing.Dict[typing.Tuple[int, int], int] = {}
        gate_size: typing.Dict[int, int] = {}
        for t in order:
            base = 0
            for edge_idx, edge in enumerate(t.inputs):
                channel_base[(t.id, edge_idx)] = base
                if isinstance(edge.partitioner, ForwardPartitioner):
                    if edge.upstream.parallelism != t.parallelism:
                        raise ValueError(
                            f"forward edge {edge.upstream.name}->{t.name} requires equal "
                            f"parallelism ({edge.upstream.parallelism} vs {t.parallelism})")
                    base += 1
                else:
                    base += edge.upstream.parallelism
            gate_size[t.id] = base

        gates: typing.Dict[typing.Tuple[int, int], InputGate] = {}
        by_t: typing.Dict[int, typing.List[_Subtask]] = {}
        for t in order:
            subtasks = []
            for i in range(t.parallelism):
                gate = None
                if not t.is_source:
                    gate = InputGate(gate_size[t.id], capacity=self.channel_capacity)
                    gates[(t.id, i)] = gate
                    self._gates.append(gate)
                subtasks.append(_Subtask(self, t, i, t.operator_factory(), gate,
                                         gate_size[t.id]))
            by_t[t.id] = subtasks

        for t in order:
            downstream = [(d, edge_idx, edge)
                          for d in self.graph.transformations
                          for edge_idx, edge in enumerate(d.inputs)
                          if edge.upstream.id == t.id]
            for st in by_t[t.id]:
                edges = []
                for d, edge_idx, edge in downstream:
                    base = channel_base[(d.id, edge_idx)]
                    if isinstance(edge.partitioner, ForwardPartitioner):
                        targets = [(st.index, base)]
                    else:
                        targets = [(j, base + st.index) for j in range(d.parallelism)]
                    writers = [ChannelWriter(gates[(d.id, j)], ch) for j, ch in targets]
                    # Stateful partitioners (rebalance's round robin) are
                    # per upstream subtask.
                    edges.append((copy.deepcopy(edge.partitioner), writers))
                device = (self.device_provider(t.name, st.index)
                          if self.device_provider is not None else None)
                ctx = RuntimeContext(t.name, st.index, t.parallelism,
                                     self.metrics.group(st.scope), device=device)
                if st.gate is not None:
                    ctx.wakeup = st.gate.wake
                st.operator.setup(ctx, Output(edges), KeyedStateStore())
                self.subtasks.append(st)

    def start(self) -> None:
        for st in self.subtasks:
            body = st.run_source if st.t.is_source else st.run_worker
            st.thread = threading.Thread(target=body, name=st.scope, daemon=True)
        for st in self.subtasks:
            st.thread.start()

    def join(self, timeout: typing.Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        for st in self.subtasks:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            st.thread.join(remaining)
            if st.thread.is_alive():
                self.cancel()
                raise JobTimeout(f"timeout waiting for subtask {st.scope}")
        if self._error is not None:
            raise JobFailure(f"job failed: {self._error!r}") from self._error

    def fail(self, subtask: _Subtask, exc: BaseException) -> None:
        with self._error_lock:
            if self._error is None:
                self._error = exc
        logger.error("subtask %s failed", subtask.scope, exc_info=exc)
        self.cancel()

    def cancel(self) -> None:
        self.cancelled.set()
        for gate in self._gates:
            gate.close()
