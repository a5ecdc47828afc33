"""Subtask loops and the local executor.

Port of ``flink_tensorflow_tpu/core/runtime.py``:

- :class:`KeyedSubtask` drives one operator in the calling thread:
  ``setup`` -> optional ``restore`` -> ``open`` -> records interleaved
  with ``fire_due`` whenever ``next_deadline()`` is due -> ``finish`` ->
  ``close``, with the output collected in a list and snapshots taken by
  :meth:`KeyedSubtask.snapshot` between records (the serving phase).
- :class:`LocalExecutor` (``:692``) runs a whole dataflow graph: the
  chaining pass (``analysis/chaining.py``) groups its operators into
  chains, and each chain subtask is one thread (:class:`_Subtask`,
  ``:166-330``) with one input gate (none for a source chain), outputs
  routed by each edge's partitioner.  Inside a chain the records pass by
  direct call (:class:`ChainedOutput`, ``:87-165``); every logical
  operator keeps its metric scope and checkpoint identity
  (:class:`_ChainedUnit`, ``:64``).  ``chaining=False`` gives the
  one-thread-per-operator layout, with the same outputs.  Watermarks
  merge per input channel (the minimum over live channels, a finished
  channel no longer holding it back, ``:640-679``) and pass along a chain
  through each member's ``process_watermark`` (``:150-151``); a record
  reaches its operator with the index of its input edge
  (``process_record_from``, ``:598``), so joins and connected streams
  tell their inputs apart.  Aligned
  checkpoints run through it: sources cut barriers on request or every N
  records (``run_source``, ``:349``), workers align them across their
  channels (``run_worker``, ``:541``), the barrier snapshots each chain
  member head to tail, the
  :class:`~flink_tensorflow_tpu_torch.core.checkpoint.CheckpointCoordinator`
  persists and announces them, and :meth:`LocalExecutor.restore`
  (``:1247``) loads a checkpoint by logical operator, in either layout,
  redistributing keyed state by key group when a parallelism changed.
"""

from __future__ import annotations

import copy
import logging
import threading
import time
import typing

from flink_tensorflow_tpu_torch.analysis.chaining import (
    accepts_device_op,
    compute_chains,
    device_capable_op,
)
from flink_tensorflow_tpu_torch.checkpoint.store import to_host
from flink_tensorflow_tpu_torch.core import elements as el
from flink_tensorflow_tpu_torch.core.channels import ChannelWriter, InputGate
from flink_tensorflow_tpu_torch.core.checkpoint import CheckpointCoordinator
from flink_tensorflow_tpu_torch.core.graph import DataflowGraph, Transformation
from flink_tensorflow_tpu_torch.core.operators import Operator, Output, SourceOperator
from flink_tensorflow_tpu_torch.core.partitioning import ForwardPartitioner, HashPartitioner
from flink_tensorflow_tpu_torch.core.runtime_context import RuntimeContext
from flink_tensorflow_tpu_torch.core.state import KeyedStateStore
from flink_tensorflow_tpu_torch.metrics.registry import MetricRegistry
from flink_tensorflow_tpu_torch.parallel.multihost import topology
from flink_tensorflow_tpu_torch.tensors.serde import normalize_wire_dtype
from flink_tensorflow_tpu_torch.tensors.transfer import env_device_resident, env_wire_dtype

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
        self.keyed_state = KeyedStateStore()
        self.ctx = RuntimeContext(operator.name, keyed_state=self.keyed_state)
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
    """join() deadline expired — not an operator failure; restart
    strategies propagate it instead of replaying a healthy job."""

class _ChainedUnit:
    """One logical operator inside a chain's subtask.  It keeps its own
    metric scope and its own checkpoint identity ``(t.name, index)``,
    whether or not it shares a thread with its neighbours."""

    __slots__ = ("t", "index", "operator", "output", "records_in", "records_out")

    def __init__(self, t: Transformation, index: int, operator: Operator):
        self.t = t
        self.index = index
        self.operator = operator
        self.output: typing.Any = None
        self.records_in = None   # Meter
        self.records_out = None  # Meter

    @property
    def scope(self) -> str:
        return f"{self.t.name}.{self.index}"


class ChainedOutput:
    """Output of a chain member that is not the tail: it calls the next
    member on the same thread, with no queue.

    - a record goes straight into the next operator's
      ``process_record_from(0, ...)`` (a fused member has one input);
      a ``DeviceBatch`` does too when that operator consumes device
      batches (``accepts_device``), and otherwise materializes here, once,
      and goes on record by record (the host boundary);
    - a watermark goes through the next member's ``process_watermark``,
      which flushes what it must and forwards it on its own output;
    - a barrier snapshots and acks the next member before it moves on,
      so each member's snapshot follows everything it processed;
    - end of partition runs the next member's ``finish()``, then moves on.
    """

    __slots__ = ("_subtask", "_unit", "_records_out", "_accepts_device")

    def __init__(self, subtask: "_Subtask", unit: _ChainedUnit, records_out,
                 accepts_device: bool = False):
        self._subtask = subtask
        self._unit = unit
        self._records_out = records_out
        self._accepts_device = accepts_device

    def emit(self, value: typing.Any, timestamp: typing.Optional[float] = None) -> None:
        n = 1
        if getattr(value, "is_device_batch", False):
            if not self._accepts_device:
                ts = timestamp if timestamp is not None else value.timestamp
                for tv in value.materialize():
                    self.emit(tv, ts)
                return
            n = value.num_records  # meters count records under fusion too
        self._records_out.mark(n)
        self._unit.records_in.mark(n)
        self._unit.operator.process_record_from(0, el.StreamRecord(value, timestamp))

    def broadcast_element(self, element: el.StreamElement) -> None:
        unit = self._unit
        if isinstance(element, el.Watermark):
            unit.operator.process_watermark(element)
            return
        if isinstance(element, el.CheckpointBarrier):
            self._subtask.snapshot_unit(unit, element.checkpoint_id)
        elif isinstance(element, el.EndOfPartition):
            unit.operator.finish()
        unit.output.broadcast_element(element)


class _Subtask:
    """One executor thread running a chain of operator subtasks behind
    one input gate (none for a source chain).  ``units`` hold the fused
    members head first; a chain of one is an unchained subtask.  ``t``,
    ``operator`` and ``output`` are the head's: the thread feeds the head
    and the chain passes everything on by direct call."""

    def __init__(self, executor: "LocalExecutor", chain: typing.Sequence[Transformation],
                 index: int, operators: typing.Sequence[Operator],
                 gate: typing.Optional[InputGate], num_input_channels: int,
                 edge_of_channel: typing.Sequence[int] = ()):
        self.executor = executor
        self.units = [_ChainedUnit(t, index, op) for t, op in zip(chain, operators)]
        self.t = chain[0]
        self.index = index
        self.operator = operators[0]
        self.gate = gate
        self.num_input_channels = num_input_channels
        #: The head's input edge of each gate channel.
        self.edge_of_channel = list(edge_of_channel) or [0] * num_input_channels
        self.thread: typing.Optional[threading.Thread] = None
        self.finished = threading.Event()
        #: Checkpoint ids a trigger asked this SOURCE to cut, and the
        #: completed ids to announce to the operators on their own thread.
        self._control: typing.List[int] = []
        self._notifications: typing.List[int] = []
        #: Ids the coordinator aborted at their deadline, waiting for this
        #: thread, and those it has taken: a late barrier of one is
        #: swallowed, not aligned (its alignment could never complete).
        self._aborts: typing.List[int] = []
        self._aborted_cids: typing.Set[int] = set()
        self._control_lock = threading.Lock()
        #: Barrier alignment spans (first barrier -> snapshot), set in _build.
        self.alignment = None

    @property
    def scope(self) -> str:
        return f"{self.t.name}.{self.index}"

    @property
    def output(self):
        """The head's output (a :class:`ChainedOutput` when fused)."""
        return self.units[0].output

    # -- control from other threads -----------------------------------------
    def request_checkpoint(self, checkpoint_id: int) -> None:
        with self._control_lock:
            self._control.append(checkpoint_id)

    def _drain_control(self) -> typing.List[int]:
        with self._control_lock:
            pending, self._control = self._control, []
        return pending

    def add_notification(self, checkpoint_id: int) -> None:
        with self._control_lock:
            self._notifications.append(checkpoint_id)

    def add_abort(self, checkpoint_id: int) -> None:
        """The coordinator aborted ``checkpoint_id``: deliver it to this
        subtask's thread (a worker's gate is woken to take it)."""
        with self._control_lock:
            self._aborts.append(checkpoint_id)
        if self.gate is not None:
            self.gate.wake()

    def _drain_aborts(self) -> typing.List[int]:
        with self._control_lock:
            pending, self._aborts = self._aborts, []
        self._aborted_cids.update(pending)
        return pending

    def deliver_notifications(self) -> None:
        with self._control_lock:
            pending, self._notifications = self._notifications, []
        for cid in pending:
            for unit in self.units:
                unit.operator.notify_checkpoint_complete(cid)

    # -- the chain --------------------------------------------------------------
    def _open_chain(self) -> None:
        """Tail first, so every member's downstream is live before its
        first record."""
        for unit in reversed(self.units):
            unit.operator.open()

    def _close_chain(self) -> None:
        for unit in self.units:
            unit.operator.close()

    def _chain_next_deadline(self) -> typing.Optional[float]:
        deadlines = [d for d in (u.operator.next_deadline() for u in self.units)
                     if d is not None]
        return min(deadlines) if deadlines else None

    def _chain_fire_due(self, now: float) -> None:
        for unit in self.units:
            d = unit.operator.next_deadline()
            if d is not None and now >= d:
                unit.operator.fire_due(now)

    def snapshot_unit(self, unit: _ChainedUnit, checkpoint_id: int) -> None:
        """Snapshot and ack one logical operator.  Device tensors leave for
        the host here, on the thread that owns them: the coordinator and
        its persist thread see host objects only."""
        snapshot = to_host(unit.operator.snapshot(checkpoint_id))
        self.executor.coordinator.ack(checkpoint_id, unit.t.name, unit.index, snapshot)

    def _snapshot_and_ack(self, checkpoint_id: int) -> None:
        self.snapshot_unit(self.units[0], checkpoint_id)

    # -- thread bodies ---------------------------------------------------------
    def _source_barrier(self, checkpoint_id: int) -> None:
        """Cut this source's stream: snapshot + ack, then the barrier
        (which snapshots each fused member in turn).  An aborted id is
        not cut."""
        if checkpoint_id in self._aborted_cids:
            return
        self._snapshot_and_ack(checkpoint_id)
        self.output.broadcast_element(el.CheckpointBarrier(checkpoint_id))

    def run_source(self) -> None:
        op = typing.cast(SourceOperator, self.operator)
        executor = self.executor
        throttle = executor.source_throttle_s
        every_n = executor.checkpoint_every_n
        try:
            self._open_chain()
            for value in op.iterate():
                if executor.cancelled.is_set():
                    break
                self.deliver_notifications()
                self._drain_aborts()
                for cid in self._drain_control():
                    self._source_barrier(cid)
                if isinstance(value, el.SourceIdle):
                    continue  # a heartbeat: barriers served, no record
                self.output.emit(value)
                op.record_emitted()
                # Count-based barriers: checkpoint k cuts the stream after
                # this subtask's k*N-th record, a deterministic position.
                if every_n and op.offset % every_n == 0:
                    cid = op.offset // every_n
                    if executor.coordinator.begin_source_checkpoint(cid):
                        self._source_barrier(cid)
                if throttle:
                    time.sleep(throttle)
            if not executor.cancelled.is_set():
                # Serve the barrier requests that raced with the last records.
                for cid in self._drain_control():
                    self._source_barrier(cid)
                op.finish()
                self.output.broadcast_element(el.EndOfPartition())
            self._close_chain()
        except BaseException as exc:  # noqa: BLE001 - reported through join()
            self._fail(exc)
        finally:
            self.finished.set()
            executor.subtask_finished(self)

    def run_worker(self) -> None:
        op = self.operator
        gate = self.gate
        executor = self.executor
        records_in = self.units[0].records_in
        n = self.num_input_channels
        edge_of_channel = self.edge_of_channel
        eop = [False] * n
        watermarks = [float("-inf")] * n
        current_wm = float("-inf")
        #: checkpoint id -> channels whose barrier arrived, and the time
        #: the first one did.
        barrier_seen: typing.Dict[int, typing.Set[int]] = {}
        barrier_t0: typing.Dict[int, float] = {}

        def merge_watermarks() -> None:
            """The head's watermark: the minimum over live channels."""
            nonlocal current_wm
            live = [watermarks[i] for i in range(n) if not eop[i]]
            if live and min(live) > current_wm:
                current_wm = min(live)
                op.process_watermark(el.Watermark(current_wm))

        def align(cid: int) -> None:
            live = {i for i in range(n) if not eop[i]}
            if live and not live <= barrier_seen[cid]:
                return
            self.alignment.record(time.monotonic() - barrier_t0.pop(cid))
            self._snapshot_and_ack(cid)
            self.output.broadcast_element(el.CheckpointBarrier(cid))
            del barrier_seen[cid]
            gate.unblock_all()

        try:
            self._open_chain()
            active = n
            while active > 0 and not executor.cancelled.is_set():
                # Event-driven wait: a put / wake / close, or the chain's
                # earliest deadline.
                deadline = self._chain_next_deadline()
                timeout = None if deadline is None else max(0.0, deadline - time.monotonic())
                item = gate.poll(timeout=timeout)
                self.deliver_notifications()
                for cid in self._drain_aborts():
                    # An aborted checkpoint: drop its alignment, so the
                    # channels its missing barrier blocked flow again.
                    if barrier_seen.pop(cid, None) is not None:
                        barrier_t0.pop(cid, None)
                        gate.unblock_all()
                self._chain_fire_due(time.monotonic())
                if item is None:
                    continue
                idx, element = item
                if isinstance(element, el.StreamRecord):
                    records_in.mark()
                    op.process_record_from(edge_of_channel[idx], element)
                elif isinstance(element, el.Watermark):
                    watermarks[idx] = element.timestamp
                    merge_watermarks()
                elif isinstance(element, el.CheckpointBarrier):
                    cid = element.checkpoint_id
                    if cid in self._aborted_cids:
                        # A late barrier of an aborted checkpoint: neither
                        # aligned nor forwarded (every subtask was told).
                        continue
                    seen = barrier_seen.setdefault(cid, set())
                    if not seen:
                        barrier_t0[cid] = time.monotonic()
                    seen.add(idx)
                    gate.block_channel(idx)
                    align(cid)
                elif isinstance(element, el.EndOfPartition):
                    eop[idx] = True
                    active -= 1
                    # A finished channel counts as barriered for every
                    # pending alignment (it can never deliver its barrier).
                    if active:
                        for cid in list(barrier_seen):
                            align(cid)
                        # A finished channel no longer holds the watermark
                        # back (Flink counts it as the maximum).
                        merge_watermarks()
            if not executor.cancelled.is_set():
                op.finish()
                self.output.broadcast_element(el.EndOfPartition())
            self._close_chain()
        except BaseException as exc:  # noqa: BLE001 - reported through join()
            self._fail(exc)
        finally:
            self.finished.set()
            executor.subtask_finished(self)

    def _fail(self, exc: BaseException) -> None:
        self.executor.fail(self, exc)
        for unit in self.units:
            try:
                # Release what open() acquired (a model runner's threads and
                # device memory); the first error is the one reported.
                unit.operator.close()
            except Exception:  # noqa: BLE001
                logger.warning("close after failure of %s failed", unit.scope, exc_info=True)


class LocalExecutor:
    """Builds the physical plan of a DataflowGraph and runs it."""

    def __init__(self, graph: DataflowGraph, *, channel_capacity: int = 1024,
                 metric_registry: typing.Optional[MetricRegistry] = None,
                 device_provider: typing.Optional[typing.Callable[[str, int], typing.Any]] = None,
                 source_throttle_s: float = 0.0,
                 checkpoint_dir: typing.Optional[str] = None,
                 checkpoint_every_n: typing.Optional[int] = None,
                 checkpoint_timeout_s: float = 60.0,
                 checkpoint_retain_last: typing.Optional[int] = None,
                 max_parallelism: int = 128,
                 mesh: typing.Any = None,
                 chaining: bool = True,
                 device_resident: bool = False,
                 wire_dtype: typing.Optional[str] = None):
        self.graph = graph
        self.mesh = mesh
        self.channel_capacity = channel_capacity
        self.metrics = metric_registry or MetricRegistry()
        self.device_provider = device_provider
        self.source_throttle_s = source_throttle_s
        self.checkpoint_every_n = checkpoint_every_n
        self.checkpoint_timeout_s = checkpoint_timeout_s
        self.checkpoint_retain_last = checkpoint_retain_last
        self.max_parallelism = max_parallelism
        self.chaining = chaining
        # The environment variables of the reference's executor (JAX
        # ``core/runtime.py:719-748``) apply where the config is unset.
        self.device_resident = device_resident or env_device_resident()
        #: H2D wire dtype of the model functions that set none themselves:
        #: ``JobConfig.wire_dtype``, else ``FLINK_TPU_WIRE_DTYPE``; "f32"
        #: is None.
        self.wire_dtype = normalize_wire_dtype(
            wire_dtype if wire_dtype is not None else env_wire_dtype())
        #: Processes of the cohort this one belongs to
        #: (``parallel.multihost``; 1 outside a ``torch.distributed`` group).
        self.num_processes = topology().num_processes
        #: Periodic trigger interval (set by the environment before start).
        self.checkpoint_interval_s: typing.Optional[float] = None
        self.cancelled = threading.Event()
        self._error: typing.Optional[BaseException] = None
        self._error_lock = threading.Lock()
        #: One per chain and parallel index: the threads of the job.
        self.subtasks: typing.List[_Subtask] = []
        self._gates: typing.List[InputGate] = []
        #: The chaining decision (``analysis.chaining.ChainPlan``).
        self.chain_plan = None
        self.coordinator = CheckpointCoordinator(self, checkpoint_dir)
        self._finished_count = 0
        self._all_done = threading.Event()
        self._periodic_thread: typing.Optional[threading.Thread] = None
        self._build()

    def _build(self) -> None:
        order = self.graph.topological_order()
        for t in order:
            keyed = any(isinstance(e.partitioner, HashPartitioner) for e in t.inputs)
            if keyed and t.parallelism > self.max_parallelism:
                raise ValueError(
                    f"keyed operator {t.name!r} parallelism {t.parallelism} exceeds "
                    f"max_parallelism {self.max_parallelism} — key groups would starve "
                    "the subtasks above the bound; raise JobConfig.max_parallelism")
        plan = compute_chains(self.graph, enabled=self.chaining)
        self.chain_plan = plan
        chain_by_head = {chain[0].id: chain for chain in plan.chains}
        heads = [t for t in order if t.id in chain_by_head]

        # Channel layout per chain head (a fused edge has no channel): a
        # forward edge contributes one channel to each gate, any other
        # edge one per upstream subtask.
        channel_base: typing.Dict[typing.Tuple[int, int], int] = {}
        gate_size: typing.Dict[int, int] = {}
        edge_of_channel: typing.Dict[int, typing.List[int]] = {}
        for t in heads:
            base = 0
            channel_edges: typing.List[int] = []
            for edge_idx, edge in enumerate(t.inputs):
                channel_base[(t.id, edge_idx)] = base
                if isinstance(edge.partitioner, ForwardPartitioner):
                    if edge.upstream.parallelism != t.parallelism:
                        raise ValueError(
                            f"forward edge {edge.upstream.name}->{t.name} requires equal "
                            f"parallelism ({edge.upstream.parallelism} vs {t.parallelism})")
                    span = 1
                else:
                    span = edge.upstream.parallelism
                channel_edges.extend([edge_idx] * span)
                base += span
            gate_size[t.id] = base
            edge_of_channel[t.id] = channel_edges

        # One subtask per chain per parallel index; members share their
        # head's index (fusion needs equal parallelism).
        gates: typing.Dict[typing.Tuple[int, int], InputGate] = {}
        by_head: typing.Dict[int, typing.List[_Subtask]] = {}
        for t in heads:
            chain = chain_by_head[t.id]
            subtasks = []
            for i in range(t.parallelism):
                gate = None
                if not t.is_source:
                    gate = InputGate(gate_size[t.id], capacity=self.channel_capacity)
                    gates[(t.id, i)] = gate
                    self._gates.append(gate)
                operators = [member.operator_factory() for member in chain]
                subtasks.append(_Subtask(self, chain, i, operators, gate, gate_size[t.id],
                                         edge_of_channel[t.id]))
            by_head[t.id] = subtasks

        # Only a chain's tail writes to channels: every edge out of it
        # targets another chain's head gate.
        for t in heads:
            tail = chain_by_head[t.id][-1]
            downstream = [(d, edge_idx, edge)
                          for d in self.graph.transformations
                          for edge_idx, edge in enumerate(d.inputs)
                          if edge.upstream.id == tail.id]
            for st in by_head[t.id]:
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
                self._wire(st, edges, channel_base)
                self.subtasks.append(st)

    def _wire(self, st: _Subtask, edges, channel_base) -> None:
        """Outputs, metrics, runtime contexts and ``setup`` of one chain's
        members: the tail writes to ``edges``, every other member calls
        the next through a :class:`ChainedOutput`."""
        chain_len = len(st.units)
        for unit in st.units:
            grp = self.metrics.group(unit.scope)
            unit.records_in = grp.meter("records_in")
            unit.records_out = grp.meter("records_out")
            grp.gauge("chained_edges", lambda n=chain_len - 1: n)
        st.alignment = self.metrics.group(st.scope).histogram("checkpoint_alignment_s")
        st.units[-1].output = Output(edges, meter=st.units[-1].records_out)
        for k in range(chain_len - 1):
            unit, nxt = st.units[k], st.units[k + 1]
            accepts = accepts_device_op(nxt.operator)
            unit.output = ChainedOutput(st, nxt, unit.records_out, accepts_device=accepts)
            if accepts and self.device_resident and device_capable_op(unit.operator):
                # The next member consumes device batches: this member's
                # function may keep its results on the card.
                unit.operator.function._device_chain_hint = True
        if st.gate is not None:
            grp = self.metrics.group(st.scope)
            # Per-edge queue gauges exist on real channels only: a fused
            # edge has none, which is what shows it carries no queue.
            for edge_idx, edge in enumerate(st.t.inputs):
                span = (1 if isinstance(edge.partitioner, ForwardPartitioner)
                        else edge.upstream.parallelism)
                lo = channel_base[(st.t.id, edge_idx)]
                grp.gauge(f"edge{edge_idx}_{edge.upstream.name}_queue_puts",
                          lambda g=st.gate, a=lo, b=lo + span: sum(g.puts_per_channel[a:b]))
        for unit in st.units:
            device = (self.device_provider(unit.t.name, unit.index)
                      if self.device_provider is not None else None)
            state = KeyedStateStore()
            ctx = RuntimeContext(unit.t.name, unit.index, unit.t.parallelism,
                                 self.metrics.group(unit.scope), device=device,
                                 keyed_state=state, mesh=self.mesh,
                                 num_processes=self.num_processes)
            ctx.device_resident = self.device_resident
            ctx.wire_dtype = self.wire_dtype
            if st.gate is not None:
                # A runner's fetch thread wakes the one thread that runs
                # the whole chain, whichever member it belongs to.
                ctx.wakeup = st.gate.wake
            unit.operator.setup(ctx, unit.output, state)

    # -- restore ---------------------------------------------------------------
    def restore(self, snapshots: typing.Dict[str, typing.Dict[int, typing.Any]],
                from_checkpoint_id: typing.Optional[int] = None) -> None:
        """Load ``{task: {subtask: snapshot}}`` into the operators before
        :meth:`start`.  Snapshots are keyed by logical operator, so a job
        snapshotted in one chaining layout restores in another.  A task
        whose parallelism changed gets its keyed state redistributed by
        key group (``Operator.rescale``)."""
        if from_checkpoint_id is not None:
            # New checkpoints must never overwrite the restore point.
            self.coordinator.resume_from(from_checkpoint_id)
        job_meta = snapshots.pop("__job__", None)
        if job_meta:
            pinned = job_meta.get(0, {}).get("max_parallelism")
            if pinned is not None and pinned != self.max_parallelism:
                raise ValueError(
                    f"checkpoint was taken with max_parallelism={pinned}; this job uses "
                    f"{self.max_parallelism} — the key-group routing would change and "
                    "orphan keyed state. Restore with the original max_parallelism.")
        by_task: typing.Dict[str, typing.List[_ChainedUnit]] = {}
        for st in self.subtasks:
            for unit in st.units:
                by_task.setdefault(unit.t.name, []).append(unit)
        for task, units in by_task.items():
            task_snaps = snapshots.get(task)
            if task_snaps is None:
                continue
            parallelism = units[0].t.parallelism
            for unit in units:
                if len(task_snaps) == parallelism:
                    snap = task_snaps.get(unit.index)
                    if snap is not None:
                        unit.operator.restore(snap)
                else:
                    unit.operator.restore(unit.operator.rescale(
                        task_snaps, unit.index, parallelism, self.max_parallelism))

    # -- execution -------------------------------------------------------------
    def start(self) -> None:
        for st in self.subtasks:
            body = st.run_source if st.t.is_source else st.run_worker
            st.thread = threading.Thread(target=body, name=st.scope, daemon=True)
        for st in self.subtasks:
            st.thread.start()
        if self.checkpoint_interval_s is not None:
            self._periodic_thread = threading.Thread(
                target=self._periodic_checkpoints, name="checkpoint-timer", daemon=True)
            self._periodic_thread.start()

    def _periodic_checkpoints(self) -> None:
        """Trigger an aligned checkpoint every interval until the job ends.
        A trigger racing with completion or cancellation just fails and is
        not retried."""
        interval = self.checkpoint_interval_s
        while not self._all_done.wait(interval) and not self.cancelled.is_set():
            try:
                self.coordinator.trigger(timeout=self.checkpoint_timeout_s)
            except Exception:
                # Catch everything: an escaping error would end this thread
                # silently and the job would run on, unpersisted.
                if self._all_done.is_set() or self.cancelled.is_set():
                    return
                logger.warning("periodic checkpoint failed", exc_info=True)

    def join(self, timeout: typing.Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        for st in self.subtasks:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            st.thread.join(remaining)
            if st.thread.is_alive():
                self.cancel()
                raise JobTimeout(f"timeout waiting for subtask {st.scope}")
        if self._periodic_thread is not None:
            self._periodic_thread.join(
                None if deadline is None else max(0.1, deadline - time.monotonic()))
        # Completed checkpoints are durable before the job reports done.
        in_flight = self.coordinator.wait_for_persistence(
            None if deadline is None else max(0.1, deadline - time.monotonic()))
        if in_flight:
            raise JobTimeout(f"{in_flight} checkpoint write(s) did not drain — completed "
                             "checkpoints are not yet durable")
        self.coordinator.shutdown()
        if self._error is None:
            # Notifications that landed after a subtask's loop exited: every
            # thread is joined, so delivering them here keeps one writer.
            for st in self.subtasks:
                try:
                    st.deliver_notifications()
                except Exception:  # noqa: BLE001 - the job already completed
                    logger.warning("post-close checkpoint notification failed for %s",
                                   st.scope, exc_info=True)
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
        self.coordinator.cancel_pending()

    def notify_checkpoint_complete(self, checkpoint_id: int) -> None:
        """Fan a durable-checkpoint notification out to every subtask
        (delivered to each operator on its own thread)."""
        for st in self.subtasks:
            st.add_notification(checkpoint_id)

    def notify_checkpoint_aborted(self, checkpoint_id: int) -> None:
        """Fan a checkpoint abort out to every subtask: each drops the
        id's alignment (unblocking channels a missing barrier held) and
        swallows its late barriers, so the job keeps flowing."""
        for st in self.subtasks:
            st.add_abort(checkpoint_id)

    @property
    def all_done(self) -> threading.Event:
        """Set once every subtask has finished."""
        return self._all_done

    def subtask_finished(self, subtask: _Subtask) -> None:
        self.coordinator.subtask_finished(subtask)
        with self._error_lock:
            self._finished_count += 1
            if self._finished_count >= len(self.subtasks):
                self._all_done.set()

    @property
    def total_subtasks(self) -> int:
        """Logical subtasks, one per operator per parallel index: the
        checkpoint coordinator expects one ack from each, however chains
        pack them onto threads."""
        return sum(len(st.units) for st in self.subtasks)
