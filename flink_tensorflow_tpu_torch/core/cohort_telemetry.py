"""Cohort telemetry service — clock sync + metric pushes over the
control channel.

Port of ``flink_tensorflow_tpu/core/cohort_telemetry.py``, kept equal to it.

One small daemon thread per cohort process, riding the SAME control
plane the 2PC commit gate uses (``ShuffleServer.CONTROL_TASK`` routes
into ``DistributedExecutor._on_control``):

- **Clock sync** (tracing/clocksync.py): every non-zero process pings
  process 0 — a burst at startup for a tight min-RTT bound, then one
  ping per interval to track drift — computes its monotonic-clock
  offset to process 0, and reports it.  Process 0 accumulates the
  cohort's offset table and broadcasts it, so EVERY process can map any
  peer's span stamps into its own clock (``Tracer.set_clock_offset``):
  the foreign-clock ``queue``/``wire`` spans the tracer used to
  suppress become offset-corrected cross-process spans, and each
  process's Chrome export carries its offset for ``flink-tpu-trace
  --cohort`` stitching.
- **Metric pushes** (metrics/cohort.py): each non-zero process pushes
  its registry's state tree per interval; the process-0
  :class:`~flink_tensorflow_tpu_torch.metrics.cohort.CohortCollector` merges
  them into the cohort-wide snapshot — the ``flink-tpu-inspect --live
  --cohort`` view and the autoscaling supervisor's programmatic feed.

All sends happen on the service's OWN thread (never on the reactor
thread — a connect retry there would stall the record plane), and every
failure is logged-and-swallowed: telemetry must never take the job
down.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
import typing

from flink_tensorflow_tpu_torch.tracing.clocksync import OffsetEstimator

logger = logging.getLogger(__name__)

#: Control-frame kinds this service owns (everything else stays with the
#: executor's checkpoint handling).
KINDS = frozenset({
    "clock_ping", "clock_pong", "clock_report", "clock_table",
    "metrics_push",
})


class CohortTelemetryService:
    """Per-process telemetry worker of a DistributedExecutor cohort.

    ``send(peer_index, message)`` is the executor's control-writer hook;
    incoming control frames are handed to :meth:`on_control` (reactor
    thread — it only enqueues) and processed on the service thread.
    """

    def __init__(self, *, process_index: int, num_processes: int,
                 pid: int,
                 send: typing.Callable[[int, typing.Any], None],
                 registry, tracer=None, flight=None, sanitizer=None,
                 interval_s: float = 2.0, startup_pings: int = 5):
        self.process_index = process_index
        self.num_processes = num_processes
        self.pid = pid
        self._send = send
        self.registry = registry
        self.tracer = tracer
        self.flight = flight
        #: ConcurrencySanitizer (or None): receives the same cohort
        #: identity block as the tracer, so happens-before logs are
        #: orderable onto the process-0 timebase even with tracing off.
        self.sanitizer = sanitizer
        self.interval_s = interval_s
        self.startup_pings = startup_pings
        #: Process-0 side: the cohort aggregation point (exists only
        #: there — it IS the supervisor feed).
        self.collector = None
        if process_index == 0:
            from flink_tensorflow_tpu_torch.metrics.cohort import CohortCollector

            self.collector = CohortCollector(
                registry, process_index, num_processes)
        #: Non-zero side: offset of THIS clock into process 0's.
        self.estimator = OffsetEstimator() if process_index != 0 else None
        #: pid -> offset_to_proc0 over the whole cohort (process 0's own
        #: entry is 0 by definition); plus per-pid error bounds.
        self._table: typing.Dict[int, float] = {pid: 0.0} if process_index == 0 else {}
        self._errors: typing.Dict[int, float] = {pid: 0.0} if process_index == 0 else {}
        self._inbox: typing.Deque[typing.Tuple[float, int, typing.Any]] = \
            collections.deque()
        self._cv = threading.Condition()
        self._stop = threading.Event()
        self._thread: typing.Optional[threading.Thread] = None
        self._seq = 0
        self._push_seq = 0
        #: Set once this process can offset-correct at least one peer's
        #: stamps (first table applied / first report received) — test
        #: and supervisor synchronization point.
        self.synced = threading.Event()
        if process_index == 0:
            self._apply_offsets()

    # -- ingress (reactor thread: enqueue ONLY) --------------------------
    def handles(self, kind: typing.Any) -> bool:
        return kind in KINDS

    def on_control(self, sender: int, message: typing.Any) -> None:
        with self._cv:
            self._inbox.append((time.monotonic(), sender, message))
            self._cv.notify()

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        if (self._thread is not None or self.num_processes < 2
                or self.interval_s <= 0):
            return
        self._thread = threading.Thread(
            target=self._run, name=f"cohort-telemetry:{self.process_index}",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    # -- service thread --------------------------------------------------
    def _run(self) -> None:
        try:
            if self.process_index != 0:
                # Startup burst: a handful of closely spaced pings gives
                # the estimator a tight min-RTT bound before the first
                # records cross the plane.
                for _ in range(self.startup_pings):
                    if self._stop.is_set():
                        return
                    self._ping()
                    self._sleep_and_drain(0.02)
                self._report_and_push()
            while not self._stop.is_set():
                self._sleep_and_drain(self.interval_s)
                if self._stop.is_set():
                    return
                if self.process_index != 0:
                    self._ping()
                    self._sleep_and_drain(0.05)
                    self._report_and_push()
        except Exception:  # noqa: BLE001 — telemetry must never kill the job
            logger.warning("cohort telemetry service failed", exc_info=True)

    def _sleep_and_drain(self, timeout: float) -> None:
        """Process inbox messages until ``timeout`` elapses (or stop)."""
        deadline = time.monotonic() + timeout
        while not self._stop.is_set():
            with self._cv:
                while not self._inbox:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or self._stop.is_set():
                        return
                    self._cv.wait(remaining)
                batch = list(self._inbox)
                self._inbox.clear()
            for t_recv, sender, message in batch:
                try:
                    self._dispatch(t_recv, sender, message)
                except Exception:  # noqa: BLE001
                    logger.warning("telemetry message failed: %r",
                                   message, exc_info=True)

    def _dispatch(self, t_recv: float, sender: int, message: tuple) -> None:
        kind = message[0]
        if kind == "clock_ping":
            # (kind, sender_index, sender_pid, seq, t_send): echo the
            # receive stamp — taken on the reactor thread at arrival,
            # the closest thing to the wire midpoint we can observe.
            _, idx, _spid, seq, t_send = message
            self._safe_send(idx, ("clock_pong", seq, t_send, t_recv))
        elif kind == "clock_pong":
            _, _seq, t_send, t_server = message
            if self.estimator is not None and self.estimator.add_sample(
                    t_send, t_server, t_recv):
                self._apply_offsets()
        elif kind == "clock_report":
            # (kind, sender_index, sender_pid, offset_s, error_s)
            _, _idx, spid, offset_s, error_s = message
            self._table[spid] = offset_s
            self._errors[spid] = error_s
            self._apply_offsets()
            if self.process_index == 0:
                self._broadcast_table()
        elif kind == "clock_table":
            _, table, errors = message
            self._table.update(table)
            self._errors.update(errors)
            self._apply_offsets()
        elif kind == "metrics_push":
            # (kind, sender_index, seq, state)
            _, idx, seq, state = message
            if self.collector is not None:
                self.collector.on_push(idx, seq, state)

    # -- clock plumbing --------------------------------------------------
    def _ping(self) -> None:
        self._seq += 1
        self._safe_send(0, ("clock_ping", self.process_index, self.pid,
                            self._seq, time.monotonic()))

    def _report_and_push(self) -> None:
        if self.estimator is not None and self.estimator.ready:
            self._safe_send(0, ("clock_report", self.process_index,
                                self.pid, self.estimator.offset_s,
                                self.estimator.error_bound_s))
        self._push_seq += 1
        self._safe_send(0, ("metrics_push", self.process_index,
                            self._push_seq,
                            self.registry.export_state()))

    def _broadcast_table(self) -> None:
        message = ("clock_table", dict(self._table), dict(self._errors))
        for p in range(1, self.num_processes):
            self._safe_send(p, message)

    def offset_to_proc0(self) -> typing.Optional[float]:
        if self.process_index == 0:
            return 0.0
        return self.estimator.offset_s if self.estimator else None

    def _apply_offsets(self) -> None:
        """Fold the current table into the tracer: peer pid -> offset
        into THIS clock (t_local = t_peer + off), via process 0:
        off = off_peer_to_0 - off_self_to_0."""
        off_self = self.offset_to_proc0()
        if off_self is None:
            return
        err_self = (0.0 if self.estimator is None
                    else self.estimator.error_bound_s)
        tracer = self.tracer
        applied = 0
        for spid, off in self._table.items():
            if spid == self.pid:
                continue
            if tracer is not None:
                tracer.set_clock_offset(
                    spid, off - off_self,
                    self._errors.get(spid, 0.0) + err_self)
            applied += 1
        if tracer is not None:
            tracer.cohort_meta = {
                "process_index": self.process_index,
                "pid": self.pid,
                "offset_to_proc0_s": off_self,
                "error_bound_s": err_self,
            }
        if self.sanitizer is not None:
            self.sanitizer.cohort_meta = {
                "process_index": self.process_index,
                "pid": self.pid,
                "offset_to_proc0_s": off_self,
                "error_bound_s": err_self,
            }
        if applied and not self.synced.is_set():
            self.synced.set()
            if self.flight is not None:
                self.flight.record("telemetry", "clock.synced", {
                    "offset_to_proc0_s": off_self,
                    "error_bound_s": err_self,
                    "peers": applied,
                })

    def _safe_send(self, peer: int, message: tuple) -> None:
        if peer == self.process_index:
            return
        try:
            self._send(peer, message)
        except Exception:  # noqa: BLE001 — peer down is a job-level event
            logger.debug("telemetry send to peer %d failed", peer,
                         exc_info=True)
