"""SplitSourceOperator, the runtime host of a SplitSource.

Port of ``flink_tensorflow_tpu/sources/operator.py`` (``:44-260``), the
physical side of ``env.from_source(split_source)``: one instance per
source subtask, driven by the mailbox loop of ``core/runtime.py``
(``_Subtask.run_split_source``).  The operator owns the read side (the
current split, its record iterator, the split's offset) and the loop
owns all waiting: :meth:`poll_next` never blocks; it answers "a record",
"park until ``due``" or "input exhausted".

Checkpoints: the in-flight split (offset included) goes into this
subtask's snapshot; reader 0 also carries the coordinator's pool
snapshot, taken at the barrier (``sources/coordinator.py``).  ``offset``
counts the subtask's emitted records as the legacy source operator does,
so count-based barriers (``checkpoint.every_n_records``) work here too;
with pulled splits those positions depend on the run, not only on the
stream.

Unlike the legacy source, this operator rescales: on a restore at
another source parallelism, every old reader's in-flight split and the
old pool merge, and the new readers pull from the merged pool, each split
resuming at its offset.

Traced (``ctx.tracer``), a reader marks each split's lifecycle on its
track: a ``split.request`` instant at its first pull toward the
coordinator, ``split.assign`` when a split arrives, and a ``split.read``
span from the split's first read to its end (JAX ``:132-151``).
"""

from __future__ import annotations

import time
import typing

from flink_tensorflow_tpu_torch.core.operators import Operator
from flink_tensorflow_tpu_torch.sources.api import NotReady, SourceSplit, SplitSource
from flink_tensorflow_tpu_torch.sources.coordinator import ASSIGNED, EXHAUSTED

if typing.TYPE_CHECKING:
    from flink_tensorflow_tpu_torch.sources.coordinator import SplitCoordinator
    from flink_tensorflow_tpu_torch.sources.mailbox import SourceMailbox

#: poll_next answers for the runtime loop.
RECORD = "record"
WAIT = "wait"
DONE = "done"


class SplitSourceOperator(Operator):
    #: Read by the executor (which loop runs the subtask) and the chaining
    #: pass: this source's wait is mailbox-wakeable, so timer-driven
    #: operators may fuse into its chain.
    is_split_source = True
    wakeable = True

    def __init__(self, name: str, source: SplitSource):
        super().__init__(name)
        self.source = source
        self.reader = None
        self.coordinator: typing.Optional["SplitCoordinator"] = None
        self.mailbox: typing.Optional["SourceMailbox"] = None
        self.reader_index = 0
        #: Records emitted by this subtask (count-based barriers).
        self.offset = 0
        self.current_split: typing.Optional[SourceSplit] = None
        self._iter: typing.Optional[typing.Iterator[typing.Any]] = None
        self._split_started_s: typing.Optional[float] = None
        self.splits_completed = 0
        self._restored: typing.Optional[dict] = None
        #: The pool snapshot ``on_barrier`` staged for the next
        #: ``snapshot()`` (reader 0 only): ``snapshot()`` has no way to pass
        #: the checkpoint id down to ``_operator_snapshot``.
        self._staged_pool: typing.Any = None
        self._staged_pool_set = False
        #: Span tracer and track (set at open; None untraced), and whether
        #: the pull for the next split is already marked.
        self._tracer = None
        self._track: typing.Optional[str] = None
        self._split_requested = False

    # -- wiring (executor, before open and restore) --------------------------
    def attach(self, coordinator: "SplitCoordinator", index: int,
               mailbox: "SourceMailbox") -> None:
        self.coordinator = coordinator
        self.reader_index = index
        self.mailbox = mailbox
        coordinator.add_reader(index, mailbox)

    # -- lifecycle ----------------------------------------------------------
    def open(self) -> None:
        self._tracer = getattr(self.ctx, "tracer", None)
        if self._tracer is not None:
            self._track = f"{self.ctx.task_name}.{self.ctx.subtask_index}"
        self.reader = self.source.create_reader(self.ctx)
        self.reader.open(self.ctx)
        grp = self.ctx.metrics
        # How the work spread (the work-stealing evidence) and what each
        # reader holds now.
        grp.gauge("splits_completed", lambda: self.splits_completed)
        grp.gauge("current_split_id",
                  lambda: self.current_split.split_id if self.current_split else None)
        grp.gauge("current_split_age_s", self._split_age)
        if self.reader_index == 0:
            grp.gauge("splits_assigned",
                      lambda: self.coordinator.splits_dispensed if self.coordinator else 0)

    def close(self) -> None:
        if self.reader is not None:
            self.reader.close()
            self.reader = None

    def _split_age(self) -> typing.Optional[float]:
        if self._split_started_s is None:
            return None
        return time.monotonic() - self._split_started_s

    # -- records (called only by the run_split_source loop) -----------------------
    def poll_next(self) -> typing.Tuple[str, typing.Any]:
        """One step that never blocks: ``(RECORD, value)``, ``(WAIT, due or
        None)`` or ``(DONE, None)``.  The loop emits a record at once, so
        the split's offset moves here without racing a barrier (one
        thread; barriers are served between polls)."""
        tracer = self._tracer
        while True:
            if self._iter is None:
                if self.current_split is None:
                    if tracer is not None and not self._split_requested:
                        self._split_requested = True
                        tracer.instant(self._track, "split.request")
                    status, split = self.coordinator.poll_split(self.reader_index)
                    if status == EXHAUSTED:
                        return DONE, None
                    if status != ASSIGNED:
                        return WAIT, None
                    self.current_split = split
                    if tracer is not None:
                        self._split_requested = False
                        tracer.instant(self._track, "split.assign",
                                       args={"split": split.split_id})
                # A restored in-flight split arrives with current_split set
                # and no iterator: the same path as a fresh assignment.
                self._iter = self.reader.read(self.current_split)
                self._split_started_s = time.monotonic()
            try:
                value = next(self._iter)
            except StopIteration:
                if tracer is not None and self._split_started_s is not None:
                    tracer.span(self._track, "split.read", self._split_started_s,
                                time.monotonic(), args={"split": self.current_split.split_id})
                self._iter = None
                self.current_split = None
                self._split_started_s = None
                self.splits_completed += 1
                continue
            if isinstance(value, NotReady):
                return WAIT, value.due
            self.current_split.offset += 1
            return RECORD, value

    def record_emitted(self) -> None:
        self.offset += 1

    def pending_alignments(self) -> typing.List[int]:
        """Frozen alignments this reader still owes a barrier to, when it
        is parked with no split (it cannot move its offset toward a
        count-based position; the runtime cuts these at the wait point).
        A reader in mid-split returns []: its own trigger will come."""
        if self.coordinator is None or self.current_split is not None:
            return []
        return self.coordinator.pending_alignments(self.reader_index)

    def process_record(self, record):  # pragma: no cover - sources have no input
        raise RuntimeError("SplitSourceOperator has no input")

    # -- checkpoints --------------------------------------------------------
    def on_barrier(self, checkpoint_id: int) -> None:
        """The loop cuts its stream at this barrier, before ``snapshot()``:
        register with the coordinator, and stage the pool snapshot where
        this reader carries it."""
        snap = self.coordinator.on_barrier(checkpoint_id, self.reader_index)
        if self.reader_index == 0:
            self._staged_pool = snap
            self._staged_pool_set = True

    def _operator_snapshot(self):
        snap = {
            "offset": self.offset,
            "in_flight": self.current_split.freeze() if self.current_split is not None else None,
        }
        if self.reader_index == 0:
            if self._staged_pool_set:
                pool = self._staged_pool
                self._staged_pool = None
                self._staged_pool_set = False
            else:
                # A final snapshot (no barrier staged a pool).
                pool = self.coordinator.live_pool_state() if self.coordinator is not None else None
            snap["pool"] = pool
        return snap

    def _operator_restore(self, state) -> None:
        self._restored = dict(state)

    def apply_restore(self) -> None:
        """Push restored state where it lives: the executor calls this
        after ``restore()`` and before any reader thread runs, so the
        enumerator, built on first use, always sees it."""
        if self._restored is None:
            return
        state = self._restored
        self._restored = None
        self.offset = state.get("offset", 0)
        # At the same parallelism the in-flight split resumes on this
        # reader at its offset; a rescale routes old in-flight splits
        # through "extra_splits" instead.
        self.current_split = state.get("in_flight")
        pool = state.get("pool")
        if pool is not None:
            self.coordinator.deliver_restored_state(pool)
        extras = state.get("extra_splits")
        if extras:
            self.coordinator.add_splits_back(extras)

    def rescale(self, old, index, parallelism, max_parallelism):
        """The source's parallelism changed across the restart: pool
        everything (the old unassigned splits and every old reader's
        in-flight split, offsets kept) and let the new readers pull.
        Reader 0 carries the merged pool; nobody starts with a split."""
        snap = {"keyed": {}, "function": None, "operator": {"offset": 0, "in_flight": None}}
        if index != 0:
            return snap
        in_flight = []
        pool = None
        for s in old.values():
            if s is None:
                continue
            op_state = s.get("operator") or {}
            if op_state.get("in_flight") is not None:
                in_flight.append(op_state["in_flight"])
            if op_state.get("pool") is not None:
                pool = op_state["pool"]
        snap["operator"] = {"offset": 0, "in_flight": None, "pool": pool,
                            "extra_splits": in_flight}
        return snap

    def finish(self) -> None:
        if self.coordinator is not None:
            self.coordinator.reader_finished(self.reader_index)
