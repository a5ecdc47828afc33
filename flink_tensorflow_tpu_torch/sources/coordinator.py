"""The per-job split coordinator, the enumerator's thread-safe host.

Port of ``flink_tensorflow_tpu/sources/coordinator.py`` (``:50-227``).
One coordinator exists per split-source transformation per executor
(``LocalExecutor.split_coordinator``), shared by all of that source's
reader subtasks.  It holds the :class:`SplitEnumerator` behind a lock and
serves two protocols:

**Pull-based assignment.**  ``poll_split(reader)`` hands out the next
split on demand; a reader that drains its split early asks again, so
work spreads by itself.  The call never blocks: it answers ``wait`` when
no split can be handed out now, and the reader parks on its mailbox
(``sources/mailbox.py``) until something changes.

**Checkpoint consistency.**  The pool's snapshot must agree with every
reader's snapshot of its in-flight split, or a split could be restored
twice (duplicate records) or not at all (lost records).  The pool
snapshot of checkpoint ``k`` is taken when the first reader cuts its
stream at barrier ``k``, and assignment is frozen until every reader (or
finished subtask) has passed ``k``.  A split is then in exactly one place
at every reader's barrier: pooled (in the pool snapshot), in flight on a
reader (in that reader's snapshot, with its offset), or done.  Readers
parked on the freeze still serve their own barriers (the mailbox wait is
barrier-wakeable), so the freeze cannot block the alignment it protects.

The pool snapshot rides in reader 0's operator snapshot, under the
source's own (task, subtask) identity in the checkpoint store.

Lock order: the checkpoint coordinator's lock, then this split lock, then
a mailbox's condition (the reference's order, JAX
``core/checkpoint.py:113-114``).  Mailboxes are notified after the split
lock is released.
"""

from __future__ import annotations

import threading
import typing

from flink_tensorflow_tpu_torch.sources.api import SourceSplit, SplitEnumerator, SplitSource

if typing.TYPE_CHECKING:
    from flink_tensorflow_tpu_torch.sources.mailbox import SourceMailbox

#: poll_split answers: a split to read, park and poll again, or end of input.
ASSIGNED = "assigned"
WAIT = "wait"
EXHAUSTED = "exhausted"


class SplitCoordinator:
    def __init__(self, source: SplitSource, num_readers: int, *,
                 sanitizer: typing.Optional[typing.Any] = None, name: str = "split"):
        self.source = source
        self.num_readers = num_readers
        #: The concurrency sanitizer: the lock is instrumented and every
        #: dispense is checked against the alignment freeze (JAX ``:52-62``,
        #: ``:146``).
        self._san = sanitizer
        self._name = name
        self._lock = (sanitizer.lock(f"{name}.coordinator")
                      if sanitizer is not None else threading.Lock())
        self._mailboxes: typing.Dict[int, "SourceMailbox"] = {}
        self._enumerator: typing.Optional[SplitEnumerator] = None
        #: Enumerator state restored before the job starts (reader 0's
        #: snapshot carries it), applied when the enumerator is built.
        self._restored_state: typing.Any = None
        self._has_restored_state = False
        #: In-flight splits of readers a rescale removed: pooled, not
        #: pinned to subtask indices that no longer exist.
        self._returned: typing.List[SourceSplit] = []
        #: checkpoint id -> readers that passed its barrier; any entry
        #: freezes assignment.
        self._aligning: typing.Dict[int, typing.Set[int]] = {}
        #: checkpoint id -> the pool snapshot taken at its first barrier.
        self._chk_state: typing.Dict[int, typing.Any] = {}
        #: Readers whose subtask finished: they pass no more barriers and
        #: must hold no alignment open.
        self._finished: typing.Set[int] = set()
        #: Splits handed out in all (the ``splits_assigned`` gauge).
        self.splits_dispensed = 0

    # -- wiring (executor build and restore, before any thread runs) ------
    def add_reader(self, index: int, mailbox: "SourceMailbox") -> None:
        self._mailboxes[index] = mailbox

    def deliver_restored_state(self, state: typing.Any) -> None:
        with self._lock:
            if self._enumerator is not None:
                self._enumerator.restore_state(state)
            else:
                self._restored_state = state
                self._has_restored_state = True

    def add_splits_back(self, splits: typing.Sequence[SourceSplit]) -> None:
        if not splits:
            return
        with self._lock:
            if self._enumerator is not None:
                self._enumerator.add_splits_back(list(splits))
            else:
                self._returned.extend(splits)
        self._notify_all()

    # -- assignment (reader threads) ----------------------------------------
    def _ensure_enumerator(self) -> SplitEnumerator:
        """Build the enumerator on first use (caller holds the lock).  The
        restored state and returned splits arrived before any reader ran,
        so the build always sees them."""
        if self._enumerator is None:
            enum = self.source.create_enumerator()
            if self._has_restored_state:
                enum.restore_state(self._restored_state)
                self._restored_state = None
            if self._returned:
                enum.add_splits_back(self._returned)
                self._returned = []
            self._enumerator = enum
        return self._enumerator

    def poll_split(self, reader_index: int) -> typing.Tuple[str, typing.Optional[SourceSplit]]:
        with self._lock:
            if self._aligning:
                # Frozen while a barrier aligns; its completion notifies
                # every mailbox.
                return WAIT, None
            return self._dispense_locked(reader_index)

    def _dispense_locked(self, reader_index: int
                         ) -> typing.Tuple[str, typing.Optional[SourceSplit]]:
        """Hand the next split to ``reader_index`` (caller holds the lock
        and has honoured the freeze)."""
        split = self._ensure_enumerator().next_split(reader_index)
        if split is None:
            return (EXHAUSTED if self.source.bounded else WAIT), None
        self.splits_dispensed += 1
        if self._san is not None:
            self._san.split_dispensed(self._name, frozen=bool(self._aligning))
        return ASSIGNED, split

    # -- checkpoint protocol --------------------------------------------------
    def on_barrier(self, checkpoint_id: int, reader_index: int) -> typing.Optional[typing.Any]:
        """Reader ``reader_index`` cuts its stream at this barrier.  Returns
        the checkpoint's pool snapshot to the reader that carries it
        (reader 0), else None."""
        with self._lock:
            passed = self._aligning.get(checkpoint_id)
            if passed is None:
                passed = self._aligning[checkpoint_id] = set()
                self._chk_state[checkpoint_id] = self._pool_state_locked()
            passed.add(reader_index)
            snap = self._chk_state[checkpoint_id] if reader_index == 0 else None
            done = len(passed | self._finished) >= self.num_readers
            if done:
                del self._aligning[checkpoint_id]
                self._chk_state.pop(checkpoint_id, None)
        if done:
            self._notify_all()
        return snap

    def pending_alignments(self, reader_index: int) -> typing.List[int]:
        """Checkpoint ids frozen on this coordinator that ``reader_index``
        has not passed, ascending.

        For the runtime's freeze-deadlock guard: a reader parked with no
        split on the freeze emits no records, so under count-based
        triggers it never reaches the position that would cut the pending
        barrier; the alignment would wait for the reader and the reader
        for the alignment.  The runtime cuts these at the wait point."""
        with self._lock:
            return sorted(cid for cid, passed in self._aligning.items()
                          if reader_index not in passed)

    def cancel_alignment(self, checkpoint_id: int) -> None:
        """The checkpoint coordinator aborted ``checkpoint_id`` at its
        deadline: drop its freeze and staged pool snapshot, so assignment
        thaws and readers stop seeing it as pending."""
        with self._lock:
            dropped = self._aligning.pop(checkpoint_id, None)
            self._chk_state.pop(checkpoint_id, None)
        if dropped is not None:
            self._notify_all()

    def reader_finished(self, reader_index: int) -> None:
        """A reader's subtask ended: it counts as passed for every current
        and later alignment (its final snapshot stands in for its acks, as
        the checkpoint coordinator's final snapshots do)."""
        with self._lock:
            self._finished.add(reader_index)
            complete = [cid for cid, passed in self._aligning.items()
                        if len(passed | self._finished) >= self.num_readers]
            for cid in complete:
                del self._aligning[cid]
                self._chk_state.pop(cid, None)
        self._notify_all()

    def live_pool_state(self) -> typing.Any:
        """The pool snapshot now, outside any barrier (the final snapshot
        of a subtask that reached the end of its input)."""
        with self._lock:
            return self._pool_state_locked()

    def _pool_state_locked(self) -> typing.Any:
        if self._enumerator is not None:
            return self._enumerator.snapshot_state()
        # Nothing dispensed yet: the pool is what the restore delivered
        # (None: the source's fresh splits).
        return self._restored_state if self._has_restored_state else None

    def _notify_all(self) -> None:
        for mailbox in self._mailboxes.values():
            mailbox.notify()
