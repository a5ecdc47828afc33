"""Checkpoint coordinator — aligned snapshots, persisted and announced.

Port of ``flink_tensorflow_tpu/core/checkpoint.py:24-509``.  The
coordinator collects one snapshot per operator subtask for each
checkpoint id.  Snapshots reach it as host objects: the subtask thread
that took one copies its tensors to the CPU before acking
(``checkpoint.store.to_host``), so the persist thread never sees a device
tensor.

The deadline sweeper (JAX ``:262-318``): a source-initiated checkpoint
still pending ``checkpoint_timeout_s`` after its registration is
aborted: its id joins ``aborted_ids`` (the ``recovery.checkpoints_aborted``
gauge), its late acks are dropped, and every subtask is told
(``executor.notify_checkpoint_aborted``) so it drops the id's alignment,
unblocks its gate and swallows the id's late barriers.  Sources keep
cutting later checkpoints, which complete.  A ``trigger()`` that times
out aborts its checkpoint the same way, then fails its caller.  The
sweeper thread starts with the first count-based checkpoint and ends
when the job is done or cancelled.

The distributed hooks (JAX ``:94-107``, ``:169``, ``:369``), set by
``core/distributed.py``: ``lazy_register`` registers a checkpoint at its
first local ack (its barrier may come from a source on a peer process);
``commit_gate(id)`` runs after the local shard is durable and before the
completion notification, and a False return withholds the 2PC commit
signal (the checkpoint is not yet durable on every process);
``job_meta_extra`` rides into the shard's ``__job__`` entry and
``METADATA.json`` (the cohort shape a restore validates); and a manual
``trigger()`` is refused on a distributed job (it would reach only the
local sources and bypass the gate).

Disk format: one directory per checkpoint (``checkpoint/store.py``).
"""

from __future__ import annotations

import concurrent.futures
import logging
import threading
import time
import typing

from flink_tensorflow_tpu_torch.checkpoint import store

if typing.TYPE_CHECKING:
    from flink_tensorflow_tpu_torch.core.runtime import LocalExecutor, _Subtask

logger = logging.getLogger(__name__)


class _PendingCheckpoint:
    def __init__(self, checkpoint_id: int, expected: int, *, source_initiated: bool = False):
        self.checkpoint_id = checkpoint_id
        self.expected = expected
        self.snapshots: typing.Dict[str, typing.Dict[int, typing.Any]] = {}
        self.acks = 0
        self.done = threading.Event()
        self.failed = False
        #: Count-based checkpoints have no trigger() caller waiting on
        #: them: persistence happens on completion, off the ack thread.
        self.source_initiated = source_initiated
        #: Trigger time; ``checkpoint.duration_s`` runs from here to durable.
        self.created_s = time.monotonic()

    def add(self, task: str, index: int, snapshot: typing.Any) -> bool:
        """Record one subtask's snapshot; True once all have arrived."""
        self.snapshots.setdefault(task, {})[index] = snapshot
        self.acks += 1
        if self.acks >= self.expected:
            self.done.set()
            return True
        return False


class CheckpointCoordinator:
    """Collects one snapshot per subtask per aligned checkpoint.

    Two trigger modes:

    - ``trigger()`` (timer/manual): allocates an id and asks every source
      to inject a barrier at its CURRENT position.  Concurrent callers
      queue behind each other.
    - source-initiated (``begin_source_checkpoint``): with
      ``CheckpointConfig.every_n_records`` each source injects barrier
      ``k`` after its ``k*N``-th record, so barrier positions are a pure
      function of the stream.  Several may be in flight; per-gate channel
      blocking serializes alignment within each gate.
    """

    def __init__(self, executor: "LocalExecutor", checkpoint_dir: typing.Optional[str] = None):
        self.executor = executor
        self.checkpoint_dir = checkpoint_dir
        #: Job-level metrics: ``duration_s`` (trigger -> durable),
        #: ``completed``, ``last_checkpoint_id``, ``last_size_bytes``.
        self.metrics = executor.metrics.group("checkpoint")
        self._last_checkpoint_id: typing.Optional[int] = None
        self._last_size_bytes: typing.Optional[int] = None
        self.metrics.gauge("last_checkpoint_id", lambda: self._last_checkpoint_id)
        self.metrics.gauge("last_size_bytes", lambda: self._last_size_bytes)
        #: Distributed hooks (see the module docstring).
        self.lazy_register = False
        self.commit_gate: typing.Optional[typing.Callable[[int], bool]] = None
        self.job_meta_extra: typing.Dict[str, typing.Any] = {}
        #: Checkpoint ids declined at their deadline, in abort order.
        self.aborted_ids: typing.List[int] = []
        executor.metrics.group("recovery").gauge("checkpoints_aborted",
                                                 lambda: len(self.aborted_ids))
        self._next_id = 1
        self._lock = threading.Lock()
        #: Serializes whole trigger() calls: a manual trigger colliding
        #: with the periodic timer queues behind it instead of failing.
        self._trigger_lock = threading.Lock()
        self._pending: typing.Dict[int, _PendingCheckpoint] = {}
        self._completed: typing.List[int] = []
        #: Final snapshots of subtasks that finished (bounded jobs): they
        #: complete checkpoints racing with job completion.
        self._final_snapshots: typing.Dict[typing.Tuple[str, int], typing.Any] = {}
        #: One persist worker: source-initiated checkpoints are written in
        #: completion order, and join() drains it.
        self._persist_pool: typing.Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._persist_futures: typing.List[concurrent.futures.Future] = []
        #: The deadline sweeper of source-initiated checkpoints, started
        #: at the first one (a ``trigger()`` caller keeps its own timeout).
        self._abort_thread: typing.Optional[threading.Thread] = None
        self._abort_stop = threading.Event()

    def resume_from(self, checkpoint_id: int) -> None:
        """Continue numbering after a restored checkpoint so new snapshots
        never overwrite the restore point."""
        with self._lock:
            self._next_id = max(self._next_id, checkpoint_id + 1)

    # -- trigger ----------------------------------------------------------
    def trigger(self, timeout: float = 60.0) -> typing.Dict[str, typing.Dict[int, typing.Any]]:
        """Run one aligned checkpoint; returns ``{task: {subtask: snapshot}}``.
        A call made while another is in flight waits for it (within the
        same ``timeout``) and then runs its own."""
        if self.executor.checkpoint_every_n:
            raise RuntimeError(
                "manual/timer checkpoints are disabled when "
                "checkpoint.every_n_records is set — barrier positions must "
                "stay a deterministic function of the stream")
        if self.lazy_register or self.commit_gate is not None:
            raise RuntimeError(
                "manual checkpoints are not available on distributed jobs — "
                "configure checkpoint.every_n_records (deterministic "
                "cohort-wide barrier positions)")
        deadline = time.monotonic() + timeout
        if not self._trigger_lock.acquire(timeout=timeout):
            raise TimeoutError(f"another checkpoint did not drain within {timeout}s")
        try:
            return self._trigger_locked(max(0.05, deadline - time.monotonic()))
        finally:
            self._trigger_lock.release()

    def _with_job_meta(self, snapshots):
        """Persisted checkpoints pin the key-group count: restoring under
        another max_parallelism would orphan keyed state."""
        return {**snapshots, "__job__": {0: {"max_parallelism": self.executor.max_parallelism,
                                              **self.job_meta_extra}}}

    def _seed_finished(self, pending: _PendingCheckpoint) -> None:
        """Subtasks that already finished ack at once with their final
        state (caller holds the lock)."""
        for (task, idx), snap in self._final_snapshots.items():
            pending.add(task, idx, snap)

    def _trigger_locked(self, timeout: float):
        with self._lock:
            cid = self._next_id
            self._next_id += 1
            pending = _PendingCheckpoint(cid, self.executor.total_subtasks)
            self._pending[cid] = pending
            self._seed_finished(pending)
        for st in self.executor.subtasks:
            if st.t.is_source:
                st.request_checkpoint(cid)
        if not pending.done.wait(timeout):
            with self._lock:
                self._pending.pop(cid, None)
                self.aborted_ids.append(cid)
            self._announce_abort(cid, "trigger timeout")
            raise TimeoutError(f"checkpoint {cid} did not complete within {timeout}s")
        with self._lock:
            self._pending.pop(cid, None)
        if pending.failed:
            raise RuntimeError(f"checkpoint {cid} failed (job cancelled)")
        self._completed.append(cid)
        path = None
        if self.checkpoint_dir is not None:
            path = store.write_checkpoint(self.checkpoint_dir, cid,
                                          self._with_job_meta(pending.snapshots))
        self._record_completed(pending, path)
        self.executor.notify_checkpoint_complete(cid)
        self._prune()
        return pending.snapshots

    def begin_source_checkpoint(self, checkpoint_id: int) -> bool:
        """Register a count-based checkpoint (idempotent across the source
        subtasks that reach the position).  True: the calling source cuts
        its barrier; False: the id belongs to a completed or restored
        checkpoint."""
        with self._lock:
            if checkpoint_id in self._pending:
                return True
            if checkpoint_id < self._next_id:
                return False
            pending = _PendingCheckpoint(checkpoint_id, self.executor.total_subtasks,
                                         source_initiated=True)
            self._pending[checkpoint_id] = pending
            self._next_id = checkpoint_id + 1
            self._seed_finished(pending)
            self._ensure_abort_sweeper_locked()
        return True

    # -- deadline abort ----------------------------------------------------
    def _ensure_abort_sweeper_locked(self) -> None:
        """Start the deadline sweeper once (caller holds the lock)."""
        if self._abort_thread is not None or self._abort_stop.is_set():
            return
        self._abort_thread = threading.Thread(target=self._abort_loop,
                                              name="checkpoint-abort-sweeper", daemon=True)
        self._abort_thread.start()

    def _abort_loop(self) -> None:
        """Every ``min(timeout / 4, 1 s)`` (at least 20 ms): abort each
        source-initiated checkpoint older than the timeout.  Ends when the
        job is done or cancelled, or at :meth:`shutdown`."""
        timeout = self.executor.checkpoint_timeout_s
        interval = max(0.02, min(timeout / 4.0, 1.0))
        executor = self.executor
        while not self._abort_stop.wait(interval):
            if executor.cancelled.is_set() or executor.all_done.is_set():
                return
            now = time.monotonic()
            expired: typing.List[_PendingCheckpoint] = []
            with self._lock:
                for cid, pending in list(self._pending.items()):
                    if pending.source_initiated and now - pending.created_s > timeout:
                        pending.failed = True
                        pending.done.set()
                        del self._pending[cid]
                        self.aborted_ids.append(cid)
                        expired.append(pending)
            for pending in expired:
                self._announce_abort(
                    pending.checkpoint_id,
                    f"missed deadline ({timeout:.1f}s) with {pending.acks}/{pending.expected} acks")

    def _announce_abort(self, checkpoint_id: int, why: str) -> None:
        """Log one declined checkpoint and fan the abort out to the
        subtasks (they drop the id's alignment)."""
        logger.warning("checkpoint %d aborted: %s; discarded, sources keep cutting later "
                       "checkpoints", checkpoint_id, why)
        self.executor.notify_checkpoint_aborted(checkpoint_id)

    def _complete_locked(self, pending: _PendingCheckpoint) -> None:
        """Finish a source-initiated checkpoint (caller holds the lock, so
        persist jobs queue strictly in completion order)."""
        self._completed.append(pending.checkpoint_id)

        def job():
            path = None
            if self.checkpoint_dir is not None:
                try:
                    path = store.write_checkpoint(
                        self.checkpoint_dir, pending.checkpoint_id,
                        self._with_job_meta(pending.snapshots))
                except Exception:
                    logger.warning("persisting checkpoint %d failed", pending.checkpoint_id,
                                   exc_info=True)
                    return  # not durable: no completion notification
            self._record_completed(pending, path)
            # A cohort promotes 2PC output only once every process holds
            # its shard of the checkpoint.
            if self.commit_gate is not None and not self.commit_gate(pending.checkpoint_id):
                return
            self.executor.notify_checkpoint_complete(pending.checkpoint_id)
            self._prune()

        if self._persist_pool is None:
            self._persist_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="chk-persist")
        self._persist_futures.append(self._persist_pool.submit(job))

    def _record_completed(self, pending: _PendingCheckpoint, path: typing.Optional[str]) -> None:
        self.metrics.histogram("duration_s").record(time.monotonic() - pending.created_s)
        self.metrics.counter("completed").inc()
        self._last_checkpoint_id = pending.checkpoint_id
        if path is not None:
            self._last_size_bytes = store.checkpoint_size_bytes(path)

    def _prune(self) -> None:
        """Keep the newest ``retain_last`` checkpoints on disk — run only
        behind a newer durable, notified checkpoint."""
        retain = self.executor.checkpoint_retain_last
        if retain is not None and self.checkpoint_dir is not None:
            store.prune_checkpoints(self.checkpoint_dir, retain)

    def wait_for_persistence(self, timeout: typing.Optional[float] = 60.0) -> int:
        """Block until every completed checkpoint has landed on disk;
        returns how many writes are STILL in flight after ``timeout``."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                futures = list(self._persist_futures)
            if not futures:
                return 0
            budget = None if deadline is None else deadline - time.monotonic()
            if budget is not None and budget <= 0:
                return len(futures)
            done, _ = concurrent.futures.wait(futures, timeout=budget)
            with self._lock:
                self._persist_futures = [f for f in self._persist_futures if f not in done]

    def shutdown(self) -> None:
        """Stop the deadline sweeper and the persist worker (after
        :meth:`wait_for_persistence`)."""
        self._abort_stop.set()
        if self._abort_thread is not None:
            self._abort_thread.join(timeout=5.0)
        if self._persist_pool is not None:
            self._persist_pool.shutdown(wait=True)
            self._persist_pool = None

    # -- subtask callbacks -------------------------------------------------
    def ack(self, checkpoint_id: int, task: str, subtask_index: int, snapshot: typing.Any) -> None:
        with self._lock:
            pending = self._pending.get(checkpoint_id)
            if pending is None and self.lazy_register and checkpoint_id >= self._next_id:
                pending = _PendingCheckpoint(checkpoint_id, self.executor.total_subtasks,
                                             source_initiated=True)
                self._pending[checkpoint_id] = pending
                self._next_id = checkpoint_id + 1
                self._seed_finished(pending)
                self._ensure_abort_sweeper_locked()
            if pending is None:
                return
            if pending.add(task, subtask_index, snapshot) and pending.source_initiated:
                del self._pending[checkpoint_id]
                if not pending.failed:
                    self._complete_locked(pending)

    def subtask_finished(self, subtask: "_Subtask") -> None:
        """A subtask ended: its final snapshot acks every pending
        checkpoint it had not acked, and every later one.  A subtask of a
        cancelled or failed attempt acks nothing: it left its loop without
        finishing its input, so what it holds after ``close()`` is no state
        a checkpoint may contain (its records replay from the last
        completed checkpoint)."""
        if self.executor.cancelled.is_set():
            return
        # One final snapshot per logical operator: a chain's subtask runs
        # several, each with its own (task, index) identity.
        for unit in subtask.units:
            try:
                snap = store.to_host(unit.operator.snapshot())
            except Exception:  # noqa: BLE001 - the subtask must still count as finished
                snap = None
            task, index = unit.t.name, unit.index
            with self._lock:
                self._final_snapshots[(task, index)] = snap
                for cid, pending in list(self._pending.items()):
                    if index in pending.snapshots.get(task, {}):
                        continue
                    if pending.add(task, index, snap) and pending.source_initiated:
                        del self._pending[cid]
                        if not pending.failed:
                            self._complete_locked(pending)

    def cancel_pending(self) -> None:
        with self._lock:
            for pending in self._pending.values():
                pending.failed = True
                pending.done.set()
            self._pending.clear()

    @property
    def completed_ids(self) -> typing.List[int]:
        return list(self._completed)
