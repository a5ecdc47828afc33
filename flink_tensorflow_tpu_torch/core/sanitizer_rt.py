"""Debug-mode concurrency sanitizer, the runtime half of the pipeline
sanitizer (the plan-time half is ``analysis/sanitizer.py``).

Port of ``flink_tensorflow_tpu/core/sanitizer_rt.py``.  The runtime is
concurrent: one thread per operator chain, condition-variable channels
(``core/channels.py``), the wakeable source mailbox
(``sources/mailbox.py``), the barrier-frozen split assignment
(``sources/coordinator.py``) and the checkpoint coordinator fanning
barriers across all of them.  Lost wakeups, lock-order inversions and
protocol bugs there break exactly-once silently.  This module records
happens-before over that machinery, ThreadSanitizer style:

**Lock discipline.**  :meth:`ConcurrencySanitizer.lock` and
:meth:`ConcurrencySanitizer.condition` hand out wrappers that record, per
thread, which locks are held and in what order.  Each
``A held while acquiring B`` adds an edge to a lock-order graph; a pair
seen in both directions is a **lock-order inversion**, whether or not the
timing deadlocked.  An acquire whose owner waits (transitively) on a lock
the acquiring thread holds is a **waits-for deadlock cycle**: recorded and
raised at once as :class:`SanitizerError`, so a test sees a diagnostic and
not a hang.

**Stall watchdog.**  With ``stall_timeout_s`` (constructor or
``FLINK_TPU_SANITIZE_STALL_S``) a daemon thread flags any thread parked in
an untimed instrumented wait longer than the budget and dumps every
thread's stack with the lock ownership and wait maps.  A lost wakeup shows
this way.  Off by default: healthy pipelines park untimed legitimately.

**Shake mode.**  ``FLINK_TPU_SANITIZE_SHAKE=<seed>`` injects seeded short
sleeps in the wrappers (before a blocking acquire, a park and a notify),
so interleavings the scheduler rarely produces run under the same checks.

**Cross-process happens-before log.**  Every record-plane seam (frame
send and receive with per-(edge, connection) sequence numbers, barrier
injection and alignment, credit grants and spends, epoch handshakes)
appends one event to a bounded ring (:meth:`ConcurrencySanitizer.hb`),
dumped as JSON (``FLINK_TPU_SANITIZE_LOG`` /
``JobConfig(sanitize_log_path=...)``) in the reference's file format, so
either package's stitcher reads either package's log.
``core/sanitizer_stitch.py`` merges a cohort's logs and runs the checks
no single process can see.

**Protocol state machines.**  Independent re-derivations of the
runtime's checkpoint invariants, fed by hooks at the protocol points:

- *barrier alignment*: no element is delivered from a channel blocked for
  alignment (``gate_channel_blocked`` / ``gate_delivered``);
- *chain snapshot order*: within one subtask, checkpoint ``k`` snapshots
  the chained operators head to tail with no gaps (``chain_snapshot``);
- *assignment freeze*: a split coordinator dispenses no split while a
  barrier alignment is in flight (``split_dispensed``).

On with ``JobConfig(sanitize=True)`` or ``FLINK_TPU_SANITIZE=1``.  Off,
nothing here is built: the runtime takes plain ``threading`` primitives
and each hook is one ``is None`` test.  ``tracer`` is the job's span tracer,
set by the executor when tracing is on too: each violation lands as an
instant on the ``sanitizer`` track.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import os
import sys
import threading
import time
import traceback
import typing

logger = logging.getLogger(__name__)

_TRUTHY = ("1", "true", "on", "yes")

#: Document marker for per-process happens-before logs (the sanitizer
#: analogue of the flight recorder's "flink-tpu-flight").
HB_LOG_KIND = "flink-tpu-sanitizer-log"

#: Default happens-before ring capacity.  Events are ~6-tuple rows; at
#: one event per wire frame / grant batch / handshake this covers long
#: soaks, and the dump carries a ``truncated`` flag when it wrapped so
#: the stitcher can skip prefix-dependent checks instead of lying.
DEFAULT_HB_CAPACITY = 65536


def env_enabled() -> bool:
    """Whether ``FLINK_TPU_SANITIZE`` force-enables the sanitizer."""
    return os.environ.get("FLINK_TPU_SANITIZE", "").lower() in _TRUTHY


def env_stall_timeout_s() -> typing.Optional[float]:
    raw = os.environ.get("FLINK_TPU_SANITIZE_STALL_S")
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        logger.warning("FLINK_TPU_SANITIZE_STALL_S=%r is not a float; ignored", raw)
        return None


def env_shake_seed() -> typing.Optional[int]:
    """``FLINK_TPU_SANITIZE_SHAKE=<seed>``: schedule-fuzzing "shake"
    mode — seeded randomized delays inside the instrumented lock/condvar
    wrappers (see ConcurrencySanitizer.shake)."""
    raw = os.environ.get("FLINK_TPU_SANITIZE_SHAKE")
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        logger.warning("FLINK_TPU_SANITIZE_SHAKE=%r is not an int; ignored", raw)
        return None


def env_hb_log_path() -> typing.Optional[str]:
    """``FLINK_TPU_SANITIZE_LOG=<path>``: dump the happens-before event
    log there at join/crash (distributed runs suffix ``.proc<k>``)."""
    return os.environ.get("FLINK_TPU_SANITIZE_LOG") or None


def env_hb_capacity() -> int:
    raw = os.environ.get("FLINK_TPU_SANITIZE_HB_EVENTS")
    if not raw:
        return DEFAULT_HB_CAPACITY
    try:
        return max(16, int(raw))
    except ValueError:
        logger.warning(
            "FLINK_TPU_SANITIZE_HB_EVENTS=%r is not an int; ignored", raw)
        return DEFAULT_HB_CAPACITY


def load_hb_log(path: str) -> dict:
    """Load one per-process happens-before log, validating the marker."""
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("kind") != HB_LOG_KIND:
        raise ValueError(f"{path}: not a sanitizer happens-before log "
                         f"(kind={doc.get('kind') if isinstance(doc, dict) else type(doc).__name__!r})")
    return doc


@dataclasses.dataclass(frozen=True)
class Violation:
    """One recorded sanitizer finding."""

    kind: str  # lock-order-inversion | deadlock-cycle | stall | barrier-blocked-channel | snapshot-order | assignment-freeze
    message: str
    thread: str
    #: Full state dump captured at detection time (stacks + ownership)
    #: for the kinds where post-mortem context matters.
    dump: typing.Optional[str] = None

    def format(self) -> str:
        return f"[{self.kind}] ({self.thread}) {self.message}"


class SanitizerError(RuntimeError):
    """Raised when the sanitizer's invariants are violated.

    Deliberately not a :class:`~flink_tensorflow_tpu_torch.core.runtime.
    JobFailure`: a concurrency-protocol violation is a bug, and restart
    strategies must not paper over it with a replay."""

    def __init__(self, violations: typing.Sequence[Violation]):
        self.violations = list(violations)
        super().__init__(
            f"{len(self.violations)} sanitizer violation(s):\n"
            + "\n".join(v.format() for v in self.violations)
        )


class InstrumentedLock:
    """A ``threading.Lock`` that reports acquire/release to the sanitizer.

    Works as the lock argument of ``threading.Condition`` (provides
    ``_is_owned``); ``Condition.wait`` then routes its release/re-acquire
    through these hooks too, so a thread re-acquiring after a wake shows
    up in the waits-for graph like any other blocked acquirer.
    """

    __slots__ = ("_lock", "_san", "name", "_owner_tid")

    def __init__(self, san: "ConcurrencySanitizer", name: str):
        self._lock = threading.Lock()
        self._san = san
        self.name = name
        self._owner_tid: typing.Optional[int] = None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        tid = threading.get_ident()
        self._san.shake()
        if self._lock.acquire(False):
            self._owner_tid = tid
            self._san.on_acquired(self.name)
            return True
        if not blocking:
            return False
        self._san.on_acquiring(self.name)  # may raise on a waits-for cycle
        try:
            got = self._lock.acquire(True, timeout)
        finally:
            self._san.on_wait_exit()
        if got:
            self._owner_tid = tid
            self._san.on_acquired(self.name)
        return got

    def release(self) -> None:
        self._owner_tid = None
        self._san.on_released(self.name)
        self._lock.release()

    def _is_owned(self) -> bool:
        return self._owner_tid == threading.get_ident()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "InstrumentedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class InstrumentedCondition:
    """``threading.Condition`` facade recording wait/notify spans.

    Several conditions may share one :class:`InstrumentedLock` (the
    channel gate's two wait-sets do) — pass the same lock object."""

    __slots__ = ("_cond", "_san", "name", "lock")

    def __init__(self, san: "ConcurrencySanitizer", name: str,
                 lock: typing.Optional[InstrumentedLock] = None):
        self.lock = lock if lock is not None else san.lock(f"{name}.lock")
        self._cond = threading.Condition(self.lock)
        self._san = san
        self.name = name

    def wait(self, timeout: typing.Optional[float] = None) -> bool:
        # Shake BEFORE parking, lock still held: widens the window where
        # a concurrent notify can land between predicate check and wait
        # — exactly where lost-wakeup bugs hide.
        self._san.shake()
        self._san.on_wait_enter(self.name, timed=timeout is not None)
        try:
            return self._cond.wait(timeout)
        finally:
            self._san.on_wait_exit()

    def notify(self, n: int = 1) -> None:
        self._san.shake()
        self._san.on_notify(self.name)
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._san.shake()
        self._san.on_notify(self.name)
        self._cond.notify_all()

    def __enter__(self) -> "InstrumentedCondition":
        self.lock.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.lock.release()


class ConcurrencySanitizer:
    """Happens-before recorder + invariant checker for one job.

    All public hooks are thread-safe; internal state lives behind one
    plain (uninstrumented) mutex, which is only ever acquired INSIDE an
    instrumented operation — a fixed, acyclic two-level order."""

    def __init__(self, name: str = "job", *,
                 stall_timeout_s: typing.Optional[float] = None,
                 raise_on_cycle: bool = True,
                 shake_seed: typing.Optional[int] = None,
                 hb_capacity: typing.Optional[int] = None):
        self.name = name
        self.stall_timeout_s = (
            stall_timeout_s if stall_timeout_s is not None else env_stall_timeout_s()
        )
        self.raise_on_cycle = raise_on_cycle
        #: Schedule-fuzzing "shake" mode: with a seed,
        #: every instrumented acquire/wait/notify may inject a tiny
        #: randomized delay, perturbing the thread schedule so
        #: interleavings the OS scheduler rarely produces get exercised
        #: under the SAME invariant checks.  Per-thread RNGs (seeded
        #: from the shake seed + a per-thread counter) keep the delay
        #: DISTRIBUTION reproducible without cross-thread locking; the
        #: schedule itself is of course still the scheduler's.  None
        #: (default) injects nothing.
        self.shake_seed = shake_seed if shake_seed is not None else env_shake_seed()
        self._shake_local = (
            threading.local() if self.shake_seed is not None else None)
        self._shake_threads = 0
        self.violations: typing.List[Violation] = []
        #: Span tracer hook: every recorded violation lands as an instant
        #: on its "sanitizer" track (set by a traced executor).
        self.tracer: typing.Optional[typing.Any] = None
        self._mu = threading.Lock()
        #: lock name -> owning thread id (while held).
        self._owner: typing.Dict[str, int] = {}
        #: thread id -> lock names currently held, in acquisition order.
        self._held: typing.Dict[int, typing.List[str]] = {}
        #: thread id -> (kind, target name, since monotonic, timed) while
        #: blocked in an instrumented acquire ("lock") or wait ("cond").
        self._waiting: typing.Dict[int, typing.Tuple[str, str, float, bool]] = {}
        #: lock-order graph: edges a -> {b}: b was acquired while a held.
        self._order: typing.Dict[str, typing.Set[str]] = {}
        #: inversions already reported (unordered pair), so one bad pair
        #: logs once, not once per record.
        self._reported_pairs: typing.Set[frozenset] = set()
        # -- protocol state machines --------------------------------------
        #: gate name -> channel indices blocked for barrier alignment.
        self._gate_blocked: typing.Dict[str, typing.Set[int]] = {}
        #: (subtask scope, checkpoint id) -> next expected chain position.
        self._chain_pos: typing.Dict[typing.Tuple[str, int], int] = {}
        # -- cross-process happens-before log -----------------------------
        #: Bounded ring of compact event rows
        #: ``(kind, t_monotonic, edge, conn, seq, args_or_None)``.
        #: Appended lock-free (deque.append is GIL-atomic) from reactor /
        #: writer / source threads; the per-key sequence counters are
        #: single-writer by construction (one thread owns each
        #: (kind, edge, conn) stream), so no mutex rides the hot path.
        self._hb: typing.Deque[tuple] = collections.deque(
            maxlen=hb_capacity if hb_capacity is not None else env_hb_capacity())
        self._hb_seq: typing.Dict[tuple, int] = {}
        #: Total events ever recorded; ``recorded > len(ring)`` in a dump
        #: flags truncation so the stitcher skips prefix-dependent
        #: checks rather than reporting phantom violations.
        self._hb_recorded = 0
        #: Cohort identity (process_index, pid, offset_to_proc0_s,
        #: error_bound_s), set by the distributed executor: the stitcher
        #: orders this log's events on process 0's timebase with it.
        self.cohort_meta: typing.Optional[dict] = None
        #: dump reasons already written (idempotent like the flight
        #: recorder: join after a crash dump must not clobber it).
        self._hb_dumped: typing.Set[str] = set()
        #: observability counters (runtime exposes them as gauges).
        self.progress_ops = 0
        self._watchdog: typing.Optional[threading.Thread] = None
        self._stop = threading.Event()
        #: (tid, since) incidents the watchdog already flagged.
        self._stalled: typing.Set[typing.Tuple[int, float]] = set()

    # -- shake (schedule fuzzing) ------------------------------------------
    def shake(self) -> None:
        """Maybe inject a seeded randomized delay (shake mode only).

        Called from the instrumented wrappers at the points where a
        reordering changes the observable schedule: before a blocking
        acquire, before parking in a wait, and before a notify.  Mostly
        sub-100µs sleeps with an occasional ~1ms one — enough to slide
        threads past each other across the windows where lost-wakeup /
        ordering bugs hide, cheap enough to run whole stress suites."""
        if self._shake_local is None:
            return
        rng = getattr(self._shake_local, "rng", None)
        if rng is None:
            import random

            with self._mu:
                self._shake_threads += 1
                salt = self._shake_threads
            rng = self._shake_local.rng = random.Random(
                self.shake_seed * 1000003 + salt)
        r = rng.random()
        if r < 0.02:
            time.sleep(rng.random() * 1e-3)
        elif r < 0.25:
            time.sleep(rng.random() * 1e-4)

    # -- factories ---------------------------------------------------------
    def lock(self, name: str) -> InstrumentedLock:
        return InstrumentedLock(self, name)

    def condition(self, name: str,
                  lock: typing.Optional[InstrumentedLock] = None) -> InstrumentedCondition:
        return InstrumentedCondition(self, name, lock)

    # -- lock hooks --------------------------------------------------------
    def on_acquiring(self, name: str) -> None:
        """A blocking acquire is about to park: register the wait and
        look for a waits-for cycle through the current owners."""
        tid = threading.get_ident()
        with self._mu:
            self._maybe_start_watchdog()
            self._waiting[tid] = ("lock", name, time.monotonic(), False)
            cycle = self._deadlock_cycle_locked(tid, name)
            if cycle is None:
                return
            dump = self._dump_locked()
            v = Violation(
                kind="deadlock-cycle",
                message=("waits-for cycle: "
                         + " -> ".join(cycle)
                         + f" -> {name} (each lock's owner is blocked on the next)"),
                thread=threading.current_thread().name,
                dump=dump,
            )
            self._record_locked(v)
            self._waiting.pop(tid, None)
        if self.raise_on_cycle:
            raise SanitizerError([v])

    def on_acquired(self, name: str) -> None:
        tid = threading.get_ident()
        with self._mu:
            self.progress_ops += 1
            held = self._held.setdefault(tid, [])
            for prior in held:
                if prior == name:
                    continue
                edge_known = name in self._order.get(prior, ())
                if not edge_known and self._path_exists_locked(name, prior):
                    pair = frozenset((prior, name))
                    if pair not in self._reported_pairs:
                        self._reported_pairs.add(pair)
                        self._record_locked(Violation(
                            kind="lock-order-inversion",
                            message=(f"lock {name!r} acquired while holding "
                                     f"{prior!r}, but the opposite order "
                                     f"{name!r} -> {prior!r} was also observed "
                                     "— a timing-dependent deadlock"),
                            thread=threading.current_thread().name,
                            dump=self._dump_locked(),
                        ))
                self._order.setdefault(prior, set()).add(name)
            held.append(name)
            self._owner[name] = tid

    def on_released(self, name: str) -> None:
        tid = threading.get_ident()
        with self._mu:
            self.progress_ops += 1
            if self._owner.get(name) == tid:
                del self._owner[name]
            held = self._held.get(tid)
            if held and name in held:
                held.remove(name)

    # -- condvar hooks -----------------------------------------------------
    def on_wait_enter(self, name: str, *, timed: bool) -> None:
        tid = threading.get_ident()
        with self._mu:
            self._maybe_start_watchdog()
            self._waiting[tid] = ("cond", name, time.monotonic(), timed)

    def on_wait_exit(self) -> None:
        tid = threading.get_ident()
        with self._mu:
            self.progress_ops += 1
            self._waiting.pop(tid, None)

    def on_notify(self, name: str) -> None:
        with self._mu:
            self.progress_ops += 1

    # -- protocol hooks: barrier alignment ---------------------------------
    def gate_channel_blocked(self, gate: str, idx: int) -> None:
        with self._mu:
            self._gate_blocked.setdefault(gate, set()).add(idx)
        self.hb("align.block", gate, str(idx))

    def gate_unblocked(self, gate: str) -> None:
        with self._mu:
            self._gate_blocked.pop(gate, None)
        self.hb("align.unblock", gate)

    def gate_delivered(self, gate: str, idx: int) -> None:
        """An element left the gate toward the operator on channel
        ``idx`` — a protocol violation if that channel is blocked for a
        barrier alignment (the element overtook the checkpoint cut)."""
        with self._mu:
            self.progress_ops += 1
            if idx in self._gate_blocked.get(gate, ()):
                self._record_locked(Violation(
                    kind="barrier-blocked-channel",
                    message=(f"gate {gate!r} delivered an element from "
                             f"channel {idx} while that channel is blocked "
                             "for barrier alignment — the record overtakes "
                             "the checkpoint cut and breaks exactly-once"),
                    thread=threading.current_thread().name,
                ))

    # -- protocol hooks: chain snapshot order ------------------------------
    def chain_snapshot(self, scope: str, checkpoint_id: int,
                       position: int, chain_len: int) -> None:
        """Subtask ``scope`` snapshots its chain member at ``position``
        (0 = head) for ``checkpoint_id``.  Order must be exactly
        0, 1, ..., chain_len-1 — snapshot order equals stream order."""
        key = (scope, checkpoint_id)
        with self._mu:
            self.progress_ops += 1
            expected = self._chain_pos.get(key, 0)
            if position != expected:
                self._record_locked(Violation(
                    kind="snapshot-order",
                    message=(f"subtask {scope!r} snapshot chain position "
                             f"{position} for checkpoint {checkpoint_id}, "
                             f"expected {expected} — snapshot order must "
                             "match chain stream order (head to tail, no "
                             "gaps)"),
                    thread=threading.current_thread().name,
                ))
            if position + 1 >= chain_len:
                self._chain_pos.pop(key, None)
            else:
                self._chain_pos[key] = position + 1

    # -- protocol hooks: split assignment freeze ---------------------------
    def split_dispensed(self, source: str, *, frozen: bool) -> None:
        with self._mu:
            self.progress_ops += 1
            if frozen:
                self._record_locked(Violation(
                    kind="assignment-freeze",
                    message=(f"split source {source!r} dispensed a split "
                             "while assignment is frozen for barrier "
                             "alignment — the enumerator-pool snapshot can "
                             "no longer be consistent with the readers' "
                             "in-flight-split snapshots"),
                    thread=threading.current_thread().name,
                ))

    # -- cross-process happens-before log ----------------------------------
    def hb(self, kind: str, edge: str = "", conn: str = "",
           **args: typing.Any) -> int:
        """Append one happens-before event; returns this event's
        per-(kind, edge, conn) sequence number.

        Event vocabulary (the stitcher's contract — see
        core/sanitizer_stitch.py):

        - ``frame.send`` / ``frame.recv`` — one wire frame left / hit an
          edge's transport (args: fc class, bytes, in-frame barrier ids);
        - ``frame.deliver`` — a route put records into its input gate
          (args: gate, ch, data flag) — the event the alignment and
          epoch-fence checks key on;
        - ``frame.stale_drop`` — a zombie epoch's frame was fenced;
        - ``epoch.handshake`` — either end of a record-plane connection
          (args: role, epoch, server_epoch, stale, gate);
        - ``credit.grant`` / ``credit.recv_grant`` / ``credit.spend`` /
          ``credit.park`` / ``credit.unpark`` — the flow-control ledger,
          generation-tagged;
        - ``gate.full`` / ``gate.resume`` — receiver-side backpressure
          transitions (the deadlock check's receiver half);
        - ``barrier.inject`` — a source emitted a checkpoint barrier;
        - ``align.block`` / ``align.unblock`` — barrier-alignment windows
          (recorded by the gate hooks above).

        Lock-free: one dict bump and one deque append, and the hook sites
        keep their single is-None guard when the sanitizer is off.
        """
        key = (kind, edge, conn)
        seq = self._hb_seq.get(key, 0)
        self._hb_seq[key] = seq + 1
        self._hb.append(
            (kind, time.monotonic(), edge, conn, seq, args or None))
        self._hb_recorded += 1
        return seq

    @property
    def hb_events(self) -> int:
        """Events currently held in the ring."""
        return len(self._hb)

    @property
    def hb_recorded(self) -> int:
        """Events ever recorded (>= hb_events once the ring wraps)."""
        return self._hb_recorded

    @property
    def hb_dropped(self) -> int:
        """Events lost to ring truncation."""
        return max(0, self._hb_recorded - len(self._hb))

    def dump_hb_log(self, path: typing.Optional[str], reason: str,
                    *, extra: typing.Optional[dict] = None
                    ) -> typing.Optional[str]:
        """Write the happens-before log (+ any recorded violations) as
        one JSON document — atomic tmp+replace, idempotent per reason
        like the flight recorder.  Returns the path written (or already
        written for this reason), None when no path is configured."""
        if not path:
            return None
        if reason in self._hb_dumped:
            return path
        self._hb_dumped.add(reason)
        events = [list(ev) for ev in list(self._hb)]
        recorded = self._hb_recorded
        doc = {
            "kind": HB_LOG_KIND,
            "version": 1,
            "name": self.name,
            "pid": os.getpid(),
            "reason": reason,
            "wall_time": time.time(),
            "cohort": self.cohort_meta,
            "recorded": recorded,
            "truncated": recorded > len(events),
            "violations": [
                {"kind": v.kind, "message": v.message, "thread": v.thread}
                for v in self.violations
            ],
            "events": events,
        }
        if extra:
            doc["extra"] = extra
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        except OSError as exc:
            logger.warning("sanitizer hb-log dump to %s failed: %s", path, exc)
            self._hb_dumped.discard(reason)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None
        logger.info("sanitizer[%s] happens-before log (%d events%s) "
                    "dumped to %s (reason: %s)", self.name, len(events),
                    ", truncated" if doc["truncated"] else "", path, reason)
        return path

    # -- recording / reporting ---------------------------------------------
    def _record_locked(self, v: Violation) -> None:
        self.violations.append(v)
        logger.error("sanitizer violation %s%s", v.format(),
                     f"\n{v.dump}" if v.dump else "")
        if self.tracer is not None:
            # Timeline marker: the tracer writes to the CALLING thread's
            # own ring (no lock), so recording under self._mu is safe.
            args = {"message": v.message, "thread": v.thread}
            if v.dump:
                args["dump"] = v.dump
            self.tracer.instant("sanitizer", v.kind, args=args)

    def check(self) -> None:
        """Raise :class:`SanitizerError` if any violation was recorded."""
        if self.violations:
            raise SanitizerError(self.violations)

    def report(self) -> str:
        if not self.violations:
            return f"sanitizer[{self.name}]: clean ({self.progress_ops} tracked ops)"
        return "\n".join(v.format() for v in self.violations)

    def dump_state(self) -> str:
        with self._mu:
            return self._dump_locked()

    def shutdown(self) -> None:
        self._stop.set()

    # -- internals (caller holds self._mu) ---------------------------------
    def _path_exists_locked(self, src: str, dst: str) -> bool:
        """DFS reachability src -> dst in the lock-order graph."""
        stack, seen = [src], {src}
        while stack:
            cur = stack.pop()
            if cur == dst:
                return True
            for nxt in self._order.get(cur, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
        return False

    def _deadlock_cycle_locked(
        self, tid: int, name: str
    ) -> typing.Optional[typing.List[str]]:
        """Follow owner -> waited-lock -> owner from ``name``; a chain
        that ends at ``tid`` is a real waits-for deadlock cycle."""
        path = [name]
        owner = self._owner.get(name)
        seen_threads: typing.Set[int] = set()
        while owner is not None and owner != tid:
            if owner in seen_threads:
                return None  # a cycle, but not through us
            seen_threads.add(owner)
            wait = self._waiting.get(owner)
            if wait is None or wait[0] != "lock":
                return None
            path.append(wait[1])
            owner = self._owner.get(wait[1])
        return path if owner == tid else None

    def _dump_locked(self) -> str:
        """All thread stacks + lock ownership + wait map — the stall /
        deadlock post-mortem payload."""
        lines = [f"=== sanitizer[{self.name}] state dump ==="]
        lines.append("lock owners: " + (
            ", ".join(f"{n} -> tid {t}" for n, t in sorted(self._owner.items()))
            or "(none held)"))
        for tid, (kind, target, since, timed) in sorted(self._waiting.items()):
            lines.append(
                f"tid {tid}: waiting ({kind}{'' if timed else ', UNTIMED'}) on "
                f"{target!r} for {time.monotonic() - since:.3f}s")
        names = {t.ident: t.name for t in threading.enumerate()}
        for tid, frame in sys._current_frames().items():
            lines.append(f"--- thread {names.get(tid, '?')} (tid {tid}) ---")
            lines.append("".join(traceback.format_stack(frame)).rstrip())
        return "\n".join(lines)

    # -- stall watchdog ----------------------------------------------------
    def _maybe_start_watchdog(self) -> None:
        """Start the watchdog lazily at the first tracked wait (caller
        holds ``self._mu``) — a sanitizer that never parks never needs
        one."""
        if (self.stall_timeout_s is None or self._watchdog is not None
                or self._stop.is_set()):
            return
        self._watchdog = threading.Thread(
            target=self._watchdog_loop, name=f"sanitizer-watchdog[{self.name}]",
            daemon=True,
        )
        self._watchdog.start()

    def _watchdog_loop(self) -> None:
        budget = self.stall_timeout_s
        interval = max(0.01, min(budget / 4.0, 1.0))
        while not self._stop.wait(interval):
            now = time.monotonic()
            with self._mu:
                for tid, (kind, target, since, timed) in list(self._waiting.items()):
                    if timed or now - since < budget:
                        continue  # a timed wait always wakes itself
                    incident = (tid, since)
                    if incident in self._stalled:
                        continue
                    self._stalled.add(incident)
                    self._record_locked(Violation(
                        kind="stall",
                        message=(f"thread tid {tid} has been parked in an "
                                 f"untimed {kind} wait on {target!r} for "
                                 f"{now - since:.3f}s (> {budget}s) with no "
                                 "wakeup — lost-wakeup / missing-notify "
                                 "suspect; full stack + ownership dump "
                                 "attached"),
                        thread=f"tid-{tid}",
                        dump=self._dump_locked(),
                    ))
