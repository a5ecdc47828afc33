"""Span tracer — Dapper-style per-batch tracing for the streaming runtime.

Port of ``flink_tensorflow_tpu/tracing/tracer.py``, kept equal to it (the
same admission stride, event tuples and Chrome export; the tests hold
both packages to the same events).  The metrics plane answers "how much,
on aggregate"; this module answers "WHERE did this batch's time go".  A :class:`Tracer` records
spans (complete events with a start and a duration) and instants on
named **tracks** — one track per operator subtask / chain, plus
job-level tracks (``checkpoint``, ``sanitizer``) — into per-thread ring
buffers, and exports them as Chrome Trace Event Format JSON loadable in
Perfetto (``ui.perfetto.dev``) or ``chrome://tracing``.

Zero-cost when off: nothing here is constructed unless
``JobConfig(trace=True)`` or ``FLINK_TPU_TRACE=1``; every runtime hook
is guarded by a single ``is None`` test, and the off path performs no
allocation attributable to this package (tier-1 guard in
tests/test_tracing.py).

Context propagation: a sampled record carries a :class:`TraceContext`
on its :class:`~flink_tensorflow_tpu_torch.core.elements.StreamRecord`
through channel queues and rides thread-locally through
:class:`ChainedOutput` direct calls.  A ``__trace__`` entry in a
TensorValue's metadata continues an upstream trace at admission (a
traced ``RemoteSink`` writes it; the record plane carries the context
itself, in every frame shape).

Cross-process spans: monotonic clocks don't agree between processes, so
a foreign enqueue stamp is only usable once a clock-offset exchange
(tracing/clocksync.py, run by ``core/cohort_telemetry.py``, which calls
:meth:`Tracer.set_clock_offset`) has told this tracer the origin's
offset — from then
on ``queue``/``wire`` spans are recorded OFFSET-CORRECTED into the
local timebase (clamped so estimation error can never produce a
negative duration) instead of suppressed, and ``flink-tpu-trace
--cohort`` merges the per-process trace files into one Perfetto
timeline on the process-0 clock.  Before the offsets arrive (or on a
non-cohort job) the old suppression applies: the trace id still
survives, so one logical record is one trace cluster either way.

One clock with the device trace: spans are on ``time.monotonic()``, and
``torch.profiler``'s events are in Unix nanoseconds.  A tracer reads a
clock anchor (the two clocks read back to back, the tightest of a few
readings kept) when it is made and again at each :meth:`Tracer.events`
and export; :meth:`Tracer.to_unix_ns` places a span's stamp on the
profiler's clock, and the Chrome export carries the anchor as its
``clock`` block, so ``utils/profiling.trace(..., tracer=...)`` can write
the spans into the profiler's own ``trace.json``.

Sampling is **head-based and deterministic**: the admission decision is
made once, at the source, by a per-track counter stride derived from
``(sample_rate, seed)`` — two runs of the same seeded job sample the
identical records, and everything downstream simply honors the carried
context (no per-hop coin flips).
"""

from __future__ import annotations

import json
import os
import threading
import time
import typing

_TRUTHY = ("1", "true", "on", "yes")

#: Cached at import: cross-process records (pickled shuffle frames)
#: carry their origin pid so receivers can tell a foreign monotonic
#: timestamp from a local one.
_PID = os.getpid()


#: Readings taken for one clock anchor; the tightest is kept.
ANCHOR_READINGS = 5


def tightest(read: typing.Callable[[], tuple], n: int = ANCHOR_READINGS) -> tuple:
    """Of ``n`` readings ``read()``, each a tuple whose last item is the
    host seconds it took to read, the one read in the least time."""
    return min((read() for _ in range(n)), key=lambda r: r[-1])


def _read_unix() -> typing.Tuple[float, int, float]:
    a = time.monotonic()
    unix_ns = time.time_ns()
    b = time.monotonic()
    return 0.5 * (a + b), unix_ns, b - a


def clock_anchor() -> typing.Tuple[float, int]:
    """``(monotonic seconds, Unix ns)`` read at one instant: the
    :func:`tightest` reading of ``time.time_ns()`` between two monotonic
    stamps, placed at their middle."""
    mono, unix_ns, _ = tightest(_read_unix)
    return mono, unix_ns


def env_enabled() -> bool:
    """Whether ``FLINK_TPU_TRACE`` force-enables tracing."""
    return os.environ.get("FLINK_TPU_TRACE", "").lower() in _TRUTHY


def env_trace_path() -> typing.Optional[str]:
    return os.environ.get("FLINK_TPU_TRACE_PATH") or None


def env_sample_rate() -> typing.Optional[float]:
    raw = os.environ.get("FLINK_TPU_TRACE_SAMPLE")
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        return None


class TraceContext:
    """Identity of one sampled record as it moves through the pipeline.

    ``origin`` is the pid that minted the context: ``t_queue`` stamps are
    monotonic-clock readings and only comparable within that process.
    Plain slots => pickles along with the StreamRecord over shuffle
    frames (protocol 2+ handles slots natively)."""

    __slots__ = ("trace_id", "origin", "t_queue")

    def __init__(self, trace_id: int, origin: int = 0, t_queue: float = 0.0):
        self.trace_id = trace_id
        self.origin = origin
        self.t_queue = t_queue

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"TraceContext(id={self.trace_id:#x}, origin={self.origin})"


class _Ring:
    """Bounded per-thread event buffer: append is lock-free (single
    writer — the owning thread), overwrite-oldest on overflow so a long
    job's trace holds the most recent window instead of OOMing."""

    __slots__ = ("buf", "cap", "n")

    def __init__(self, cap: int):
        self.buf: typing.List[tuple] = []
        self.cap = cap
        self.n = 0

    def append(self, ev: tuple) -> None:
        if len(self.buf) < self.cap:
            self.buf.append(ev)
        else:
            self.buf[self.n % self.cap] = ev
        self.n += 1


def events_to_chrome(events: typing.Sequence[tuple], *,
                     epoch: float = 0.0,
                     process_name: str = "flink-tensorflow-tpu job") -> dict:
    """Fold ``(track, name, ph, t0, dur, args)`` event tuples into a
    Chrome Trace Event dict — the shared exporter behind
    :meth:`Tracer.chrome_trace`, the flight-recorder replay, and the
    cohort stitcher."""
    tracks = sorted({ev[0] for ev in events})
    tid_of = {track: i + 1 for i, track in enumerate(tracks)}
    trace_events: typing.List[dict] = [{
        "ph": "M", "pid": 1, "tid": 0, "name": "process_name",
        "args": {"name": process_name},
    }]
    for track, tid in tid_of.items():
        trace_events.append({
            "ph": "M", "pid": 1, "tid": tid, "name": "thread_name",
            "args": {"name": track},
        })
        trace_events.append({
            "ph": "M", "pid": 1, "tid": tid, "name": "thread_sort_index",
            "args": {"sort_index": tid},
        })
    for track, name, ph, t0, dur, args in events:
        ev: typing.Dict[str, typing.Any] = {
            "ph": ph, "pid": 1, "tid": tid_of[track], "name": name,
            "ts": round((t0 - epoch) * 1e6, 3),
        }
        if ph == "X":
            ev["dur"] = round(dur * 1e6, 3)
        else:
            ev["s"] = "t"
        if args:
            ev["args"] = args
        trace_events.append(ev)
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


class Tracer:
    """One per traced job.  Thread-safe by construction: every thread
    records into its own ring; the only locks guard ring registration
    (once per thread) and the admission counters (once per record, at
    the source only)."""

    def __init__(self, *, sample_rate: float = 1.0,
                 seed: typing.Optional[int] = None,
                 ring_capacity: int = 1 << 16):
        if not (0.0 < sample_rate <= 1.0):
            raise ValueError(f"sample_rate must be in (0, 1], got {sample_rate}")
        self.sample_rate = sample_rate
        self.seed = seed or 0
        #: Admission stride: every ``period``-th record per track is
        #: sampled (head-based); the seed phases the stride so seeded
        #: runs are reproducible but not all locked to record 0.
        self._period = max(1, round(1.0 / sample_rate))
        self.ring_capacity = ring_capacity
        self._tls = threading.local()
        self._rings: typing.List[_Ring] = []
        self._rings_lock = threading.Lock()
        self._admit_lock = threading.Lock()
        self._admit_counts: typing.Dict[str, int] = {}
        self._next_id = 0
        #: Monotonic epoch: exported timestamps are relative to this.
        self.epoch = time.monotonic()
        #: Cohort clock sync (tracing/clocksync.py): origin pid -> offset
        #: that maps that process's monotonic readings into THIS clock
        #: (t_local = t_origin + offset).  Plain dict swaps — readers on
        #: record paths only ever .get(); writers replace entries whole.
        self.clock_offsets: typing.Dict[int, float] = {}
        self.clock_error: typing.Dict[int, float] = {}
        #: Cohort identity recorded into the Chrome export so
        #: ``flink-tpu-trace --cohort`` can shift this file onto the
        #: process-0 timebase: {"process_index", "pid",
        #: "offset_to_proc0_s", "error_bound_s", "epoch_monotonic_s"}.
        self.cohort_meta: typing.Optional[dict] = None
        #: ``(monotonic s, Unix ns)`` at one instant (:func:`clock_anchor`),
        #: read again at each :meth:`events` and export.
        self.clock = clock_anchor()

    # -- recording (hot path when ON) -----------------------------------
    def _ring(self) -> _Ring:
        ring = getattr(self._tls, "ring", None)
        if ring is None:
            ring = _Ring(self.ring_capacity)
            self._tls.ring = ring
            with self._rings_lock:
                self._rings.append(ring)
        return ring

    def span(self, track: str, name: str, t0: float, t1: float,
             args: typing.Optional[dict] = None) -> None:
        """Record a complete event [t0, t1) (monotonic seconds) on ``track``."""
        self._ring().append((track, name, "X", t0, t1 - t0, args))

    def instant(self, track: str, name: str,
                ts: typing.Optional[float] = None,
                args: typing.Optional[dict] = None) -> None:
        self._ring().append(
            (track, name, "i", ts if ts is not None else time.monotonic(),
             0.0, args))

    # -- trace context ---------------------------------------------------
    def admit(self, track: str, value: typing.Any) -> typing.Optional[TraceContext]:
        """Head-based admission at a source: returns a fresh context when
        this record is sampled, else None.  A record arriving over a
        remote edge with a ``__trace__`` meta entry CONTINUES that trace
        (the upstream made the sampling decision)."""
        meta = getattr(value, "meta", None)
        if meta is not None:
            inherited = meta.pop("__trace__", None)
            if inherited is not None:
                if type(inherited) is tuple:
                    # io/remote edge carrying (trace_id, origin_pid,
                    # t_send): with a known clock offset the remote
                    # hop's wait becomes an offset-corrected queue span
                    # on the admitting track; unsynced origins keep the
                    # id and drop the stamp (the old suppression).
                    trace_id, origin, t_send = inherited
                    off = self.clock_offsets.get(origin)
                    if off is not None and t_send:
                        now = time.monotonic()
                        self.span(track, "queue", min(now, t_send + off),
                                  now, args={"trace": trace_id,
                                             "origin": origin})
                    return TraceContext(trace_id, _PID)
                return TraceContext(inherited, _PID)
        with self._admit_lock:
            n = self._admit_counts.get(track, 0)
            self._admit_counts[track] = n + 1
            if (n + self.seed) % self._period != 0:
                return None
            self._next_id += 1
            trace_id = (_PID << 24) | (self._next_id & 0xFFFFFF)
        return TraceContext(trace_id, _PID)

    @staticmethod
    def fork(ctx: TraceContext, t_queue: float) -> TraceContext:
        """Per-emission copy: same trace id, fresh enqueue stamp (the
        downstream queue span measures t_queue -> delivery)."""
        return TraceContext(ctx.trace_id, ctx.origin, t_queue)

    def current(self) -> typing.Optional[TraceContext]:
        return getattr(self._tls, "ctx", None)

    def set_current(self, ctx: typing.Optional[TraceContext]) -> None:
        self._tls.ctx = ctx

    def set_clock_offset(self, pid: int, offset_s: float,
                         error_s: float = 0.0) -> None:
        """Register peer ``pid``'s monotonic-clock offset into THIS
        clock (t_local = t_peer + offset_s) — from now on that origin's
        queue/wire stamps record as offset-corrected spans."""
        self.clock_offsets[pid] = offset_s
        self.clock_error[pid] = error_s

    def queue_span(self, track: str, ctx: TraceContext, now: float) -> None:
        """The queue-wait span for a delivered record: enqueue -> dequeue.
        A context minted on a peer process carries a foreign monotonic
        ``t_queue``: with a known clock offset for the origin it records
        offset-corrected (clamped into [.., now] so estimation error
        cannot yield a negative duration); without one it is suppressed
        exactly as before the cohort sync existed."""
        if not ctx.t_queue:
            return
        if ctx.origin == _PID:
            self.span(track, "queue", ctx.t_queue, now,
                      args={"trace": ctx.trace_id})
            return
        off = self.clock_offsets.get(ctx.origin)
        if off is not None:
            self.span(track, "queue", min(now, ctx.t_queue + off), now,
                      args={"trace": ctx.trace_id, "origin": ctx.origin})

    # -- the clock shared with the device trace --------------------------
    def to_unix_ns(self, t: float) -> int:
        """The monotonic stamp ``t`` in Unix nanoseconds, the clock of
        ``torch.profiler``'s events."""
        mono, unix_ns = self.clock
        return unix_ns + round((t - mono) * 1e9)

    def clock_meta(self) -> dict:
        """The export's ``clock`` block: a span's Unix time is
        ``epoch_unix_ns + ts * 1000`` (``ts`` in microseconds)."""
        mono, unix_ns = self.clock
        return {"epoch_monotonic_s": self.epoch, "epoch_unix_ns": self.to_unix_ns(self.epoch),
                "anchor_monotonic_s": mono, "anchor_unix_ns": unix_ns}

    # -- export ----------------------------------------------------------
    def events(self) -> typing.List[tuple]:
        """All recorded events, merged across threads, time-ordered:
        ``(track, name, ph, t0, dur, args)`` with monotonic seconds."""
        self.clock = clock_anchor()
        with self._rings_lock:
            rings = list(self._rings)
        out: typing.List[tuple] = []
        for ring in rings:
            out.extend(ring.buf)
        out.sort(key=lambda ev: ev[3])
        return out

    def dropped(self) -> int:
        with self._rings_lock:
            return sum(max(0, r.n - r.cap) for r in self._rings)

    def chrome_trace(self) -> dict:
        """Chrome Trace Event Format (the JSON object form) — loadable
        in Perfetto / chrome://tracing.  One named thread per track,
        complete ("X") events for spans, thread-scoped instants ("i")
        for barriers / watermarks / sanitizer findings.  A cohort
        tracer's export carries its ``cohort`` block (process index, pid,
        clock offset, epoch) so ``flink-tpu-trace --cohort`` can merge
        per-process files onto one timebase.  Its ``clock`` block places
        ``ts`` on the Unix clock (:meth:`clock_meta`)."""
        trace = events_to_chrome(self.events(), epoch=self.epoch)
        trace["clock"] = self.clock_meta()
        if self.cohort_meta is not None:
            meta = dict(self.cohort_meta)
            meta.setdefault("epoch_monotonic_s", self.epoch)
            trace["cohort"] = meta
        return trace

    def export(self, path: str) -> str:
        """Write the Chrome trace JSON atomically (tmp + rename); returns
        the path.  Idempotent — a later call rewrites with more events."""
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.chrome_trace(), f)
        os.replace(tmp, path)
        return path
