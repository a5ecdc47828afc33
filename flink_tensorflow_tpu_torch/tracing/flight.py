"""Flight recorder — a cheap always-on ring of recent runtime events.

Tracing (``trace=True``) prices per-record spans and is therefore
opt-in; the flight recorder is the black box that is on by DEFAULT
(``JobConfig.flight_recorder``): a bounded per-process ring of recent
CONTROL-RATE events — job/subtask lifecycle, barrier injections and
snapshots, failures, and per-report metric deltas — recorded at a cost
bounded by one tuple append (``chip_smoke.py`` prices it next to
``span_record_ns``).  Port of ``flink_tensorflow_tpu/tracing/flight.py``
with the same dump format, so each package loads the other's dumps.
When something goes wrong the ring is dumped to disk:

- **crash** — the first subtask failure (with the crash-time reporter
  flush);
- **sanitizer violation** — ``join()`` dumps before re-raising;
- **signal** — SIGTERM/SIGINT land a dump (and a reporter flush)
  before the previous handler runs, so a killed worker keeps its last
  interval;
- **cancel** — ``JobHandle.cancel`` dumps explicitly.

Dumps are JSON (``{"kind": "flink-tpu-flight", ...}``) holding the
flight events in the tracer's ``(track, name, ph, t0, dur, args)``
tuple shape — plus, when tracing was on, the tracer's own recent ring —
so ``flink-tpu-trace --from-flight-dump`` replays one through the
standard attribution table and Chrome-trace export.

Disk writes only happen when a dump PATH is configured
(``JobConfig.flight_path`` / ``FLINK_TPU_FLIGHT_PATH``); the in-memory
ring itself always runs unless disabled (``flight_recorder=False`` /
``FLINK_TPU_FLIGHT=0`` — the zero-alloc off path, tier-1 guarded).
"""

from __future__ import annotations

import collections
import json
import os
import signal
import threading
import time
import typing

_TRUTHY = ("1", "true", "on", "yes")


def env_enabled() -> typing.Optional[bool]:
    """FLINK_TPU_FLIGHT: force the recorder on/off; None = unset."""
    v = os.environ.get("FLINK_TPU_FLIGHT")
    if v is None or v == "":
        return None
    return v.lower() in _TRUTHY


def env_flight_path() -> typing.Optional[str]:
    return os.environ.get("FLINK_TPU_FLIGHT_PATH") or None


class FlightRecorder:
    """Bounded ring of recent events + metric deltas.

    ``record`` is the hot(ish) entry point — one clock read and one
    deque append, safe from any thread (CPython deque appends are
    atomic) — but its callers are all CONTROL-RATE sites: checkpoints,
    lifecycle transitions, reporter ticks.  The ring never grows past
    ``capacity``; a long job keeps the most recent window, exactly the
    part a post-mortem needs.
    """

    def __init__(self, capacity: int = 4096):
        self._ring: typing.Deque[tuple] = collections.deque(maxlen=capacity)
        self.capacity = capacity
        self._last_counts: typing.Dict[str, typing.Any] = {}
        self._dump_lock = threading.Lock()
        #: Reasons already dumped (a crash dump and a signal dump may
        #: both fire; each reason lands once).
        self.dumped: typing.List[str] = []

    # -- recording -------------------------------------------------------
    def record(self, track: str, name: str,
               args: typing.Optional[dict] = None, *,
               t0: typing.Optional[float] = None, dur: float = 0.0) -> None:
        self._ring.append((track, name, "X" if dur else "i",
                           time.monotonic() if t0 is None else t0,
                           dur, args))

    def metric_delta(self, snapshot: typing.Mapping[str, typing.Mapping[str, typing.Any]]) -> None:
        """Fold one reporter snapshot into compact per-scope delta
        events: records in/out movement since the previous report.  One
        instant per ACTIVE scope per report — bounded by scope count,
        not record rate."""
        now = time.monotonic()
        for scope in snapshot:
            m = snapshot[scope]
            rec_in = (m.get("records_in") or {})
            rec_out = (m.get("records_out") or {})
            counts = (rec_in.get("count", 0), rec_out.get("count", 0))
            prev = self._last_counts.get(scope, (0, 0))
            if counts == prev:
                continue
            self._last_counts[scope] = counts
            self._ring.append((scope, "metrics.delta", "i", now, 0.0, {
                "records_in": counts[0] - prev[0],
                "records_out": counts[1] - prev[1],
                "queue_depth": m.get("queue_depth"),
            }))

    def events(self) -> typing.List[tuple]:
        return list(self._ring)

    # -- dumping ---------------------------------------------------------
    def dump(self, path: str, reason: str, *,
             tracer: typing.Optional[typing.Any] = None,
             extra: typing.Optional[dict] = None) -> typing.Optional[str]:
        """Write the ring (and, when tracing was on, the tracer's recent
        events + cohort metadata) to ``path`` atomically.  Idempotent
        per reason; best-effort — a full disk must never mask the
        failure being recorded.  Returns the path written, or None."""
        with self._dump_lock:
            if reason in self.dumped:
                return None
            self.dumped.append(reason)
        doc: typing.Dict[str, typing.Any] = {
            "kind": "flink-tpu-flight",
            "reason": reason,
            "pid": os.getpid(),
            "monotonic_s": time.monotonic(),
            "wall_time_s": time.time(),
            "events": [list(ev) for ev in self._ring],
        }
        if tracer is not None:
            doc["tracer_events"] = [list(ev) for ev in tracer.events()]
            doc["tracer_epoch_s"] = tracer.epoch
            if tracer.cohort_meta is not None:
                doc["cohort"] = dict(tracer.cohort_meta)
        if extra:
            doc["extra"] = extra
        try:
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        except OSError:
            import logging

            logging.getLogger(__name__).warning(
                "flight-recorder dump to %s failed", path, exc_info=True)
            return None
        return path


def load_flight_dump(path: str) -> dict:
    """Parse a dump back into event-tuple form: ``events`` /
    ``tracer_events`` become the tracer's ``(track, name, ph, t0, dur,
    args)`` tuples, time-ordered — ready for attribution or
    ``events_to_chrome``."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("kind") != "flink-tpu-flight":
        raise ValueError(f"{path} is not a flight-recorder dump")
    for key in ("events", "tracer_events"):
        if key in doc:
            doc[key] = sorted(
                (tuple(ev) for ev in doc[key]), key=lambda ev: ev[3])
    return doc


def flight_dump_to_chrome(doc: dict) -> dict:
    """A dump as a Perfetto-loadable Chrome trace (flight events and,
    when present, the tracer's spans on their own tracks)."""
    from flink_tensorflow_tpu_torch.tracing.tracer import events_to_chrome

    events = list(doc.get("events", ())) + list(doc.get("tracer_events", ()))
    events.sort(key=lambda ev: ev[3])
    epoch = doc.get("tracer_epoch_s")
    if epoch is None:
        epoch = min((ev[3] for ev in events), default=0.0)
    trace = events_to_chrome(
        events, epoch=epoch,
        process_name=f"flight dump ({doc.get('reason', '?')})")
    if "cohort" in doc:
        trace["cohort"] = doc["cohort"]
    return trace


class ShutdownFlusher:
    """SIGTERM/SIGINT hook: run the registered flush callbacks (reporter
    flush, flight dump, trace export), then hand control back to the
    PREVIOUS handler so process semantics are unchanged — a killed
    worker still dies, it just stops losing its final reporting
    interval.  Installable only from the main thread (signal module
    contract); elsewhere ``install`` is a no-op returning False."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, callbacks: typing.Sequence[typing.Callable[[], None]]):
        self.callbacks = list(callbacks)
        self._prev: typing.Dict[int, typing.Any] = {}
        self._installed = False

    def _handler(self, signum, frame) -> None:
        self.flush()
        prev = self._prev.get(signum)
        self.uninstall()
        if callable(prev):
            prev(signum, frame)
        elif prev != signal.SIG_IGN:
            # Re-deliver with default disposition (terminate / KeyboardInterrupt).
            signal.raise_signal(signum)

    def flush(self) -> None:
        for cb in self.callbacks:
            try:
                cb()
            except Exception:  # noqa: BLE001 — observability only
                import logging

                logging.getLogger(__name__).warning(
                    "shutdown flush callback failed", exc_info=True)

    def install(self) -> bool:
        if self._installed or threading.current_thread() is not threading.main_thread():
            return False
        try:
            for sig in self.SIGNALS:
                self._prev[sig] = signal.getsignal(sig)
                signal.signal(sig, self._handler)
        except (ValueError, OSError):  # non-main thread / exotic platform
            self.uninstall()
            return False
        self._installed = True
        return True

    def uninstall(self) -> None:
        if not self._installed:
            return
        self._installed = False
        for sig, prev in self._prev.items():
            try:
                if signal.getsignal(sig) == self._handler:
                    signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev.clear()
