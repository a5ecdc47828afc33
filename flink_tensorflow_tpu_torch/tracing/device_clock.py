"""Device time from the program's own CUDA events, on the tracer's clock.

A CUDA timing event records when its stream reaches it: when all the work
queued before it on that stream has finished, or, on a stream with nothing
queued, when the device takes the event up.  So an event recorded just
before a batch's (or a train step's) first device work and one after its
last give the batch's extent on the device, and the time from the end
reached latest to the next start is time the stream sat idle.

:class:`DeviceClock` places such events on ``time.monotonic()``, the clock
of the tracer's spans, through an *anchor*: an event recorded on a stream
of its own and waited for, between two host stamps.  The clock keeps the
tightest of a few readings when it is made (``tracer.tightest``, as the
tracer's own anchor against the Unix clock) and reads a new anchor at least
once a second while events are placed, so the device clock's drift against
the host's stays far under a millisecond; a reading whose host stamps lie
more than :data:`MAX_BRACKET_S` apart (the thread was descheduled or
waited for the interpreter lock) is refused and the last one kept.
Lengths come from ``elapsed_time`` between the events themselves, on the
device's clock; the anchor only places them.

:class:`StreamTimeline` follows one stream's intervals in the order they
are read and gives the idle time before each and the device time each
adds to the union of those before it (intervals overlap where two lanes
launch onto one stream, so a sum would count the overlap twice); :func:`host_stages` says
which of the host's stage spans that idle time fell in; :func:`tile` cuts
consecutive stamps into spans.  The arithmetic takes any events with an
``elapsed_time`` method, so it is tested on the CPU with synthetic stamps.

:func:`place` records a ``device`` span per interval on ``<track>.device``
and, after an idle stream, a ``device.idle`` span whose ``host`` arg names
the host's stage when the stream went idle and whose ``stages`` arg splits
the idle time by stage.  :class:`StepProbe` carries CUDA events and
device-side counts into a model's step and reads them after the step's
sync.  Nothing here is built unless the job is traced.
"""

from __future__ import annotations

import contextlib
import time
import typing

from flink_tensorflow_tpu_torch.tracing.tracer import tightest

#: Seconds between anchor readings while events are being placed.
REANCHOR_S = 1.0
#: The widest host bracket (record to the wait's return) an anchor
#: reading may have; a wider one is refused.
MAX_BRACKET_S = 1e-3
#: Idle time shorter than this records no ``device.idle`` span (two
#: events the stream takes back to back lie a few microseconds apart); the
#: histograms take every gap as it is.
IDLE_SPAN_MIN_S = 1e-5

#: ``() -> (event, monotonic seconds, bracket seconds)``.
AnchorReader = typing.Callable[[], typing.Tuple[typing.Any, float, float]]
#: ``(name, start, end)`` on the host's monotonic clock.
Span = typing.Tuple[str, float, float]


def elapsed_s(a, b) -> float:
    """Seconds from event ``a`` to event ``b`` on the device's clock."""
    return a.elapsed_time(b) / 1e3


class DeviceClock:
    """Places completed CUDA timing events on ``time.monotonic()``."""

    def __init__(self, read_anchor: AnchorReader):
        self._read = read_anchor
        event, t, _ = tightest(read_anchor)
        self._anchor, self._t_anchor = event, t
        self._due = t + REANCHOR_S

    @classmethod
    def on(cls, device) -> "DeviceClock":
        """A clock for ``device`` (CUDA), anchored on a stream of its own,
        which nothing else uses, so an anchor's wait is for the anchor
        alone."""
        import torch

        stream = torch.cuda.Stream(device)

        def read():
            event = torch.cuda.Event(enable_timing=True)
            a = time.monotonic()
            event.record(stream)
            event.synchronize()
            b = time.monotonic()
            return event, 0.5 * (a + b), b - a

        return cls(read)

    @staticmethod
    def record(stream=None):
        """A timing event recorded now on ``stream`` (default: the
        current stream)."""
        import torch

        event = torch.cuda.Event(enable_timing=True)
        event.record(stream)
        return event

    def reanchor(self, now: typing.Optional[float] = None) -> None:
        """Read a new anchor if the last is :data:`REANCHOR_S` old; keep
        the last where the reading's bracket is too wide."""
        if (time.monotonic() if now is None else now) < self._due:
            return
        event, t, bracket = self._read()
        if bracket <= MAX_BRACKET_S:
            self._anchor, self._t_anchor = event, t
            self._due = t + REANCHOR_S

    def to_host(self, event) -> float:
        """The monotonic second at which the stream reached ``event``
        (which has completed)."""
        return self._t_anchor + elapsed_s(self._anchor, event)


class StreamTimeline:
    """One stream's intervals ``[start, end]`` (completed events), in the
    order they are read, merged into their union.  Intervals overlap where
    two lanes launch onto one stream: an interval that starts before the
    end reached so far had no idle time before it, and adds only its time
    outside the union.  A lane that took its start event before the
    interval read just before it (the lanes race to the stream) extends
    the current run of merged intervals back, as far as the idle time that
    was counted before it; that gap was then read too long by as much.
    The union is exact where each interval is read at most one place out
    of its start's order, as with two lanes."""

    def __init__(self):
        self._lo = self._last = None
        #: Idle seconds between the run before and the current run's
        #: start (nothing lies before the first).
        self._idle_before_lo = float("inf")

    def advance(self, start, end) -> typing.Tuple[float, typing.Optional[float]]:
        """``(device seconds the interval adds to the union, seconds the
        stream sat idle before start)``; the idle time is None for the
        first interval, which has nothing before it to measure from."""
        if self._last is None:
            self._lo, self._last = start, end
            return elapsed_s(start, end), None
        gap = elapsed_s(self._last, start)
        if gap > 0:
            self._lo, self._last, self._idle_before_lo = start, end, gap
            return elapsed_s(start, end), gap
        added = 0.0
        ahead = elapsed_s(start, self._lo)
        if ahead > 0:
            # Its part inside the idle time before the run's start.
            short = max(0.0, elapsed_s(end, self._lo))
            before = min(ahead, self._idle_before_lo) - short
            if before > 0:
                added += before
                self._idle_before_lo -= before
                if not short:
                    self._lo = start
        past = elapsed_s(self._last, end)
        if past > 0:
            added += past
            self._last = end
        return added, 0.0


def host_stages(lo: float, hi: float, spans: typing.Iterable[Span]
                ) -> typing.Tuple[str, typing.Dict[str, float]]:
    """Where the host was over ``[lo, hi)``: the stage at ``lo``, and the
    seconds of the interval under each stage.  ``spans`` do not overlap;
    time under none of them is ``window``'s (between a runner batch's
    dispatches, or the gang's steps)."""
    at = "window"
    share: typing.Dict[str, float] = {}
    covered = 0.0
    for name, a, b in spans:
        if a <= lo < b:
            at = name
        overlap = min(b, hi) - max(a, lo)
        if overlap > 0:
            share[name] = share.get(name, 0.0) + overlap
            covered += overlap
    if hi - lo - covered > 0:
        share["window"] = share.get("window", 0.0) + (hi - lo - covered)
    return at, share


def tile(names: typing.Sequence[str], stamps: typing.Sequence[float]) -> typing.List[Span]:
    """Consecutive spans ``names[i]`` from ``stamps[i]`` to
    ``stamps[i + 1]``: they meet, and together cover ``stamps[0]`` to
    ``stamps[-1]``."""
    if len(stamps) != len(names) + 1:
        raise ValueError(f"{len(names)} spans need {len(names) + 1} stamps, got {len(stamps)}")
    return [(name, a, b) for name, a, b in zip(names, stamps, stamps[1:])]


def place(clock: DeviceClock, timeline: StreamTimeline, start, end,
          spans: typing.Iterable[Span], tracer, track: str,
          args: dict) -> typing.Tuple[float, typing.Optional[float]]:
    """Record the interval ``[start, end]`` (completed events) as a
    ``device`` span on ``<track>.device`` and, after idle time, a
    ``device.idle`` span ending where it starts, named by the host's
    ``spans`` (:func:`host_stages`).  Returns :meth:`StreamTimeline.advance`'s
    ``(device seconds past the latest end reached, idle seconds before it
    or None)``."""
    clock.reanchor()
    t_start = clock.to_host(start)
    added, gap = timeline.advance(start, end)
    on = track + ".device"
    tracer.span(on, "device", t_start, t_start + elapsed_s(start, end), args=args)
    if gap is not None and gap >= IDLE_SPAN_MIN_S:
        host, share = host_stages(t_start - gap, t_start, spans)
        idle_args = dict(args)
        idle_args["host"] = host
        idle_args["stages"] = {k: round(v, 6) for k, v in share.items()}
        tracer.span(on, "device.idle", t_start - gap, t_start, args=idle_args)
    return added, gap


class StepProbe:
    """What a model reports of one step from inside it, read once the
    step's own sync has passed: the device seconds of named sections
    (CUDA timing events on the current stream around each, summed over
    the step; none on the CPU) and counts it adds as device tensors, so
    nothing waits on the device while the step is queued."""

    def __init__(self, device, *, graphed: bool = False):
        self._cuda = getattr(device, "type", device) == "cuda"
        #: Captured into a CUDA graph: its events become the graph's event
        #: record nodes, which every replay records again, and its counts
        #: the graph's static outputs; read after each replay.
        self._graphed = graphed
        self._sections: typing.Dict[str, typing.List[typing.Tuple[typing.Any, typing.Any]]] = {}
        self._counts: typing.Dict[str, typing.Any] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        """Time the device work queued inside the block under ``name``."""
        if not self._cuda:
            yield
            return
        start = self._event()
        yield
        self._sections.setdefault(name, []).append((start, self._event()))

    def _event(self):
        if not self._graphed:
            return DeviceClock.record()
        import torch

        event = torch.cuda.Event(enable_timing=True, external=True)
        event.record()
        return event

    def add(self, name: str, value) -> None:
        """Add ``value`` (a device tensor or a number) to the count ``name``."""
        held = self._counts.get(name)
        self._counts[name] = value if held is None else held + value

    def read(self) -> typing.Dict[str, float]:
        """Every section's seconds and every count, by name.  Call after
        the step's work has completed (its results were fetched)."""
        out = {name: sum(elapsed_s(a, b) for a, b in pairs)
               for name, pairs in self._sections.items()}
        for name, value in self._counts.items():
            out[name] = float(value)
        return out
