"""Cohort clock-offset estimation — NTP-style monotonic-clock alignment.

Every process of a cohort keeps its own ``time.monotonic()`` domain,
so a span stamp minted on one process means nothing on another — the
reason the tracer historically suppressed foreign-clock ``queue`` spans.
This module closes that gap the way Perfetto-style tracing systems (and
NTP itself) do: a ping/pong exchange against a reference clock
(process 0) bounds each process's offset by the round-trip time.

One sample: the peer sends ``t_send`` (its clock), the reference stamps
``t_server`` (its clock) and echoes, the peer reads ``t_recv`` on
arrival.  The midpoint estimate

    offset = t_server - (t_send + t_recv) / 2

maps peer time into reference time with error bounded by half the
round trip (exact when the two wire legs are symmetric).  The
estimator keeps the MINIMUM-RTT sample — the tightest bound — and ages
it out so periodic re-pings track clock drift instead of being pinned
to one early lucky sample forever.

Pure data structure, a copy of ``flink_tensorflow_tpu/tracing/clocksync.py``
(the tests hold both to the same floats).  The live exchange over a
cohort's control channel is ``core/cohort_telemetry.py``.
"""

from __future__ import annotations

import time
import typing

#: A best sample older than this may be replaced by ANY fresh sample
#: (not only a lower-RTT one): monotonic clocks drift apart on the order
#: of microseconds per second, so a minute-old tight bound can be worse
#: than a fresh loose one.
DEFAULT_MAX_AGE_S = 30.0


class OffsetEstimator:
    """Running estimate of one remote clock's offset vs the local clock.

    ``offset_s`` maps local readings into the remote (reference)
    domain: ``t_ref = t_local + offset_s``.  ``error_bound_s`` is half
    the round trip of the sample the estimate came from — the classical
    NTP bound on how wrong the midpoint assumption can be.
    """

    __slots__ = ("offset_s", "error_bound_s", "samples", "max_age_s",
                 "_best_rtt", "_best_at")

    def __init__(self, max_age_s: float = DEFAULT_MAX_AGE_S):
        self.offset_s: typing.Optional[float] = None
        self.error_bound_s = float("inf")
        self.samples = 0
        self.max_age_s = max_age_s
        self._best_rtt = float("inf")
        self._best_at = float("-inf")

    def add_sample(self, t_send: float, t_server: float, t_recv: float,
                   now: typing.Optional[float] = None) -> bool:
        """Fold one ping/pong round; returns True when it replaced the
        current estimate (lower RTT, or the old best aged out).
        ``t_send``/``t_recv`` are LOCAL clock readings, ``t_server`` is
        the reference clock's echo."""
        rtt = t_recv - t_send
        if rtt < 0:  # clock went backwards mid-flight: not a sample
            return False
        self.samples += 1
        now = time.monotonic() if now is None else now
        stale = (now - self._best_at) > self.max_age_s
        if rtt >= self._best_rtt and not stale:
            return False
        self._best_rtt = rtt
        self._best_at = now
        self.offset_s = t_server - (t_send + t_recv) / 2.0
        self.error_bound_s = rtt / 2.0
        return True

    @property
    def ready(self) -> bool:
        return self.offset_s is not None
