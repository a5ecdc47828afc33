"""Metrics — counters, meters, gauges, timers, latency histograms per
operator subtask.

Port of ``flink_tensorflow_tpu/metrics/registry.py``, kept equal to it:
histograms keep a bounded reservoir (65,536 samples) drawn from a
per-instance generator seeded from the registry's seed and the metric's
scope and name, so a long serving job's histograms stay bounded and two
runs of the same seeded job sample alike.  ``MetricRegistry.report()``
gives the flat ``{"<scope>.<name>": value}`` view and ``snapshot()`` the
``{scope: {name: value}}`` tree the reporters and the inspector read.
The port's callers read ``Counter.count`` (an alias of ``value``),
``Histogram.values`` (the reservoir's samples) and ``MetricGroup.report()``
(one scope of the flat view).

Hot-path contract: push-side operations (``Counter.inc``, ``Meter.mark``,
``Histogram.record``, ``Timer.update``) are O(1) per record.  Everything
pull-based — :class:`Gauge` callbacks, rates, percentiles — is evaluated
only when a reporter (metrics.reporters) or the inspector CLI reads a
:meth:`MetricRegistry.snapshot`, so instrumentation that is never read
costs nothing beyond the increments.
"""

from __future__ import annotations

import threading
import time
import typing
import zlib

import numpy as np


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    @property
    def count(self) -> int:
        """The port's name for :attr:`value`."""
        return self.value


class Meter:
    """Rate meter: events/sec over the job's lifetime and a sliding window.

    Thread-safe: one meter may be marked from several threads (an
    operator's background fetch thread and its subtask thread) while a
    reporter reads it.  ``window_rate()`` is PURE — it never consumes the
    window, so a reporter and user code can both read it; the owner of
    the window cadence calls :meth:`reset_window` explicitly.
    """

    __slots__ = ("count", "_start", "_win_count", "_win_start", "_lock")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.count = 0
        self._start = time.monotonic()
        self._win_count = 0
        self._win_start = self._start

    def mark(self, n: int = 1) -> None:
        with self._lock:
            self.count += n
            self._win_count += n

    def rate(self) -> float:
        elapsed = time.monotonic() - self._start
        return self.count / elapsed if elapsed > 0 else 0.0

    def window_rate(self) -> float:
        """Events/sec since the last :meth:`reset_window` — read-only."""
        with self._lock:
            count, start = self._win_count, self._win_start
        elapsed = time.monotonic() - start
        return count / elapsed if elapsed > 0 else 0.0

    def reset_window(self) -> None:
        """Start a fresh rate window (the reporter thread owns the
        cadence; user code reading ``window_rate()`` must not steal it)."""
        with self._lock:
            self._win_count = 0
            self._win_start = time.monotonic()


class Histogram:
    """Bounded-reservoir histogram for latency percentiles.

    The reservoir uses a PER-INSTANCE ``np.random.Generator`` (seeded
    deterministically from the registry's configured seed + the metric's
    scope/name): sampling through the global ``np.random`` state would
    both break the repo's determinism guarantees (user jobs seed the
    global state) and race when other threads draw from it.
    """

    __slots__ = ("_samples", "_capacity", "count", "_rng")

    def __init__(self, capacity: int = 65536,
                 seed: typing.Optional[int] = None):
        self._samples: typing.List[float] = []
        self._capacity = capacity
        self.count = 0
        self._rng = np.random.default_rng(seed)

    def record(self, value: float) -> None:
        self.count += 1
        if len(self._samples) < self._capacity:
            self._samples.append(value)
        else:
            # Reservoir sampling keeps percentiles unbiased under overflow.
            j = int(self._rng.integers(0, self.count))
            if j < self._capacity:
                self._samples[j] = value

    @property
    def values(self) -> typing.List[float]:
        """The reservoir's samples: every recorded value until
        ``capacity`` have been recorded, a uniform sample of them after."""
        return self._samples

    def percentile(self, q: float) -> float:
        if not self._samples:
            return float("nan")
        return float(np.percentile(np.asarray(self._samples), q))

    def summary(self) -> typing.Dict[str, float]:
        return {
            "count": float(self.count),
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
            "mean": float(np.mean(self._samples)) if self._samples else float("nan"),
        }


class Gauge:
    """Pull-based metric: a zero-arg callback evaluated at REPORT time.

    The hot path never touches a gauge — instrumented code exposes live
    state (queue depth, accumulated blocked time, HBM bytes) and the
    reporter thread reads it at its own cadence.  A raising callback
    yields None (a dying metric must never fail a report)."""

    __slots__ = ("_fn",)

    def __init__(self, fn: typing.Callable[[], typing.Any]):
        self._fn = fn

    def set_callback(self, fn: typing.Callable[[], typing.Any]) -> None:
        self._fn = fn

    def value(self) -> typing.Any:
        try:
            return self._fn()
        except Exception:  # noqa: BLE001 - reporting must not kill the job
            return None


class Timer:
    """Duration tracker: a histogram of seconds + total time + count.

    Use as a context manager (``with timer.time(): ...``) or feed
    measured intervals via :meth:`update` when the caller already has
    the two clock reads (the runtime loop does — no extra ``monotonic()``
    calls on the hot path)."""

    __slots__ = ("histogram", "count", "total_s")

    def __init__(self, seed: typing.Optional[int] = None):
        self.histogram = Histogram(seed=seed)
        self.count = 0
        self.total_s = 0.0

    def update(self, seconds: float) -> None:
        self.count += 1
        self.total_s += seconds
        self.histogram.record(seconds)

    class _Span:
        __slots__ = ("_timer", "_t0")

        def __init__(self, timer: "Timer"):
            self._timer = timer
            self._t0 = 0.0

        def __enter__(self) -> "Timer._Span":
            self._t0 = time.monotonic()
            return self

        def __exit__(self, *exc) -> None:
            self._timer.update(time.monotonic() - self._t0)

    def time(self) -> "Timer._Span":
        return Timer._Span(self)

    def summary(self) -> typing.Dict[str, float]:
        out = self.histogram.summary()
        out["total_s"] = self.total_s
        return out


def _strided(samples: typing.Sequence[float], cap: int) -> typing.List[float]:
    """Deterministic down-sample: every k-th reservoir entry, bounded by
    ``cap`` — no RNG, so two exports of the same state are identical
    (the cohort merge's determinism contract)."""
    n = len(samples)
    if n <= cap:
        return [float(s) for s in samples]
    stride = (n + cap - 1) // cap
    return [float(samples[i]) for i in range(0, n, stride)]


class MetricGroup:
    """Namespaced metric container for one operator subtask.  A group
    made without a registry (a bare runtime context's) gets a private
    one."""

    def __init__(self, scope: str, registry: typing.Optional["MetricRegistry"] = None):
        self.scope = scope
        self._registry = registry if registry is not None else MetricRegistry()

    def counter(self, name: str) -> Counter:
        return self._registry._get(self.scope, name, Counter)

    def meter(self, name: str) -> Meter:
        return self._registry._get(self.scope, name, Meter)

    def histogram(self, name: str) -> Histogram:
        seed = self._registry.metric_seed(self.scope, name)
        return self._registry._get(
            self.scope, name, lambda: Histogram(seed=seed))

    def timer(self, name: str) -> Timer:
        seed = self._registry.metric_seed(self.scope, name)
        return self._registry._get(self.scope, name, lambda: Timer(seed=seed))

    def gauge(self, name: str,
              fn: typing.Optional[typing.Callable[[], typing.Any]] = None) -> Gauge:
        """Register (or re-point) a pull-based gauge.  With ``fn`` the
        callback is installed — re-registration replaces it (a restarted
        operator re-binds its gauges to fresh state); without ``fn`` the
        existing gauge is returned for reading."""
        gauge = self._registry._get(
            self.scope, name, lambda: Gauge(fn if fn is not None else lambda: None))
        if fn is not None:
            gauge.set_callback(fn)
        return gauge

    def report(self) -> typing.Dict[str, typing.Any]:
        """This group's part of :meth:`MetricRegistry.report` (the port's
        callers read one subtask's metrics this way)."""
        return {f"{scope}.{name}": MetricRegistry._read(metric)
                for (scope, name), metric in self._registry.all_metrics().items()
                if scope == self.scope}


class MetricRegistry:
    """All metrics of one job, keyed by (scope, name).

    ``seed`` makes every histogram reservoir deterministic: each metric
    derives its own generator seed from (seed, scope, name), so two runs
    of the same seeded job sample identically regardless of thread
    interleaving elsewhere.  ``seed=None`` keeps instance-local
    OS-entropy generators (still race-free, just not reproducible).
    """

    def __init__(self, seed: typing.Optional[int] = None) -> None:
        self.seed = seed
        self._metrics: typing.Dict[typing.Tuple[str, str], typing.Any] = {}
        self._lock = threading.Lock()

    def metric_seed(self, scope: str, name: str) -> typing.Optional[int]:
        """Stable per-metric seed derived from the registry seed."""
        if self.seed is None:
            return None
        return zlib.crc32(f"{self.seed}/{scope}/{name}".encode())

    def _get(self, scope: str, name: str, factory: typing.Callable[[], typing.Any]):
        key = (scope, name)
        with self._lock:
            metric = self._metrics.get(key)
            if metric is None:
                metric = factory()
                self._metrics[key] = metric
            return metric

    def group(self, scope: str) -> MetricGroup:
        return MetricGroup(scope, self)

    def groups(self) -> typing.List[str]:
        """The scopes that hold at least one metric."""
        return sorted({scope for scope, _ in self.all_metrics()})

    def all_metrics(self) -> typing.Dict[typing.Tuple[str, str], typing.Any]:
        with self._lock:
            return dict(self._metrics)

    @staticmethod
    def _read(metric: typing.Any) -> typing.Any:
        if isinstance(metric, Counter):
            return metric.value
        if isinstance(metric, Meter):
            return {"count": metric.count, "rate": metric.rate(),
                    "window_rate": metric.window_rate()}
        if isinstance(metric, Timer):
            return metric.summary()
        if isinstance(metric, Histogram):
            return metric.summary()
        if isinstance(metric, Gauge):
            return metric.value()
        return metric

    def report(self) -> typing.Dict[str, typing.Any]:
        """Flat ``{scope.name: value}`` view (the legacy JobResult shape)."""
        out: typing.Dict[str, typing.Any] = {}
        for (scope, name), metric in self.all_metrics().items():
            out[f"{scope}.{name}"] = self._read(metric)
        return out

    def snapshot(self) -> typing.Dict[str, typing.Dict[str, typing.Any]]:
        """Scope-tree view ``{scope: {metric: value}}`` — what reporters
        and the inspector CLI consume.  Gauges are evaluated here (pull),
        meters are read without consuming their window."""
        tree: typing.Dict[str, typing.Dict[str, typing.Any]] = {}
        for (scope, name), metric in self.all_metrics().items():
            tree.setdefault(scope, {})[name] = self._read(metric)
        return tree

    def export_state(self, max_samples: int = 512) -> typing.Dict[str, typing.Dict[str, tuple]]:
        """Transferable per-metric STATE tree ``{scope: {name: (kind,
        payload)}}`` — what a cohort process pushes to the process-0
        collector (metrics/cohort.py).  Unlike :meth:`snapshot` this
        keeps histogram/timer RESERVOIR SAMPLES (strided down to
        ``max_samples`` so a push frame stays small) so the collector
        can merge distributions instead of averaging percentiles, and
        evaluates gauges to plain values so the receiving side applies
        an aggregation policy per name."""
        tree: typing.Dict[str, typing.Dict[str, tuple]] = {}
        for (scope, name), metric in self.all_metrics().items():
            if isinstance(metric, Counter):
                entry = ("counter", metric.value)
            elif isinstance(metric, Meter):
                entry = ("meter", {"count": metric.count,
                                   "rate": metric.rate(),
                                   "window_rate": metric.window_rate()})
            elif isinstance(metric, Timer):
                entry = ("timer", {
                    "count": metric.count, "total_s": metric.total_s,
                    "samples": _strided(metric.histogram._samples, max_samples),
                })
            elif isinstance(metric, Histogram):
                entry = ("histogram", {
                    "count": metric.count,
                    "samples": _strided(metric._samples, max_samples),
                })
            elif isinstance(metric, Gauge):
                entry = ("gauge", metric.value())
            else:
                entry = ("value", metric)
            tree.setdefault(scope, {})[name] = entry
        return tree

    def reset_windows(self) -> None:
        """Start a fresh window on every meter — the reporter thread calls
        this once per report so window rates mean "since last report"."""
        for metric in self.all_metrics().values():
            if isinstance(metric, Meter):
                metric.reset_window()
