"""Metric groups — counters, meters, gauges and histograms per subtask.

A small copy of ``flink_tensorflow_tpu/metrics/registry.py``: what the
serving operator and the model runners record (step counts, TTFT,
prefill and decode-step seconds; records, batch and record latency,
assemble and dispatch seconds, H2D bytes) and the runtime's checkpoint
and recovery durations.  ``report()`` gives
``{"<scope>.<name>": value}`` as the JAX registry does, and a
:class:`MetricRegistry` holds the groups of one job.
"""

from __future__ import annotations

import threading
import time
import typing

import numpy as np


class Counter:
    def __init__(self) -> None:
        self.count = 0

    def inc(self, n: int = 1) -> None:
        self.count += n


class Meter:
    """Event count and its mean rate since creation."""

    def __init__(self) -> None:
        self.count = 0
        self._t0 = time.monotonic()
        self._lock = threading.Lock()

    def mark(self, n: int = 1) -> None:
        with self._lock:
            self.count += n

    def rate(self) -> float:
        elapsed = time.monotonic() - self._t0
        return self.count / elapsed if elapsed > 0 else 0.0


class Histogram:
    """Keeps every sample (a run of this slice records thousands, not
    millions)."""

    def __init__(self) -> None:
        self.values: typing.List[float] = []

    def record(self, value: float) -> None:
        self.values.append(float(value))

    def percentile(self, q: float) -> float:
        return float(np.percentile(self.values, q)) if self.values else float("nan")

    def summary(self) -> typing.Dict[str, float]:
        return {"count": len(self.values), "p50": self.percentile(50),
                "p95": self.percentile(95), "p99": self.percentile(99),
                "mean": float(np.mean(self.values)) if self.values else float("nan")}


class MetricGroup:
    """Metrics under one scope (``<task>.<subtask>``)."""

    def __init__(self, scope: str):
        self.scope = scope
        self._metrics: typing.Dict[str, typing.Any] = {}
        #: The registry holding this group (None for a bare group): a
        #: function reaches a job-level scope through it.
        self._registry: typing.Optional["MetricRegistry"] = None

    def _get(self, name: str, factory):
        metric = self._metrics.get(name)
        if metric is None:
            metric = self._metrics[name] = factory()
        return metric

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def meter(self, name: str) -> Meter:
        return self._get(name, Meter)

    def gauge(self, name: str, fn: typing.Callable[[], typing.Any]) -> None:
        self._metrics[name] = fn

    def report(self) -> typing.Dict[str, typing.Any]:
        out = {}
        for name, metric in self._metrics.items():
            if isinstance(metric, Counter):
                value = metric.count
            elif isinstance(metric, Meter):
                value = {"count": metric.count, "rate": metric.rate()}
            elif isinstance(metric, Histogram):
                value = metric.summary()
            else:
                value = metric()
            out[f"{self.scope}.{name}"] = value
        return out


class MetricRegistry:
    """The metric groups of one job, by scope."""

    def __init__(self) -> None:
        self._groups: typing.Dict[str, MetricGroup] = {}
        self._lock = threading.Lock()

    def group(self, scope: str) -> MetricGroup:
        with self._lock:
            grp = self._groups.get(scope)
            if grp is None:
                grp = self._groups[scope] = MetricGroup(scope)
                grp._registry = self
            return grp

    def report(self) -> typing.Dict[str, typing.Any]:
        out: typing.Dict[str, typing.Any] = {}
        with self._lock:
            groups = list(self._groups.values())
        for grp in groups:
            out.update(grp.report())
        return out
