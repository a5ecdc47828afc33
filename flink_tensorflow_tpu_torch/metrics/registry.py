"""Metric group — counters, gauges and histograms of one subtask.

A small copy of ``flink_tensorflow_tpu/metrics/registry.py``: what the
serving operator and runner record (step counts, TTFT, prefill and
decode-step seconds).  ``report()`` gives ``{"<scope>.<name>": value}``
as the JAX registry does.
"""

from __future__ import annotations

import typing

import numpy as np


class Counter:
    def __init__(self) -> None:
        self.count = 0

    def inc(self, n: int = 1) -> None:
        self.count += n


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
                "p95": self.percentile(95), "p99": self.percentile(99)}


class MetricGroup:
    """Metrics under one scope (``<task>.<subtask>``)."""

    def __init__(self, scope: str):
        self.scope = scope
        self._metrics: typing.Dict[str, typing.Any] = {}

    def _get(self, name: str, factory):
        metric = self._metrics.get(name)
        if metric is None:
            metric = self._metrics[name] = factory()
        return metric

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def gauge(self, name: str, fn: typing.Callable[[], typing.Any]) -> None:
        self._metrics[name] = fn

    def report(self) -> typing.Dict[str, typing.Any]:
        out = {}
        for name, metric in self._metrics.items():
            if isinstance(metric, Counter):
                value = metric.count
            elif isinstance(metric, Histogram):
                value = metric.summary()
            else:
                value = metric()
            out[f"{self.scope}.{name}"] = value
        return out
