"""Job observability plane: metric types, pluggable reporters, inspector.

- :mod:`.registry` — Counter/Meter/Gauge/Timer/Histogram + the per-job
  :class:`MetricRegistry` (scope-tree snapshots, seeded reservoirs).
- :mod:`.reporters` — :class:`MetricReporter` sinks (JSON-lines,
  Prometheus text file and HTTP, console, latest snapshot) driven by a
  daemon :class:`ReporterThread`; configured via :class:`MetricConfig`.
- :mod:`.inspector` — ``python -m flink_tensorflow_tpu_torch.metrics
  <pipeline.py>``: execute a pipeline under the metric plane and print
  per-operator rate, latency percentiles, queue depth, backpressure, and
  watermark lag.
- :mod:`.roofline` — the roofline plane's probes, report and presets.
"""

from flink_tensorflow_tpu_torch.metrics.cohort import (
    CohortCollector,
    merge_states,
    state_to_snapshot,
)
from flink_tensorflow_tpu_torch.metrics.registry import (
    Counter,
    Gauge,
    Histogram,
    Meter,
    MetricGroup,
    MetricRegistry,
    Timer,
)
from flink_tensorflow_tpu_torch.metrics.reporters import (
    ConsoleReporter,
    JsonLinesReporter,
    LatestSnapshotReporter,
    MetricConfig,
    MetricReporter,
    PrometheusFileReporter,
    PrometheusHttpReporter,
    ReporterThread,
)

__all__ = [
    "CohortCollector",
    "ConsoleReporter",
    "Counter",
    "Gauge",
    "Histogram",
    "JsonLinesReporter",
    "LatestSnapshotReporter",
    "Meter",
    "MetricConfig",
    "MetricGroup",
    "MetricRegistry",
    "MetricReporter",
    "PrometheusFileReporter",
    "PrometheusHttpReporter",
    "ReporterThread",
    "Timer",
    "merge_states",
    "state_to_snapshot",
]
