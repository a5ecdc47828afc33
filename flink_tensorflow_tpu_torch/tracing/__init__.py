"""End-to-end span tracing + latency attribution (Perfetto-exportable).

Enable with ``JobConfig(trace=True)`` (optionally ``trace_path=...``,
``trace_sample_rate=...``) or ``FLINK_TPU_TRACE=1`` /
``FLINK_TPU_TRACE_PATH`` / ``FLINK_TPU_TRACE_SAMPLE``.  The CLI is
``python -m flink_tensorflow_tpu_torch.tracing``: run a captured port
pipeline under tracing and print the per-operator stage attribution
table (``--from-file``, ``--cohort`` and ``--from-flight-dump`` read
files instead).  Port of ``flink_tensorflow_tpu/tracing/``.  See
``tracer.py`` for the span model, ``attribution.py`` for the profiler
and ``doctor.py`` for the root-cause report (``python -m
flink_tensorflow_tpu_torch.tracing.doctor``).
"""

from flink_tensorflow_tpu_torch.tracing.attribution import (
    STAGES,
    attribution,
    events_from_chrome,
    format_attribution_table,
)
from flink_tensorflow_tpu_torch.tracing.clocksync import OffsetEstimator
from flink_tensorflow_tpu_torch.tracing.flight import (
    FlightRecorder,
    load_flight_dump,
)
from flink_tensorflow_tpu_torch.tracing.stitch import (
    cross_process_traces,
    merge_cohort_trace_files,
    merge_cohort_traces,
)
from flink_tensorflow_tpu_torch.tracing.tracer import (
    TraceContext,
    Tracer,
    env_enabled,
    env_sample_rate,
    env_trace_path,
    events_to_chrome,
)

__all__ = [
    "STAGES",
    "FlightRecorder",
    "OffsetEstimator",
    "TraceContext",
    "Tracer",
    "attribution",
    "cross_process_traces",
    "env_enabled",
    "env_sample_rate",
    "env_trace_path",
    "events_from_chrome",
    "events_to_chrome",
    "format_attribution_table",
    "load_flight_dump",
    "merge_cohort_trace_files",
    "merge_cohort_traces",
]
