"""Pluggable metric reporters + the daemon reporter thread.

Port of ``flink_tensorflow_tpu/metrics/reporters.py``, kept equal to it
(the Prometheus exposition is byte-equal for the same snapshot).

Flink publishes operator metric groups through configurable reporters
(JMX/Prometheus/SLF4J); this runtime ships three host-local sinks so a
job is observable without any external service:

- :class:`JsonLinesReporter` — appends one JSON object per report to a
  file; the machine-readable stream the inspector CLI and benches parse.
- :class:`PrometheusFileReporter` — rewrites a Prometheus text-exposition
  file ATOMICALLY (tmp + rename) on every report, so a node-exporter
  textfile collector (or a human with ``cat``) never sees a torn scrape.
- :class:`ConsoleReporter` — compact per-scope lines on stderr.

All sinks are PULL-driven by one :class:`ReporterThread` per job: the
thread snapshots the registry every ``report_interval_s`` and fans the
tree out to each reporter.  With ``report_interval_s=None`` no thread is
ever created — the hot-path instrumentation then only pays its O(1)
increments and is read once, at job completion, via
``MetricRegistry.report()``.

Configured through :class:`MetricConfig` (``JobConfig.metrics``) or
ad hoc via ``env.execute(report_interval_s=...)``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import sys
import threading
import time
import typing

from flink_tensorflow_tpu_torch.metrics.registry import MetricRegistry

Snapshot = typing.Dict[str, typing.Dict[str, typing.Any]]


class MetricReporter:
    """Base sink: receives the registry's scope tree once per interval."""

    def report(self, snapshot: Snapshot, *, timestamp: float) -> None:
        raise NotImplementedError

    def close(self) -> None:  # noqa: B027
        """Flush/release sink resources (called once, after the final
        report)."""


def json_safe(value: typing.Any) -> typing.Any:
    """NaN/inf are not JSON; reporters must emit parseable lines."""
    if isinstance(value, float) and not math.isfinite(value):
        return None
    if isinstance(value, dict):
        return {k: json_safe(v) for k, v in value.items()}
    return value


class JsonLinesReporter(MetricReporter):
    """One JSON object per report: ``{"ts": ..., "metrics": {scope: {...}}}``."""

    def __init__(self, path: str):
        self.path = path
        self._file: typing.Optional[typing.TextIO] = None

    def report(self, snapshot: Snapshot, *, timestamp: float) -> None:
        if self._file is None:
            parent = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(parent, exist_ok=True)
            self._file = open(self.path, "a")
        line = {"ts": timestamp, "metrics": json_safe(snapshot)}
        self._file.write(json.dumps(line) + "\n")
        self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


_PROM_NAME = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    safe = _PROM_NAME.sub("_", name)
    if safe and safe[0].isdigit():
        safe = "_" + safe
    return f"flink_tpu_{safe}"


def _prom_escape(label: str) -> str:
    return label.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def prometheus_exposition(snapshot: Snapshot, timestamp: float) -> str:
    """Render the scope tree as Prometheus text format (0.0.4).

    Scalars become gauges labelled by scope; dict-valued metrics
    (meter/histogram/timer summaries) flatten one level into
    ``<metric>_<field>``.  Non-numeric and None values are skipped —
    exposition is numbers only.
    """
    lines: typing.List[str] = [f"# flink-tensorflow-tpu metrics ts={timestamp}"]
    seen_help: typing.Set[str] = set()

    def emit(name: str, scope: str, value: typing.Any) -> None:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            return
        if isinstance(value, float) and not math.isfinite(value):
            return
        metric = _prom_name(name)
        if metric not in seen_help:
            seen_help.add(metric)
            lines.append(f"# TYPE {metric} gauge")
        lines.append(f'{metric}{{scope="{_prom_escape(scope)}"}} {value}')

    for scope in sorted(snapshot):
        for name, value in sorted(snapshot[scope].items()):
            if isinstance(value, dict):
                for field, sub in value.items():
                    emit(f"{name}_{field}", scope, sub)
            else:
                emit(name, scope, value)
    return "\n".join(lines) + "\n"


class PrometheusFileReporter(MetricReporter):
    """Atomic text-exposition file: write tmp, fsync, rename — a scraper
    reading the path sees either the previous report or this one, never
    a partial write."""

    def __init__(self, path: str):
        self.path = path

    def report(self, snapshot: Snapshot, *, timestamp: float) -> None:
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(prometheus_exposition(snapshot, timestamp))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)


class PrometheusHttpReporter(MetricReporter):
    """Live HTTP scrape endpoint: a stdlib ``http.server`` daemon thread
    serving the latest text exposition (the same format the atomic-file
    reporter writes) at every path — point a Prometheus scrape job at
    ``http://host:port/metrics`` with no textfile collector in between.

    ``port=0`` binds an ephemeral port; read the resolved one from
    ``.port``.  The handler serves a cached string swapped atomically by
    :meth:`report` (plain attribute assignment — a scrape sees either
    the previous exposition or the new one, never a torn mix), so scrape
    traffic costs the job nothing beyond the interval's render.
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        import http.server

        reporter = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - stdlib handler contract
                body = reporter._text.encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes must not spam stderr
                pass

        self._text = "# flink-tensorflow-tpu metrics: no report yet\n"
        self._server = http.server.ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self.host = host
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="prometheus-http",
            daemon=True)
        self._thread.start()

    def report(self, snapshot: Snapshot, *, timestamp: float) -> None:
        self._text = prometheus_exposition(snapshot, timestamp)

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)


class LatestSnapshotReporter(MetricReporter):
    """In-memory sink holding only the NEWEST report — the poll target
    of live consumers (``flink-tpu-inspect --live`` reads it once per
    frame).  ``latest()`` returns ``(timestamp, snapshot)`` or None
    before the first report; the swap is a single tuple assignment, so
    a reader sees a complete (ts, snapshot) pair, never a torn one."""

    def __init__(self) -> None:
        self._latest: typing.Optional[typing.Tuple[float, Snapshot]] = None
        self.reports = 0

    def report(self, snapshot: Snapshot, *, timestamp: float) -> None:
        self._latest = (timestamp, snapshot)
        self.reports += 1

    def latest(self) -> typing.Optional[typing.Tuple[float, Snapshot]]:
        return self._latest


class ConsoleReporter(MetricReporter):
    """Human-oriented: one compact line per scope per report."""

    def __init__(self, stream: typing.Optional[typing.TextIO] = None):
        self.stream = stream

    def report(self, snapshot: Snapshot, *, timestamp: float) -> None:
        out = self.stream or sys.stderr
        stamp = time.strftime("%H:%M:%S", time.localtime(timestamp))
        for scope in sorted(snapshot):
            parts = []
            for name, value in sorted(snapshot[scope].items()):
                if isinstance(value, dict):
                    bits = ", ".join(
                        f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                        for k, v in value.items()
                        if isinstance(v, (int, float)) and not isinstance(v, bool)
                        and (not isinstance(v, float) or math.isfinite(v))
                    )
                    parts.append(f"{name}[{bits}]")
                elif isinstance(value, float):
                    parts.append(f"{name}={value:.4g}")
                elif value is not None:
                    parts.append(f"{name}={value}")
            print(f"[metrics {stamp}] {scope}: {'; '.join(parts)}", file=out)
        out.flush()


@dataclasses.dataclass(frozen=True)
class MetricConfig:
    """How (and whether) a job's metrics are published while it runs.

    ``report_interval_s=None`` (the default) starts NO reporter thread:
    metrics are still collected (O(1) per record) and surface in the
    ``JobResult``, but nothing runs alongside the job.  With an interval,
    the configured sinks receive a registry snapshot each period.
    """

    #: Reporter period; None disables the reporter thread entirely.
    report_interval_s: typing.Optional[float] = None
    #: Append JSON-lines reports to this path.
    jsonl_path: typing.Optional[str] = None
    #: Maintain a Prometheus text-exposition file at this path.
    prometheus_path: typing.Optional[str] = None
    #: Serve the exposition over HTTP on this port (0 = ephemeral; the
    #: resolved port is on the reporter instance).  None = no server.
    http_port: typing.Optional[int] = None
    #: Print per-scope lines to stderr each interval.
    console: bool = False
    #: Extra user-constructed :class:`MetricReporter` instances.
    reporters: typing.Tuple[MetricReporter, ...] = ()
    #: Registry seed: makes every histogram reservoir deterministic
    #: (per-metric generators derived from it — see MetricRegistry).
    seed: typing.Optional[int] = None

    def validate(self) -> None:
        if self.report_interval_s is not None and self.report_interval_s <= 0:
            raise ValueError(
                f"metrics.report_interval_s must be > 0, got {self.report_interval_s}"
            )
        if self.http_port is not None and not (0 <= self.http_port <= 65535):
            raise ValueError(
                f"metrics.http_port must be a port number, got {self.http_port}"
            )
        for r in self.reporters:
            if not isinstance(r, MetricReporter):
                raise ValueError(
                    f"metrics.reporters entries must be MetricReporter "
                    f"instances, got {type(r).__name__}"
                )

    def build_reporters(self) -> typing.List[MetricReporter]:
        sinks: typing.List[MetricReporter] = list(self.reporters)
        if self.jsonl_path is not None:
            sinks.append(JsonLinesReporter(self.jsonl_path))
        if self.prometheus_path is not None:
            sinks.append(PrometheusFileReporter(self.prometheus_path))
        if self.http_port is not None:
            sinks.append(PrometheusHttpReporter(self.http_port))
        if self.console:
            sinks.append(ConsoleReporter())
        return sinks


class ReporterThread:
    """Daemon thread snapshotting one registry into N sinks per interval.

    The final snapshot is pushed at :meth:`stop` (so short jobs still get
    one complete report), then every sink's ``close()`` runs.  Errors in
    a sink are logged-and-swallowed — observability must never take the
    job down.
    """

    def __init__(self, registry: MetricRegistry,
                 reporters: typing.Sequence[MetricReporter],
                 interval_s: float, *, flight=None):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.registry = registry
        self.reporters = list(reporters)
        self.interval_s = interval_s
        #: Optional tracing.flight.FlightRecorder: each report also
        #: lands a compact per-scope metric-delta event in the black
        #: box, so a crash dump shows the record-flow history even on
        #: untraced jobs.
        self.flight = flight
        self._stop = threading.Event()
        self._thread: typing.Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="metric-reporter", daemon=True)
        self._thread.start()

    def _publish(self) -> None:
        snapshot = self.registry.snapshot()
        now = time.time()
        for reporter in self.reporters:
            try:
                reporter.report(snapshot, timestamp=now)
            except Exception:  # noqa: BLE001 - a sink must not kill the job
                import logging

                logging.getLogger(__name__).warning(
                    "metric reporter %s failed", type(reporter).__name__,
                    exc_info=True,
                )
        if self.flight is not None:
            try:
                self.flight.metric_delta(snapshot)
            except Exception:  # noqa: BLE001 - observability only
                pass
        # Window rates mean "since the previous report" — the reporter
        # thread owns the window cadence (window_rate() itself is pure).
        self.registry.reset_windows()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._publish()

    def flush_now(self) -> None:
        """Publish one out-of-cadence report immediately (the executor's
        crash-time flush: a job failure must not lose the snapshot that
        explains it to a reporter interval that never elapses).  Safe
        from any thread — sinks already tolerate concurrent reports no
        worse than a stop() racing the interval tick."""
        try:
            self._publish()
        except Exception:  # noqa: BLE001 - observability must not raise
            import logging

            logging.getLogger(__name__).warning(
                "crash-time metric flush failed", exc_info=True)

    def stop(self) -> None:
        """Final report + sink close; idempotent."""
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=10.0)
        self._thread = None
        self._publish()
        for reporter in self.reporters:
            try:
                reporter.close()
            except Exception:  # noqa: BLE001 - teardown best-effort
                pass
