"""Distributed metric aggregation — the cohort's JobManager-side view.

Port of ``flink_tensorflow_tpu/metrics/cohort.py``, kept equal to it: it
merges the port registry's ``export_state()`` trees.

Flink aggregates TaskManager metric groups on the JobManager so one
query answers for the whole job; this module is that plane for a
:class:`~flink_tensorflow_tpu_torch.core.distributed.DistributedExecutor`
cohort.  Every non-zero process periodically pushes its registry's
STATE tree (``MetricRegistry.export_state`` — counters, meter counts,
histogram reservoir samples, evaluated gauges) over the existing
control channel; the process-0 :class:`CohortCollector` merges the
scope trees:

- **counters / meters** sum (records are records wherever they ran);
- **histograms / timers** merge their reservoir SAMPLES (strided,
  deterministic — no percentile-of-percentiles averaging);
- **gauges** follow a per-name aggregation policy (``gauge_policy``):
  accumulated-seconds and depth/bytes gauges SUM, watermarks and
  lags/high-watermarks take MAX, identities take LAST.

Subtask scopes (``op.3``) are disjoint across processes by placement,
so the per-operator table simply unions; job-level scopes
(``checkpoint``, ``wire``, ``reactor``, ``shuffle.*``) genuinely merge.

``CohortCollector.merged_snapshot()`` renders the merged state in the
exact ``MetricRegistry.snapshot()`` shape, so every existing consumer
— ``flink-tpu-inspect --live --cohort``, reporters, and the ROADMAP's
autoscaling supervisor (this is its control-signal feed) — reads a
cohort the same way it reads one process.
"""

from __future__ import annotations

import threading
import time
import typing

import numpy as np

State = typing.Dict[str, typing.Dict[str, tuple]]
Snapshot = typing.Dict[str, typing.Dict[str, typing.Any]]

#: Gauge-name aggregation policies for scope collisions.  Accumulated
#: time and sizes add up across processes; level/lag style gauges keep
#: the worst (max) process; anything unrecognised keeps max too (a safe
#: "most loaded process" default for load-shaped gauges).
_SUM_SUFFIXES = ("_s", "_bytes", "_depth", "_puts", "_count", "_paused")
_SUM_NAMES = frozenset({
    "queue_depth", "violations", "tracked_ops", "connections",
    "splits_assigned", "splits_completed",
    # Serving scheduler: cumulative event counts and in-flight
    # load published as gauges — cohort totals, like their counter kin.
    "admitted", "evicted", "preempted", "rejected", "serving_steps",
    "active_seqs", "waiting_seqs", "tokens_in_use",
    "cache_h2d_blocks", "cache_d2h_blocks", "cache_resident_moves",
    "dispatches",
    # Chaos/recovery planes: per-process abort lists and fault
    # injections add up to the cohort's churn.
    "checkpoints_aborted", "fired_total",
    # Roofline plane: compile events add up to the cohort's
    # recompile bill.  (flops_per_s / hbm_bytes_per_s / busy_s sum via
    # the _s suffix — the cohort's aggregate device throughput.)
    "roofline.compile_events", "roofline.unpredicted_compiles",
})
_LAST_NAMES = frozenset({
    "chain_length", "chained_edges", "chain_position", "current_split_id",
    # Classification code, not a magnitude: any numeric reduction would
    # invent a bound no process reported.
    "roofline.bound",
})
#: Level/lag gauges whose suffix would otherwise read as accumulated
#: time: the cohort-wide value is the WORST process, not the sum.
_MAX_NAMES = frozenset({
    "poll_to_dispatch_s", "max_poll_to_dispatch_s",
    # Ages/lags sampled per subtask: the cohort answer is the most
    # stale process, never the sum of ages.
    "watermark_lag_s", "current_split_age_s",
    # The checkpoint scope collides across every process; the cohort's
    # "latest completed" is the highest id any process reports (a peer
    # mid-restore may briefly trail).
    "last_checkpoint_id",
    # Utilization percentages and per-call averages: the cohort answer
    # is the hottest (or most divergent) process, never the sum.
    "roofline.mfu_pct", "roofline.membw_pct", "roofline.h2d_drift_frac",
    "roofline.measured_h2d_per_call", "roofline.predicted_h2d_per_call",
})
# Not in any table by design: per-edge "reconnects" and recovery's
# "restarts_total"/"edge_reconnects" are counters/meters (they sum
# structurally); serving "ttft_s" is a histogram (reservoir merge);
# the process-0-only "health" scope never collides, and its default
# max would be the worst state anyway.


def gauge_policy(name: str) -> str:
    """``"sum" | "max" | "last"`` for one gauge name."""
    if name in _LAST_NAMES:
        return "last"
    if name in _MAX_NAMES:
        return "max"
    if name in _SUM_NAMES or name.endswith(_SUM_SUFFIXES):
        return "sum"
    return "max"


def _merge_entries(name: str, entries: typing.Sequence[tuple]) -> tuple:
    """Merge same-(scope, name) state entries from several processes.
    Entries arrive in process-index order, making every reduction
    deterministic."""
    kinds = {e[0] for e in entries}
    if len(entries) == 1 or len(kinds) != 1:
        # Singleton, or a (pathological) kind mismatch: first wins.
        return entries[0]
    kind = entries[0][0]
    if kind == "counter":
        return ("counter", sum(e[1] for e in entries))
    if kind == "meter":
        merged = {"count": 0, "rate": 0.0, "window_rate": 0.0}
        for _, payload in entries:
            for key in merged:
                merged[key] += payload.get(key) or 0
        return ("meter", merged)
    if kind in ("histogram", "timer"):
        merged = {
            "count": sum(e[1].get("count", 0) for e in entries),
            "samples": [s for _, payload in entries
                        for s in payload.get("samples", ())],
        }
        if kind == "timer":
            merged["total_s"] = sum(
                e[1].get("total_s", 0.0) for e in entries)
        return (kind, merged)
    if kind == "gauge":
        values = [e[1] for e in entries
                  if isinstance(e[1], (int, float))
                  and not isinstance(e[1], bool)]
        if not values:
            return ("gauge", entries[-1][1])
        policy = gauge_policy(name)
        if policy == "sum":
            return ("gauge", sum(values))
        if policy == "last":
            return ("gauge", values[-1])
        return ("gauge", max(values))
    return entries[-1]


def merge_states(states: typing.Sequence[State]) -> State:
    """One merged state tree over per-process exports (pass them in
    process-index order for deterministic reservoir concatenation)."""
    merged: State = {}
    names: typing.Dict[str, typing.Dict[str, typing.List[tuple]]] = {}
    for state in states:
        for scope, metrics in state.items():
            per_scope = names.setdefault(scope, {})
            for name, entry in metrics.items():
                per_scope.setdefault(name, []).append(entry)
    for scope, per_scope in names.items():
        merged[scope] = {
            name: _merge_entries(name, entries)
            for name, entries in per_scope.items()
        }
    return merged


def _summary(samples: typing.Sequence[float], count: int) -> typing.Dict[str, float]:
    if samples:
        arr = np.asarray(samples, dtype=np.float64)
        p50, p95, p99 = (float(v) for v in np.percentile(arr, (50, 95, 99)))
        mean = float(arr.mean())
    else:
        p50 = p95 = p99 = mean = float("nan")
    return {"count": float(count), "p50": p50, "p95": p95, "p99": p99,
            "mean": mean}


def state_to_snapshot(state: State) -> Snapshot:
    """Render a (merged) state tree in ``MetricRegistry.snapshot()``
    shape — the scope tree every reporter/inspector consumer parses."""
    tree: Snapshot = {}
    for scope, metrics in state.items():
        out = tree.setdefault(scope, {})
        for name, (kind, payload) in metrics.items():
            if kind in ("counter", "gauge", "value"):
                out[name] = payload
            elif kind == "meter":
                out[name] = dict(payload)
            elif kind == "histogram":
                out[name] = _summary(payload.get("samples", ()),
                                     payload.get("count", 0))
            elif kind == "timer":
                summary = _summary(payload.get("samples", ()),
                                   payload.get("count", 0))
                summary["total_s"] = payload.get("total_s", 0.0)
                out[name] = summary
            else:  # pragma: no cover - forward compatibility
                out[name] = payload
    return tree


class CohortCollector:
    """Process-0 aggregation point: latest state per cohort process,
    merged on demand.

    ``on_push`` is called by the telemetry service as peer pushes
    arrive (stale sequence numbers are dropped — control frames are
    FIFO per peer, but a reconnect may replay); ``merged_snapshot()``
    folds the local registry's live state with every peer's latest push.
    This object IS the programmatic cohort feed: the autoscaling
    supervisor polls it exactly like ``flink-tpu-inspect --live
    --cohort`` does.
    """

    def __init__(self, registry, process_index: int = 0,
                 num_processes: int = 1):
        self.registry = registry
        self.process_index = process_index
        self.num_processes = num_processes
        self._lock = threading.Lock()
        #: process index -> (seq, monotonic receive time, state)
        self._peers: typing.Dict[int, typing.Tuple[int, float, State]] = {}
        self.pushes = 0

    def on_push(self, sender: int, seq: int, state: State) -> None:
        with self._lock:
            current = self._peers.get(sender)
            if current is not None and current[0] >= seq:
                return
            self._peers[sender] = (seq, time.monotonic(), state)
            self.pushes += 1

    @property
    def peers_reporting(self) -> typing.List[int]:
        with self._lock:
            return sorted(self._peers)

    def merged_state(self) -> State:
        with self._lock:
            peers = sorted(self._peers.items())
        states = [self.registry.export_state()]
        states.extend(entry[2] for _, entry in peers)
        return merge_states(states)

    def merged_snapshot(self) -> typing.Tuple[float, Snapshot]:
        """(unix timestamp, merged scope tree in snapshot shape) — the
        supervisor/inspector feed."""
        return time.time(), state_to_snapshot(self.merged_state())
