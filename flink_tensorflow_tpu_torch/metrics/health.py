"""Health evaluation — declarative SLOs over the cohort metric feed.

Port of ``flink_tensorflow_tpu/metrics/health.py``, kept equal to it (pure
Python over snapshots; the tests hold both packages to the same
transitions, gauges and views on the same snapshot sequences).

The observability planes so far are all *sensors*: per-process metrics,
span traces, the cohort collector's merged snapshot, recovery counters.
This module is the first consumer: a catalogue of declarative
:class:`SloRule` specs (metric selector or free expression over the
merged snapshot, warn/breach thresholds, sustain window, clear
hysteresis) evaluated each telemetry interval by a
:class:`HealthEvaluator` on process 0 — the poll loop the
``CohortCollector.merged_snapshot()`` docstring has promised since the
telemetry plane landed.

State machine per (rule, target): ``OK -> WARN -> BREACH`` with
hysteresis on BOTH edges — a rule escalates only after ``sustain``
consecutive intervals past a threshold and de-escalates one level only
after ``clear_after`` consecutive intervals back under it, so a
flapping metric (alternating over/under every tick) can neither
escalate nor oscillate the autoscale actuator.  Evaluation is a pure
function of the snapshot sequence (``evaluate_once``), which is what
the hysteresis fixtures pin.

Results publish back into the same planes they came from:

- ``health.*`` gauges on the local registry (one per target, value
  0/1/2 = OK/WARN/BREACH, plus the ``job`` rollup) — so the merged
  snapshot carries them and ``flink-tpu-inspect --live --cohort``
  renders a health column with zero extra plumbing;
- flight-recorder events on the ``health`` track (every transition,
  with the observed value) — post-mortem evidence for
  ``flink-tpu-doctor``;
- trace instants when tracing is on — breaches land on the same
  Perfetto timeline as their causes.

Transition listeners (``subscribe``) are how the autoscale actuator
(core/autoscale.py) closes the loop.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import threading
import time
import typing

#: Health levels, ordered worst-last so ``max`` is "worst of".
OK, WARN, BREACH = 0, 1, 2
STATE_NAMES = ("OK", "WARN", "BREACH")

Snapshot = typing.Mapping[str, typing.Mapping[str, typing.Any]]

#: Summary-dict fields a rule may select from histogram/timer/meter
#: snapshot entries.
_FIELDS = ("count", "p50", "p95", "p99", "mean", "total_s", "rate",
           "window_rate")


def _split_scope(scope: str) -> typing.Tuple[str, typing.Optional[int]]:
    task, dot, tail = scope.rpartition(".")
    if dot and tail.isdigit():
        return task, int(tail)
    return scope, None


@dataclasses.dataclass(frozen=True)
class SloRule:
    """One declarative SLO over the (merged) metric snapshot.

    Selector semantics: ``scope`` is an fnmatch pattern over snapshot
    scopes — the default ``"*"`` selects per-subtask scopes
    (``"op.3"``) and rolls subtasks up to their operator; a job-level
    scope name (``"checkpoint"``, ``"recovery"``) selects exactly that
    scope.  ``metric`` is an fnmatch pattern over metric names within
    the scope (a pattern matching several names — ``"edge*_queue_depth"``
    — yields one health target per matching name, the per-edge case).
    ``field`` picks a summary key (``p95``, ``rate``, ...) out of
    histogram/timer/meter entries.  Alternatively ``expr`` is a free
    function of the whole snapshot returning ``{target: value}`` (or a
    scalar, attributed to target ``"job"``) — the escape hatch for
    cross-scope expressions.

    ``mode="rate"`` differentiates cumulative gauges/counters into a
    per-second rate between consecutive evaluations (the natural shape
    for ``backpressure_s``/``idle_s`` accumulated-seconds gauges, where
    the rate is the fraction of wall time spent in that condition).

    ``cmp`` is ``">"`` (higher is worse, the default) or ``"<"``.
    ``action`` is a hint the actuator dispatches on (``"scale_up"`` /
    ``"scale_down"``); rules without one are observe-only.
    """

    id: str
    metric: str
    warn: float
    breach: float
    scope: str = "*"
    field: typing.Optional[str] = None
    cmp: str = ">"
    mode: str = "value"
    #: Consecutive evaluation intervals past a threshold before escalating.
    sustain: int = 3
    #: Consecutive intervals back under it before de-escalating one level.
    clear_after: int = 2
    expr: typing.Optional[typing.Callable[[Snapshot], typing.Any]] = None
    action: typing.Optional[str] = None

    def validate(self) -> "SloRule":
        if not self.id:
            raise ValueError("SloRule.id must be non-empty")
        if self.expr is None and not self.metric:
            raise ValueError(f"rule {self.id!r}: metric or expr required")
        if self.cmp not in (">", "<"):
            raise ValueError(f"rule {self.id!r}: cmp must be '>' or '<'")
        if self.mode not in ("value", "rate"):
            raise ValueError(f"rule {self.id!r}: mode must be 'value' or 'rate'")
        if self.sustain < 1 or self.clear_after < 1:
            raise ValueError(
                f"rule {self.id!r}: sustain and clear_after must be >= 1")
        if self.cmp == ">" and self.breach < self.warn:
            raise ValueError(
                f"rule {self.id!r}: breach threshold must be >= warn for cmp '>'")
        if self.cmp == "<" and self.breach > self.warn:
            raise ValueError(
                f"rule {self.id!r}: breach threshold must be <= warn for cmp '<'")
        if self.field is not None and self.field not in _FIELDS:
            raise ValueError(
                f"rule {self.id!r}: field must be one of {_FIELDS}")
        return self

    def worse(self, value: float, threshold: float) -> bool:
        return value >= threshold if self.cmp == ">" else value <= threshold

    # -- selection --------------------------------------------------------
    def _value_of(self, entry: typing.Any) -> typing.Optional[float]:
        if isinstance(entry, typing.Mapping):
            if self.field is None:
                return None
            entry = entry.get(self.field)
        if isinstance(entry, bool) or not isinstance(entry, (int, float)):
            return None
        v = float(entry)
        return v if v == v else None  # drop NaN (empty reservoirs)

    def observe(self, snapshot: Snapshot) -> typing.Dict[str, float]:
        """``{target: raw value}`` for this rule over one snapshot.
        Per-subtask scopes roll up to their operator with the WORST
        subtask (max for ``>``, min for ``<``); a metric-name pattern
        keeps one target per matching name (``op/edge0_src_queue_depth``)."""
        if self.expr is not None:
            got = self.expr(snapshot)
            if got is None:
                return {}
            if isinstance(got, typing.Mapping):
                return {str(k): float(v) for k, v in got.items()
                        if isinstance(v, (int, float))
                        and not isinstance(v, bool)}
            return {"job": float(got)}
        exact_metric = not any(c in self.metric for c in "*?[")
        out: typing.Dict[str, float] = {}
        pick = max if self.cmp == ">" else min
        for scope in snapshot:
            task, index = _split_scope(scope)
            if self.scope == "*":
                if index is None:
                    continue
            elif not fnmatch.fnmatchcase(scope, self.scope):
                continue
            metrics = snapshot[scope]
            names = ([self.metric] if exact_metric else
                     [n for n in metrics
                      if fnmatch.fnmatchcase(n, self.metric)])
            base = task if index is not None else scope
            for name in names:
                if name not in metrics:
                    continue
                v = self._value_of(metrics[name])
                if v is None:
                    continue
                target = base if exact_metric else f"{base}/{name}"
                out[target] = pick(out[target], v) if target in out else v
        return out


@dataclasses.dataclass(frozen=True)
class HealthTransition:
    """One state-machine edge: rule ``rule_id`` moved ``target`` from
    ``old`` to ``new`` on observed ``value`` at wall time ``ts``."""

    rule_id: str
    target: str
    old: int
    new: int
    value: float
    ts: float
    action: typing.Optional[str] = None

    def describe(self) -> str:
        return (f"{self.rule_id}:{self.target} "
                f"{STATE_NAMES[self.old]}->{STATE_NAMES[self.new]} "
                f"(value={self.value:.4g})")


class _TargetState:
    """Hysteresis FSM for one (rule, target) pair."""

    __slots__ = ("state", "value", "warn_hot", "breach_hot", "warn_cold",
                 "breach_cold")

    def __init__(self):
        self.state = OK
        self.value: typing.Optional[float] = None
        self.warn_hot = self.breach_hot = 0
        self.warn_cold = self.breach_cold = 0

    def update(self, rule: SloRule, value: float) -> typing.Optional[int]:
        """Feed one observation; returns the new state on a transition,
        None otherwise.  Escalation (to the worst sustained level) needs
        ``sustain`` consecutive hot ticks; de-escalation steps down ONE
        level per ``clear_after`` consecutive cold ticks — both edges
        damped, so an alternating metric holds its current state."""
        self.value = value
        past_w = rule.worse(value, rule.warn)
        past_b = rule.worse(value, rule.breach)
        self.warn_hot = self.warn_hot + 1 if past_w else 0
        self.breach_hot = self.breach_hot + 1 if past_b else 0
        self.warn_cold = 0 if past_w else self.warn_cold + 1
        self.breach_cold = 0 if past_b else self.breach_cold + 1
        new = self.state
        if self.state in (OK, WARN) and self.breach_hot >= rule.sustain:
            new = BREACH
        elif self.state == OK and self.warn_hot >= rule.sustain:
            new = WARN
        elif self.state == WARN and self.warn_cold >= rule.clear_after:
            new = OK
        elif self.state == BREACH and self.breach_cold >= rule.clear_after:
            new = WARN
        if new == self.state:
            return None
        self.state = new
        return new


def default_rules(*, channel_capacity: int = 1024) -> typing.Tuple[SloRule, ...]:
    """The shipped catalogue: backpressure (accumulated-seconds rate and
    per-edge queue depth against the channel capacity), credit
    starvation on flow-controlled record-plane edges, idleness,
    checkpoint-duration creep, serving TTFT/admission pressure, and
    recovery churn.  Thresholds scale with ``channel_capacity`` where
    the signal is a queue depth."""
    cap = float(channel_capacity)
    return (
        # Fraction of wall time an operator spent blocked emitting
        # downstream (cumulative backpressure_s differentiated per tick).
        SloRule("backpressure", "backpressure_s", warn=0.5, breach=0.85,
                mode="rate", action="scale_up"),
        # Time upstream writers spend blocked putting into this
        # operator's gate — "this operator CAUSES the backpressure".
        SloRule("blocked-put", "in_backpressure_s", warn=0.5, breach=0.85,
                mode="rate", action="scale_up"),
        # Per-edge buffered depth against the channel capacity: the
        # per-edge backpressure signal (one target per input edge).
        SloRule("edge-queue", "edge*_queue_depth",
                warn=0.5 * cap, breach=0.9 * cap, action="scale_up"),
        # Credit starvation: fraction of wall time a sender spent parked
        # at zero credit — the flow-control view of "the consumer cannot
        # keep up".  Two selectors because the senders live in different
        # scope families: RemoteSink edges publish
        # `edge.credit_starved_s` under their operator scope ("op.3",
        # caught by the "*" rollup); shuffle-plane writers publish
        # `credit_starved_s` under `shuffle.out.{task}.{n}.ch{k}`, which
        # the "*" rollup skips (non-digit tail) and so needs its own
        # scope glob.
        SloRule("credit-starvation", "edge.credit_starved_s",
                warn=0.5, breach=0.85, mode="rate", action="scale_up"),
        SloRule("credit-starvation-shuffle", "credit_starved_s",
                scope="shuffle.out.*", warn=0.5, breach=0.85,
                mode="rate", action="scale_up"),
        # One-way wire latency (p95) on remote record-plane edges:
        # send->recv delta via the cohort clock offsets (io/remote.py's
        # `edge.wire_latency_s`, error bound published next to it).  A
        # creeping p95 is the wire-side early warning the queue-depth
        # rules can't see — frames aging in kernel buffers before the
        # receiver ever books them.
        SloRule("wire-latency", "edge.wire_latency_s", field="p95",
                warn=0.5, breach=2.0, sustain=2, action="scale_up"),
        # Sustained idleness = over-provisioned (scale-down hint); long
        # sustain so startup/drain phases don't trip it.
        SloRule("idle", "idle_s", warn=0.90, breach=0.99, mode="rate",
                sustain=10, clear_after=3, action="scale_down"),
        # Checkpoint-duration creep: p95 alignment+snapshot wall time.
        SloRule("checkpoint-creep", "duration_s", scope="checkpoint",
                field="p95", warn=5.0, breach=30.0, sustain=2),
        # Serving plane: time-to-first-token p95 and rejected admissions.
        SloRule("serving-ttft", "ttft_s", field="p95", warn=1.0,
                breach=5.0, action="scale_up"),
        SloRule("serving-rejected", "rejected", warn=0.5, breach=5.0,
                mode="rate", sustain=2, action="scale_up"),
        # Recovery churn: restarts and aborted checkpoints per second —
        # any sustained nonzero rate is a sick cohort.
        SloRule("recovery-churn", "restarts_total", scope="recovery",
                warn=0.01, breach=0.1, mode="rate", sustain=2),
        SloRule("checkpoint-aborts", "checkpoints_aborted",
                scope="recovery", warn=0.01, breach=0.2, mode="rate",
                sustain=2),
        # Roofline plane (metrics/roofline.py; rules on absent metrics
        # never fire, so these cost nothing without JobConfig.roofline).
        # MFU collapse: a model operator's achieved FLOP/s fell to noise
        # against the declared DeviceSpec peak — the device is starved
        # (host/input bound), which more parallelism upstream fixes.
        # Long sustain so warmup/drain phases don't trip it.
        SloRule("mfu-collapse", "roofline.mfu_pct", cmp="<",
                warn=5.0, breach=1.0, sustain=10, clear_after=3,
                action="scale_up"),
        # Predicted-vs-measured h2d divergence: the plan's static
        # transfer accounting no longer matches what the runner ships.
        SloRule("roofline-drift", "roofline.h2d_drift_frac",
                warn=0.25, breach=1.0, sustain=3),
        # Unpredicted recompiles per second: shapes outside the plan's
        # compile-signature ladder reaching the device (recompile churn
        # the serving-recompile-churn lint warned about, now measured).
        SloRule("roofline-recompile", "roofline.unpredicted_compiles",
                warn=0.05, breach=1.0, mode="rate", sustain=2),
        # Paged KV economy (serving/paged.py; absent without
        # ServingConfig.paged_kv so dense plans never score these).
        # Sustained pool occupancy near the ceiling: admissions start
        # stalling behind the page gate and every decode-step growth
        # risks a forced demotion — more HBM pages or more subtasks.
        SloRule("kv-pool-pressure", "kv_page_occupancy_pct",
                warn=85.0, breach=95.0, sustain=2, action="scale_up"),
        # Tier churn: demote/spill/revive transitions per second.  A
        # sustained high rate means the pool thrashes sessions across
        # the HBM/host/disk ladder instead of serving them — the paging
        # analogue of swap thrash.
        SloRule("kv-tier-thrash", "kv_tier_moves", warn=5.0,
                breach=50.0, mode="rate", sustain=2, action="scale_up"),
    )


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """``JobConfig.health``: turn the evaluation plane on.

    ``rules=()`` (the default) ships :func:`default_rules` with
    thresholds scaled to the job's channel capacity; ``interval_s=None``
    follows the cohort telemetry cadence
    (``DistributedConfig.telemetry_interval_s``, 1s single-process).
    ``autoscale`` (a ``core.autoscale.AutoscaleConfig``) additionally
    attaches the actuator on process 0.
    """

    rules: typing.Tuple[SloRule, ...] = ()
    interval_s: typing.Optional[float] = None
    autoscale: typing.Optional[typing.Any] = None

    def validate(self) -> "HealthConfig":
        for r in self.rules:
            r.validate()
        if self.interval_s is not None and self.interval_s <= 0:
            raise ValueError(
                f"health.interval_s must be > 0, got {self.interval_s}")
        if self.autoscale is not None:
            self.autoscale.validate()
        return self

    def resolved_rules(self, channel_capacity: int = 1024) -> typing.Tuple[SloRule, ...]:
        return self.rules or default_rules(channel_capacity=channel_capacity)


class HealthEvaluator:
    """Rolls the metric feed up into per-target health states.

    ``evaluate_once(snapshot, now)`` is the pure core (fed directly by
    the hysteresis tests); ``start()`` runs it on a daemon thread
    against ``snapshot_fn`` — ``CohortCollector.merged_snapshot`` on a
    distributed process 0, ``registry.snapshot()`` locally — each
    ``interval_s``.  Current states publish as ``health.*`` gauges on
    ``registry`` and every transition lands on the flight recorder,
    the tracer (when on), and each subscribed listener.
    """

    def __init__(
        self,
        rules: typing.Optional[typing.Sequence[SloRule]] = None,
        *,
        interval_s: float = 1.0,
        snapshot_fn: typing.Optional[
            typing.Callable[[], typing.Tuple[float, Snapshot]]] = None,
        registry: typing.Optional[typing.Any] = None,
        flight: typing.Optional[typing.Any] = None,
        tracer: typing.Optional[typing.Any] = None,
        max_transitions: int = 1024,
    ):
        self.rules = tuple(r.validate() for r in
                           (rules if rules is not None else default_rules()))
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.interval_s = interval_s
        self.snapshot_fn = snapshot_fn
        self.registry = registry
        self.flight = flight
        self.tracer = tracer
        self.ticks = 0
        #: Bounded transition history (newest last).
        self.transitions: typing.List[HealthTransition] = []
        self._max_transitions = max_transitions
        self._states: typing.Dict[typing.Tuple[str, str], _TargetState] = {}
        #: Cumulative-gauge memory for mode="rate": (ts, raw value).
        self._prev_raw: typing.Dict[typing.Tuple[str, str],
                                    typing.Tuple[float, float]] = {}
        self._listeners: typing.List[
            typing.Callable[[HealthTransition], None]] = []
        self._tick_listeners: typing.List[
            typing.Callable[["HealthEvaluator"], None]] = []
        #: target -> worst current state; gauge callbacks close over it.
        self._published: typing.Dict[str, int] = {}
        self._known_gauges: typing.Set[str] = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: typing.Optional[threading.Thread] = None

    # -- subscriptions -----------------------------------------------------
    def subscribe(self, listener: typing.Callable[[HealthTransition], None]) -> None:
        """Edge-triggered: called once per state transition."""
        self._listeners.append(listener)

    def subscribe_ticks(self, listener: typing.Callable[["HealthEvaluator"], None]) -> None:
        """Level-triggered: called after EVERY evaluation with the
        evaluator itself — how the actuator re-checks a deferred
        decision (cooldown running, no completed checkpoint yet)
        without waiting for a fresh transition edge."""
        self._tick_listeners.append(listener)

    # -- evaluation core ---------------------------------------------------
    def _rate(self, key: typing.Tuple[str, str], now: float,
              raw: float) -> typing.Optional[float]:
        prev = self._prev_raw.get(key)
        self._prev_raw[key] = (now, raw)
        if prev is None or now <= prev[0]:
            return None  # first sight of this target: no interval yet
        return (raw - prev[1]) / (now - prev[0])

    def evaluate_once(self, snapshot: Snapshot,
                      now: typing.Optional[float] = None
                      ) -> typing.List[HealthTransition]:
        """Feed one snapshot through every rule; returns the transitions
        it caused (already fanned out to listeners/flight/tracer)."""
        now = time.time() if now is None else now
        fired: typing.List[HealthTransition] = []
        with self._lock:
            self.ticks += 1
            for rule in self.rules:
                for target, raw in sorted(rule.observe(snapshot).items()):
                    key = (rule.id, target)
                    value: typing.Optional[float] = raw
                    if rule.mode == "rate":
                        value = self._rate(key, now, raw)
                        if value is None:
                            continue
                    st = self._states.get(key)
                    if st is None:
                        st = self._states[key] = _TargetState()
                    old = st.state
                    new = st.update(rule, value)
                    if new is not None:
                        fired.append(HealthTransition(
                            rule_id=rule.id, target=target, old=old,
                            new=new, value=value, ts=now,
                            action=rule.action))
            self._republish()
        for t in fired:
            self.transitions.append(t)
            if len(self.transitions) > self._max_transitions:
                del self.transitions[:-self._max_transitions]
            if self.flight is not None:
                self.flight.record("health", f"{t.rule_id}:{t.target}", {
                    "from": STATE_NAMES[t.old], "to": STATE_NAMES[t.new],
                    "value": t.value, "action": t.action})
            if self.tracer is not None:
                self.tracer.instant(
                    "health", f"{t.rule_id}:{t.target}:{STATE_NAMES[t.new]}",
                    args={"value": t.value})
            for listener in self._listeners:
                try:
                    listener(t)
                except Exception:  # noqa: BLE001 - a broken listener must
                    import logging  # not kill the evaluation loop

                    logging.getLogger(__name__).warning(
                        "health transition listener failed", exc_info=True)
        for tick_listener in self._tick_listeners:
            try:
                tick_listener(self)
            except Exception:  # noqa: BLE001 - same containment
                import logging

                logging.getLogger(__name__).warning(
                    "health tick listener failed", exc_info=True)
        return fired

    def active_breaches(self) -> typing.List[
            typing.Tuple[SloRule, str, typing.Optional[float]]]:
        """``(rule, target, last value)`` for every pair currently in
        BREACH — the actuator's level-triggered input."""
        by_id = {r.id: r for r in self.rules}
        with self._lock:
            return [(by_id[rid], target, st.value)
                    for (rid, target), st in sorted(self._states.items())
                    if st.state == BREACH]

    # -- rollups -----------------------------------------------------------
    def target_states(self) -> typing.Dict[str, int]:
        """``{target: worst current state across rules}`` — the shape the
        ``health.*`` gauges and the inspector column consume.  Per-edge
        targets (``op/edge0_up_queue_depth``) fold into their operator."""
        out: typing.Dict[str, int] = {}
        with self._lock:
            for (_rid, target), st in self._states.items():
                op = target.split("/", 1)[0]
                out[op] = max(out.get(op, OK), st.state)
        return out

    def job_state(self) -> int:
        states = self.target_states()
        return max(states.values(), default=OK)

    def health(self) -> typing.Dict[str, typing.Any]:
        """Full structured view (the doctor's evidence shape)."""
        with self._lock:
            rules: typing.Dict[str, typing.Dict[str, typing.Any]] = {}
            for (rid, target), st in self._states.items():
                rules.setdefault(rid, {})[target] = {
                    "state": STATE_NAMES[st.state], "value": st.value}
        targets = self.target_states()
        return {
            "ticks": self.ticks,
            "job": STATE_NAMES[max(targets.values(), default=OK)],
            "targets": {t: STATE_NAMES[s] for t, s in sorted(targets.items())},
            "rules": rules,
            "transitions": [t.describe() for t in self.transitions[-32:]],
        }

    def _republish(self) -> None:
        """Refresh the ``health.*`` gauges (lock held).  Gauge callbacks
        close over ``_published`` so re-evaluation is pull-free; new
        targets register lazily, re-registration replaces (restart-safe
        per the registry contract)."""
        if self.registry is None:
            return
        pub: typing.Dict[str, int] = {}
        for (_rid, target), st in self._states.items():
            op = target.split("/", 1)[0]
            pub[op] = max(pub.get(op, OK), st.state)
        pub["job"] = max(pub.values(), default=OK)
        self._published.clear()
        self._published.update(pub)
        grp = self.registry.group("health")
        for name in pub:
            if name not in self._known_gauges:
                self._known_gauges.add(name)
                grp.gauge(name,
                          lambda p=self._published, n=name: p.get(n, OK))

    # -- poll thread -------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                ts, snapshot = self.snapshot_fn()
                self.evaluate_once(snapshot, ts)
            except Exception:  # noqa: BLE001 - keep evaluating
                import logging

                logging.getLogger(__name__).warning(
                    "health evaluation tick failed", exc_info=True)

    def start(self) -> None:
        if self.snapshot_fn is None:
            raise ValueError("start() needs snapshot_fn (evaluate_once for "
                             "direct feeding)")
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="health-evaluator", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
