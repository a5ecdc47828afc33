"""Autoscaling — the health plane's first actuator.

Port of ``flink_tensorflow_tpu/core/autoscale.py``, kept equal to it: the
supervisor half subclasses the port's ``parallel/supervisor.py``
``CohortSupervisor`` and the checkpoint gate reads the port's
``checkpoint/store.py``.

Closes the loop the observability stack built: the process-0
:class:`~flink_tensorflow_tpu_torch.metrics.health.HealthEvaluator` rolls the
cohort's merged metric feed into OK/WARN/BREACH states, and on a
SUSTAINED breach of a scaling rule this module drives the existing
recovery machinery end to end:

    breach sustained -> decision recorded -> cohort stop (rescale exit
    code) -> supervisor respawns at the new worker count (attempt
    threaded into ``restart_epoch`` per the zombie-fencing contract) ->
    workers restore from the latest COMMON checkpoint, keyed state
    redistributing by key group.

Two halves, two processes:

- :class:`AutoscaleActuator` runs INSIDE the process-0 worker (wired by
  ``execute_async`` when ``JobConfig.health.autoscale`` is set, or
  hand-held by a worker script).  Level-triggered on evaluator ticks,
  it picks the worst active breach with a scaling action, applies
  cooldown + min/max bounds + the completed-checkpoint gate (acting
  before a restore point exists would lose records), writes one
  decision file atomically, records the decision (inputs, rule,
  verdict) on the flight recorder, and invokes ``on_decision`` —
  typically "cancel the job and exit with the rescale code".

- :class:`AutoscaleSupervisor` runs in the PARENT (a
  ``parallel.CohortSupervisor`` subclass): a worker exiting with
  ``rescale_exit_code`` (or a fresh decision file appearing — the peers
  of the deciding worker die with ordinary codes when the cohort stops)
  is a rescale request, not a failure; the supervisor clamps the target
  again (defense in depth — the decision file crossed a process
  boundary), respawns the cohort at the new shape with a fresh restart
  budget, and books every consumed decision into its outcome.

Every decision is explainable post-hoc: the decision file carries the
rule, the observed value, the health rollup at decision time, and the
restore point; the same facts land on the flight ring, so
``flink-tpu-doctor`` can correlate "what breached" with "what the
supervisor did about it".
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
import typing

from flink_tensorflow_tpu_torch.parallel.supervisor import (
    CohortFailed,
    CohortSupervisor,
)

logger = logging.getLogger(__name__)

#: EX_TEMPFAIL: the conventional "stopped on purpose, run me again"
#: exit — distinguishable from crashes (tracebacks exit 1, signals
#: negative) without colliding with shell/errno codes.
RESCALE_EXIT_CODE = 75

DECISION_KIND = "flink-tpu-autoscale-decision"


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Actuator policy knobs (``JobConfig.health.autoscale``)."""

    #: Worker-count bounds the actuator may decide within.
    min_workers: int = 1
    max_workers: int = 4
    #: Workers added (scale_up) / removed (scale_down) per decision.
    step: int = 1
    #: Seconds from actuator start before it may act — the warmup after
    #: a (re)spawn AND the cooldown between consecutive rescales, since
    #: every rescale restarts the actuator with the cohort.
    cooldown_s: float = 10.0
    #: Where the decision file lands (the supervisor reads it back);
    #: None keeps decisions in memory/flight only — fine for tests and
    #: for integrations that act through ``on_decision`` alone.
    decision_path: typing.Optional[str] = None
    #: Refuse to act until a completed checkpoint exists: stopping a
    #: cohort with no restore point would replay from scratch (or lose
    #: exactly-once output entirely).
    require_checkpoint: bool = True
    rescale_exit_code: int = RESCALE_EXIT_CODE

    def validate(self) -> "AutoscaleConfig":
        if self.min_workers < 1:
            raise ValueError(
                f"autoscale.min_workers must be >= 1, got {self.min_workers}")
        if self.max_workers < self.min_workers:
            raise ValueError(
                f"autoscale.max_workers must be >= min_workers, got "
                f"{self.max_workers} < {self.min_workers}")
        if self.step < 1:
            raise ValueError(f"autoscale.step must be >= 1, got {self.step}")
        if self.cooldown_s < 0:
            raise ValueError(
                f"autoscale.cooldown_s must be >= 0, got {self.cooldown_s}")
        return self


@dataclasses.dataclass(frozen=True)
class AutoscaleDecision:
    """One scaling verdict, fully explainable: the rule that breached,
    the value it saw, the shape change, the restore point, and the
    health rollup at decision time."""

    rule_id: str
    target: str
    action: str
    value: float
    from_workers: int
    to_workers: int
    ts: float
    checkpoint_id: typing.Optional[int] = None
    health: typing.Mapping[str, typing.Any] = dataclasses.field(
        default_factory=dict)

    def to_dict(self) -> typing.Dict[str, typing.Any]:
        d = dataclasses.asdict(self)
        d["kind"] = DECISION_KIND
        return d


def write_decision(path: str, decision: AutoscaleDecision) -> str:
    """Atomic decision-file write (the supervisor may poll mid-write)."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(decision.to_dict(), f)
    os.replace(tmp, path)
    return path


def read_decision(path: str) -> typing.Optional[typing.Dict[str, typing.Any]]:
    """The decision dict at ``path``, or None (absent / torn / not a
    decision file — the supervisor treats all three as 'no request')."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or doc.get("kind") != DECISION_KIND:
        return None
    return doc


def checkpoint_gate(checkpoint_dir: typing.Optional[str]
                    ) -> typing.Callable[[], typing.Optional[int]]:
    """The default ``checkpoint_ready`` probe: latest COMPLETED id in
    this process's checkpoint dir (None before the first one lands)."""
    def probe() -> typing.Optional[int]:
        if checkpoint_dir is None:
            return None
        from flink_tensorflow_tpu_torch.checkpoint.store import latest_checkpoint_id

        try:
            return latest_checkpoint_id(checkpoint_dir)
        except OSError:
            return None
    return probe


class AutoscaleActuator:
    """In-job half: turns sustained breaches into ONE decision.

    Subscribe it to the evaluator (``evaluator.subscribe_ticks(
    actuator.on_tick)``): level-triggered re-evaluation means a
    decision deferred by the cooldown or the checkpoint gate fires on a
    later tick while the breach holds, instead of being lost with the
    transition edge.  One decision per actuator life — after deciding,
    the process's job is to stop; the respawned cohort gets a fresh
    actuator (and the cooldown starts over, damping rescale cascades).
    """

    def __init__(
        self,
        config: AutoscaleConfig,
        num_workers: int,
        *,
        checkpoint_ready: typing.Optional[
            typing.Callable[[], typing.Optional[int]]] = None,
        on_decision: typing.Optional[
            typing.Callable[[AutoscaleDecision], None]] = None,
        flight: typing.Optional[typing.Any] = None,
        clock: typing.Callable[[], float] = time.monotonic,
    ):
        self.config = config.validate()
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        self.num_workers = num_workers
        self.checkpoint_ready = checkpoint_ready
        self.on_decision = on_decision
        self.flight = flight
        self._clock = clock
        self._ready_at = clock() + self.config.cooldown_s
        #: The one decision this actuator made (None until then).
        self.decision: typing.Optional[AutoscaleDecision] = None
        #: Why the last tick did NOT act ("cooldown", "no-checkpoint",
        #: "at-bounds", "no-breach", or "decided") — test/doctor visibility.
        self.last_verdict = "no-breach"

    def _target_workers(self, action: str) -> int:
        cfg = self.config
        delta = cfg.step if action == "scale_up" else -cfg.step
        return max(cfg.min_workers, min(cfg.max_workers,
                                        self.num_workers + delta))

    def on_tick(self, evaluator) -> None:
        if self.decision is not None:
            self.last_verdict = "decided"
            return
        breaches = [(rule, target, value)
                    for rule, target, value in evaluator.active_breaches()
                    if rule.action in ("scale_up", "scale_down")
                    and value is not None]
        if not breaches:
            self.last_verdict = "no-breach"
            return
        # Worst first: scale_up outranks scale_down (saturation beats
        # thrift), then by how far past the breach threshold.
        def severity(b):
            rule, _target, value = b
            over = (value - rule.breach) if rule.cmp == ">" else (rule.breach - value)
            return (rule.action == "scale_up", over)

        rule, target, value = max(breaches, key=severity)
        if self._clock() < self._ready_at:
            self.last_verdict = "cooldown"
            return
        cid = self.checkpoint_ready() if self.checkpoint_ready else None
        if self.config.require_checkpoint and cid is None:
            self.last_verdict = "no-checkpoint"
            return
        to_workers = self._target_workers(rule.action)
        if to_workers == self.num_workers:
            self.last_verdict = "at-bounds"
            return
        decision = AutoscaleDecision(
            rule_id=rule.id, target=target, action=rule.action,
            value=value, from_workers=self.num_workers,
            to_workers=to_workers, ts=time.time(), checkpoint_id=cid,
            health=evaluator.health(),
        )
        self.decision = decision
        self.last_verdict = "decided"
        if self.config.decision_path is not None:
            try:
                write_decision(self.config.decision_path, decision)
            except OSError:
                logger.warning("autoscale decision write to %s failed",
                               self.config.decision_path, exc_info=True)
        if self.flight is not None:
            self.flight.record("autoscale", "decision", {
                "rule": rule.id, "target": target, "action": rule.action,
                "value": value, "from_workers": decision.from_workers,
                "to_workers": to_workers, "checkpoint_id": cid})
        logger.warning(
            "autoscale decision: %s breached on %s (value=%.4g) — "
            "%d -> %d workers (restore from checkpoint %s)",
            rule.id, target, value, decision.from_workers, to_workers, cid)
        if self.on_decision is not None:
            self.on_decision(decision)


@dataclasses.dataclass(frozen=True)
class AutoscaleOutcome:
    """Result of supervising an autoscaling cohort to completion."""

    attempts: int
    returncode: int
    num_workers: int
    #: Decision dicts consumed, oldest first — ``len`` is the rescale
    #: count the closed-loop tests assert on.
    rescales: typing.Tuple[typing.Dict[str, typing.Any], ...] = ()


class AutoscaleSupervisor(CohortSupervisor):
    """Parent half: a :class:`~flink_tensorflow_tpu_torch.parallel.supervisor.
    CohortSupervisor` whose restart loop understands rescale requests.

    ``command(worker_id, num_workers, attempt)`` must thread ``attempt``
    into ``DistributedConfig.restart_epoch`` (the zombie-fencing
    contract) and have workers restore from the latest COMMON
    checkpoint on ``attempt > 0`` — the same contract as plain cohort
    supervision; the only new behavior is the shape change.
    """

    def __init__(
        self,
        command: typing.Callable[[int, int, int], typing.Sequence[str]],
        num_workers: int,
        *,
        decision_path: str,
        min_workers: int = 1,
        max_workers: typing.Optional[int] = None,
        max_rescales: int = 3,
        rescale_exit_code: int = RESCALE_EXIT_CODE,
        env: typing.Optional[typing.Callable[
            [int, int, int], typing.Mapping[str, str]]] = None,
        max_restarts: int = 2,
        poll_s: float = 0.1,
        kill_grace_s: float = 5.0,
        attempt_timeout_s: typing.Optional[float] = None,
    ):
        super().__init__(
            command, num_workers, env=env, max_restarts=max_restarts,
            poll_s=poll_s, kill_grace_s=kill_grace_s,
            attempt_timeout_s=attempt_timeout_s,
            min_workers=min_workers,
        )
        self.decision_path = decision_path
        self.max_workers = max_workers if max_workers is not None else num_workers
        if self.max_workers < num_workers:
            raise ValueError(
                f"max_workers must be >= num_workers, got "
                f"{self.max_workers} < {num_workers}")
        self.max_rescales = max_rescales
        self.rescale_exit_code = rescale_exit_code

    def _fresh_decision(self, after_ts: float) -> typing.Optional[dict]:
        doc = read_decision(self.decision_path)
        if doc is None or float(doc.get("ts", 0.0)) <= after_ts:
            return None
        return doc

    def run(self) -> AutoscaleOutcome:  # type: ignore[override]
        shape = self.num_workers
        attempt = 0
        budget = self.max_restarts + 1
        rescales: typing.List[dict] = []
        consumed_ts = 0.0
        last_rc = -1
        while True:
            rc = self._run_attempt(attempt, shape)
            attempt += 1
            if rc == 0:
                return AutoscaleOutcome(
                    attempts=attempt, returncode=0, num_workers=shape,
                    rescales=tuple(rescales))
            last_rc = rc
            # A rescale request: the deciding worker's exit code, or —
            # when a peer's teardown code surfaced first — the fresh
            # decision file on its own.  Either way the decision is the
            # authority; its target is re-clamped here because it
            # crossed a process boundary.
            decision = self._fresh_decision(consumed_ts)
            if decision is not None and len(rescales) < self.max_rescales:
                consumed_ts = float(decision.get("ts", 0.0))
                target = max(self.min_workers,
                             min(self.max_workers,
                                 int(decision.get("to_workers", shape))))
                rescales.append(decision)
                logger.warning(
                    "autoscale: consuming decision (%s on %s) — respawning "
                    "cohort at %d workers (was %d), attempt %d",
                    decision.get("rule_id"), decision.get("target"),
                    target, shape, attempt)
                shape = target
                budget = self.max_restarts + 1
                continue
            if rc == self.rescale_exit_code:
                # Rescale exit with no readable decision: the file was
                # lost/torn.  Respawn at the same shape (costs restart
                # budget) rather than guessing a target.
                logger.warning(
                    "autoscale: worker requested rescale but no decision "
                    "file at %s — respawning unchanged", self.decision_path)
            budget -= 1
            if budget <= 0:
                raise CohortFailed(attempt, last_rc)
