"""Chaos plane: deterministic fault injection at the runtime's seams.

Port of ``flink_tensorflow_tpu/core/faults.py``.  A :class:`FaultPlan` is
a deterministic schedule of faults over ``(restart epoch, stream
position)``; the :class:`FaultInjector` fires them at hook sites the
runtime already has:

- ``kill``: raise :class:`InjectedFault` inside a subtask's record loop
  after its K-th record (``_Subtask.run_source`` / ``run_split_source`` /
  ``run_worker``), as a user-code crash would: the job fails and the
  restart strategy or the cohort supervisor recovers it from the last
  checkpoint.
- ``stall``: sleep ``duration_s`` in the record loop at record K, the
  wedged operator that holds barrier alignment past the checkpoint
  deadline (the coordinator's sweeper aborts the checkpoint).
- ``sever``: raise a connection error at the K-th frame sent on an edge
  (``RemoteChannelWriter`` / ``RemoteSink``), so the writer's
  reconnect and the restart-epoch fence carry the records through.
- ``blackhole``: drop that edge's frames for ``duration_s`` after the
  K-th, a hung but live peer that only heartbeats catch.
- ``delay``: sleep ``duration_s`` before each of the next ``count``
  sends on the edge (a degraded link), with a seeded ±10% jitter.
- ``store_fail``: fail the checkpoint-store write of checkpoint id K
  (``CheckpointCoordinator``): the checkpoint is declined, no 2PC commit
  goes out for it, and a later checkpoint succeeds.

Every fault is pinned to a stream position (a subtask's own record
count, an edge's own frame count, a checkpoint id) and a restart epoch,
so the same plan over the same job gives the same run, and a test holds
``read_committed()`` equal to the clean run's byte for byte.  ``seed``
feeds only the ``delay`` jitter.

Off costs nothing: without a plan the executor holds ``faults=None`` and
each hook site is one ``is None`` test.  Turn it on with
``JobConfig.faults`` (a :class:`FaultPlan`, a spec string or a list of
specs) or the ``FLINK_TPU_FAULTS`` environment variable, which wins.

Spec grammar (``;``-separated entries)::

    kill:<task>.<index>@<record>            crash the subtask
    stall:<task>.<index>@<record>~<secs>    wedge the subtask
    sever:<task>.<index>@<frame>            cut the edge INTO task.index
    blackhole:<task>.<index>@<frame>~<secs> drop that edge's frames
    delay:<task>.<index>@<frame>~<secs>[x<count>]
    store_fail@<checkpoint_id>

An entry may carry ``#<epoch>`` to fire on that restart epoch (default 0,
the first attempt only, so a restarted run replays cleanly instead of
crash-looping through its restart budget).  Example::

    FLINK_TPU_FAULTS="kill:count.0@50;store_fail@2;stall:count.1@80~0.5#1"

Every fired fault ticks a ``faults.<kind>`` meter (:func:`fired_counts`
reads them back from a metric report) and is kept in
:attr:`FaultInjector.fired`.  ``flight`` is the executor's flight
recorder (None when it is off): each firing lands there as a ``<kind>``
record on the ``faults`` track.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import random
import re
import threading
import time
import typing

logger = logging.getLogger(__name__)

KINDS = ("kill", "stall", "sever", "blackhole", "delay", "store_fail")
#: Edge-directed kinds (fire inside a remote writer's send path).
EDGE_KINDS = ("sever", "blackhole", "delay")


def fired_counts(report: typing.Mapping[str, typing.Any]) -> typing.Dict[str, int]:
    """``{kind: count}`` of the faults that fired, from a metric report's
    ``faults.<kind>`` meters (kinds that never fired are left out)."""
    return {kind: report[f"faults.{kind}"]["count"] for kind in KINDS
            if isinstance(report.get(f"faults.{kind}"), dict)
            and report[f"faults.{kind}"]["count"]}


class InjectedFault(RuntimeError):
    """A scheduled ``kill`` fired.  Deliberately an ordinary runtime
    error: the job must fail exactly as it would for a user-code crash,
    and restart strategies must recover it."""


class InjectedStoreFailure(OSError):
    """A scheduled ``store_fail`` fired inside a checkpoint persist."""


class InjectedConnectionError(ConnectionError):
    """A scheduled ``sever`` fired inside a remote edge's send path."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.  ``task``/``index`` target a subtask scope
    (record faults) or the subtask an edge feeds (edge faults);
    ``at`` is the 1-based record/frame count (or the checkpoint id for
    ``store_fail``) at which the fault fires on restart ``epoch``."""

    kind: str
    task: str = ""
    index: int = 0
    at: int = 1
    duration_s: float = 0.0
    count: int = 1
    epoch: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} (one of {KINDS})")
        if self.at < 1:
            raise ValueError(f"fault position must be >= 1, got {self.at}")
        if self.duration_s < 0:
            raise ValueError(f"duration_s must be >= 0, got {self.duration_s}")
        if self.count < 1:
            raise ValueError(f"count must be >= 1, got {self.count}")
        if self.epoch < 0:
            raise ValueError(f"epoch must be >= 0, got {self.epoch}")

    @property
    def scope(self) -> str:
        return f"{self.task}.{self.index}"


_SPEC_RE = re.compile(
    r"^(?P<kind>[a-z_]+)"
    r"(?::(?P<task>.+?)\.(?P<index>\d+))?"
    r"@(?P<at>\d+)"
    r"(?:~(?P<duration>[0-9.]+))?"
    r"(?:x(?P<count>\d+))?"
    r"(?:#(?P<epoch>\d+))?$"
)


def parse_fault_spec(text: str) -> FaultSpec:
    m = _SPEC_RE.match(text.strip())
    if m is None:
        raise ValueError(
            f"unparseable fault spec {text!r} — expected "
            "kind[:task.index]@at[~duration][xcount][#epoch]"
        )
    kind = m.group("kind")
    if kind != "store_fail" and m.group("task") is None:
        raise ValueError(f"fault spec {text!r}: kind {kind!r} needs a task.index target")
    return FaultSpec(
        kind=kind,
        task=m.group("task") or "",
        index=int(m.group("index") or 0),
        at=int(m.group("at")),
        duration_s=float(m.group("duration") or 0.0),
        count=int(m.group("count") or 1),
        epoch=int(m.group("epoch") or 0),
    )


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable, deterministic fault schedule for one job."""

    specs: typing.Tuple[FaultSpec, ...] = ()
    seed: int = 0

    @classmethod
    def parse(cls, text: str, *, seed: int = 0) -> "FaultPlan":
        specs = tuple(
            parse_fault_spec(entry)
            for entry in text.split(";") if entry.strip()
        )
        return cls(specs=specs, seed=seed)

    @classmethod
    def resolve(cls, value: typing.Any) -> typing.Optional["FaultPlan"]:
        """Normalize a JobConfig.faults value (plan / spec string / spec
        sequence / None), then let ``FLINK_TPU_FAULTS`` override."""
        env = os.environ.get("FLINK_TPU_FAULTS")
        if env:
            return cls.parse(env)
        if value is None:
            return None
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            return cls.parse(value)
        return cls(specs=tuple(
            parse_fault_spec(s) if isinstance(s, str) else s for s in value
        ))


class _Armed:
    """Mutable firing state of one spec (remaining count / window)."""

    __slots__ = ("spec", "remaining", "window_until")

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self.remaining = spec.count
        #: blackhole: monotonic time its drop window closes (armed at
        #: the first frame past ``at``).
        self.window_until: typing.Optional[float] = None


class FaultInjector:
    """Runtime half of the chaos plane: owns the armed specs for ONE
    executor (one restart epoch) and fires them at the hook sites.

    Thread-safety: each subtask/edge has its own position counter keyed
    by scope; arming state is guarded by one lock (hook sites are
    record-rate at most, and only while a plan is active)."""

    def __init__(self, plan: FaultPlan, *, epoch: int = 0,
                 metrics: typing.Optional[typing.Any] = None,
                 flight: typing.Optional[typing.Any] = None):
        self.plan = plan
        self.epoch = epoch
        self.flight = flight
        self._lock = threading.Lock()
        self._rng = random.Random(plan.seed)
        #: scope -> armed record-faults (kill/stall), sorted by position.
        self._record_specs: typing.Dict[str, typing.List[_Armed]] = {}
        #: scope -> armed edge-faults (sever/blackhole/delay).
        self._edge_specs: typing.Dict[str, typing.List[_Armed]] = {}
        #: checkpoint id -> armed store_fail.
        self._store_specs: typing.Dict[int, _Armed] = {}
        #: per-edge frame counters (record counters live in the subtask).
        self._edge_sent: typing.Dict[str, int] = {}
        #: every firing, for tests/post-mortems: (kind, scope, position).
        self.fired: typing.List[typing.Tuple[str, str, int]] = []
        self._meters: typing.Dict[str, typing.Any] = {}
        if metrics is not None:
            grp = metrics.group("faults")
            for kind in KINDS:
                self._meters[kind] = grp.meter(kind)
            grp.gauge("fired_total", lambda: len(self.fired))
        for spec in plan.specs:
            if spec.epoch != epoch:
                continue
            armed = _Armed(spec)
            if spec.kind in ("kill", "stall"):
                self._record_specs.setdefault(spec.scope, []).append(armed)
            elif spec.kind in EDGE_KINDS:
                self._edge_specs.setdefault(spec.scope, []).append(armed)
            else:
                self._store_specs[spec.at] = armed

    @property
    def active(self) -> bool:
        return bool(self._record_specs or self._edge_specs or self._store_specs)

    # -- firing ----------------------------------------------------------
    def _fire(self, spec: FaultSpec, position: int) -> None:
        self.fired.append((spec.kind, spec.scope or "store", position))
        meter = self._meters.get(spec.kind)
        if meter is not None:
            meter.mark()
        if self.flight is not None:
            self.flight.record("faults", spec.kind, {
                "target": spec.scope or "store",
                "at": position,
                "epoch": self.epoch,
                "duration_s": spec.duration_s,
            })
        logger.warning("fault injected: %s at %s@%d (epoch %d)",
                       spec.kind, spec.scope or "store", position, self.epoch)

    # -- hook: subtask record loops --------------------------------------
    def record_point(self, scope: str, offset: int) -> None:
        """Called after a subtask processed/emitted its ``offset``-th
        record; raises InjectedFault for a due ``kill``, sleeps for a
        due ``stall``."""
        armed_list = self._record_specs.get(scope)
        if not armed_list:
            return
        stall_s = 0.0
        kill: typing.Optional[FaultSpec] = None
        with self._lock:
            for armed in armed_list:
                if armed.remaining <= 0 or offset < armed.spec.at:
                    continue
                armed.remaining -= 1
                self._fire(armed.spec, offset)
                if armed.spec.kind == "kill":
                    kill = armed.spec
                else:
                    stall_s += armed.spec.duration_s
        if stall_s > 0:
            time.sleep(stall_s)
        if kill is not None:
            raise InjectedFault(
                f"injected kill: {scope} at record {offset} "
                f"(epoch {self.epoch})"
            )

    # -- hook: remote edges ----------------------------------------------
    def edge_hook(self, task: str, index: int) -> typing.Optional[
            typing.Callable[[], typing.Optional[str]]]:
        """A per-edge send hook for the writer feeding ``task.index``, or
        None when no spec targets that edge (the writer then keeps its
        zero-cost path).  The hook is called once per frame send and
        returns ``"drop"`` to blackhole the frame, raises
        :class:`InjectedConnectionError` for a sever, sleeps for a
        delay, and returns None to proceed."""
        scope = f"{task}.{index}"
        if scope not in self._edge_specs:
            return None

        def hook() -> typing.Optional[str]:
            return self._edge_point(scope)

        return hook

    def _edge_point(self, scope: str) -> typing.Optional[str]:
        now = time.monotonic()
        delay_s = 0.0
        action: typing.Optional[str] = None
        sever: typing.Optional[FaultSpec] = None
        with self._lock:
            sent = self._edge_sent.get(scope, 0) + 1
            self._edge_sent[scope] = sent
            for armed in self._edge_specs.get(scope, ()):
                spec = armed.spec
                if spec.kind == "blackhole":
                    if armed.window_until is not None:
                        if now < armed.window_until:
                            action = "drop"
                        continue
                    if armed.remaining > 0 and sent >= spec.at:
                        armed.remaining -= 1
                        armed.window_until = now + spec.duration_s
                        self._fire(spec, sent)
                        action = "drop"
                    continue
                if armed.remaining <= 0 or sent < spec.at:
                    continue
                armed.remaining -= 1
                self._fire(spec, sent)
                if spec.kind == "sever":
                    sever = spec
                else:  # delay
                    jitter = 1.0 + 0.1 * (2.0 * self._rng.random() - 1.0)
                    delay_s += spec.duration_s * jitter
        if delay_s > 0:
            time.sleep(delay_s)
        if sever is not None:
            raise InjectedConnectionError(
                f"injected sever: edge into {scope} at frame "
                f"{self._edge_sent[scope]} (epoch {self.epoch})"
            )
        return action

    # -- hook: checkpoint store ------------------------------------------
    def store_point(self, checkpoint_id: int) -> None:
        """Called before a checkpoint-store write; raises
        InjectedStoreFailure when checkpoint ``checkpoint_id``'s write
        is scheduled to fail."""
        with self._lock:
            armed = self._store_specs.get(checkpoint_id)
            if armed is None or armed.remaining <= 0:
                return
            armed.remaining -= 1
            self._fire(armed.spec, checkpoint_id)
        raise InjectedStoreFailure(
            f"injected store failure: checkpoint {checkpoint_id} "
            f"(epoch {self.epoch})"
        )
