"""Cohort supervisor: restart every process of a cohort from a checkpoint.

Port of ``flink_tensorflow_tpu/parallel/supervisor.py``.  The reference
takes failure detection from Flink: heartbeats between job and task
managers, and on a lost task manager the job restarts from its last
completed snapshot.  A cohort of ``torch.distributed`` processes cannot
shrink live either (a collective against a dead peer hangs), so recovery
restarts the cohort: on any worker's loss the supervisor kills the
survivors, spawns the whole cohort again, and the workers form their
process group anew and restore from their newest common checkpoint
(:func:`latest_common_checkpoint`).

The supervisor is a process of its own (the reference's job manager is a
separate JVM): workers stay ordinary job binaries with no supervision
code in them.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import signal
import subprocess
import time
import typing

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class CohortOutcome:
    """Result of supervising one cohort to completion."""

    attempts: int  # total spawn rounds used (1 = no failures)
    returncode: int  # 0 on success
    #: Worker count of the SUCCESSFUL attempt — smaller than the initial
    #: count when elastic recovery re-formed the cohort after permanent
    #: worker loss.
    num_workers: int = 0


class CohortFailed(RuntimeError):
    def __init__(self, attempts: int, last_rc: int):
        super().__init__(
            f"cohort failed after {attempts} attempt(s); last worker rc={last_rc}"
        )
        self.attempts = attempts
        self.last_rc = last_rc


class CohortSupervisor:
    """Spawns and supervises a cohort of worker processes.

    ``command(worker_id, num_workers, attempt)`` returns the argv for one
    worker; ``env(worker_id, num_workers, attempt)`` (optional) returns
    extra environment variables.  The attempt number lets ``command``
    pick a fresh coordinator port per round (a dead coordinator
    socket can linger in TIME_WAIT), lets workers decide to restore, and
    would fence the previous attempt's senders once a record plane crosses
    processes (the reference's ``DistributedConfig.restart_epoch``; the
    port has no such plane yet).

    Failure policy: the FIRST nonzero worker exit fails the whole attempt
    — the survivors are sent SIGTERM (SIGKILL after ``kill_grace_s``) and
    the cohort is re-spawned, up to ``max_restarts`` times.  Workers are
    responsible for restoring their state from the latest common
    checkpoint on re-spawn (restart-from-checkpoint, not live elasticity).

    **Elastic recovery** (``elastic=True``): exhausting the respawn
    budget at one cohort shape is treated as permanent worker loss, and
    instead of giving up the supervisor re-forms the cohort one worker
    smaller, down to ``min_workers``, with a fresh respawn budget per
    shape.  ``command`` receives the current ``num_workers``; the
    workers carry their state across the shape change (the reference's
    cohort-rescaling restore, which comes with the port's record plane).

    **Elastic scale-up** (``capacity_probe``): Flink's failover restores
    the original parallelism when resources return; here a zero-argument
    probe reports how many workers can be spawned now (slots seen by a
    scheduler, healthy hosts on a heartbeat list, ...).  A shrunken
    cohort never interrupts a healthy run to grow: at the next restart
    boundary (an attempt failed anyway) the supervisor asks the probe
    and, if capacity returned, re-forms at ``min(original, probe())``
    with a fresh budget (P-1 -> P).  A regrown shape that exhausts its
    own budget is barred from future growth — otherwise a probe that keeps reporting a
    flapping host back would oscillate P-1 <-> P forever instead of
    converging down.  Without a probe, cohorts only shrink (the default:
    the supervisor cannot know on its own whether a lost host is coming
    back).
    """

    def __init__(
        self,
        command: typing.Callable[[int, int, int], typing.Sequence[str]],
        num_workers: int,
        *,
        env: typing.Optional[typing.Callable[[int, int, int], typing.Mapping[str, str]]] = None,
        max_restarts: int = 2,
        poll_s: float = 0.1,
        kill_grace_s: float = 5.0,
        attempt_timeout_s: typing.Optional[float] = None,
        elastic: bool = False,
        min_workers: int = 1,
        capacity_probe: typing.Optional[typing.Callable[[], int]] = None,
    ):
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        if not 1 <= min_workers <= num_workers:
            raise ValueError(
                f"min_workers must be in [1, {num_workers}], got {min_workers}"
            )
        if capacity_probe is not None and not elastic:
            raise ValueError("capacity_probe requires elastic=True")
        self.command = command
        self.num_workers = num_workers
        self.env = env
        self.max_restarts = max_restarts
        self.poll_s = poll_s
        self.kill_grace_s = kill_grace_s
        self.attempt_timeout_s = attempt_timeout_s
        self.elastic = elastic
        self.min_workers = min_workers
        self.capacity_probe = capacity_probe

    # -- one attempt -------------------------------------------------------
    def _spawn(self, attempt: int, num_workers: int) -> typing.List[subprocess.Popen]:
        procs = []
        try:
            for w in range(num_workers):
                env = dict(os.environ)
                if self.env is not None:
                    env.update(self.env(w, num_workers, attempt))
                procs.append(
                    subprocess.Popen(
                        list(self.command(w, num_workers, attempt)), env=env
                    )
                )
                logger.info("attempt %d: spawned worker %d/%d (pid %d)",
                            attempt, w, num_workers, procs[-1].pid)
        except BaseException:
            # A failed spawn must not orphan the workers already started —
            # they would block forever waiting for the full cohort.
            self._kill_all(procs)
            raise
        return procs

    def _kill_all(self, procs: typing.List[subprocess.Popen]) -> None:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + self.kill_grace_s
        for p in procs:
            if p.poll() is None:
                remaining = deadline - time.monotonic()
                try:
                    p.wait(timeout=max(0.0, remaining))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()

    def _run_attempt(self, attempt: int, num_workers: int) -> int:
        """Returns 0 on cohort success, else the failing worker's rc."""
        procs = self._spawn(attempt, num_workers)
        deadline = (
            time.monotonic() + self.attempt_timeout_s
            if self.attempt_timeout_s is not None else None
        )
        try:
            while True:
                states = [p.poll() for p in procs]
                failed = [rc for rc in states if rc is not None and rc != 0]
                if failed:
                    logger.warning(
                        "attempt %d: worker failed rc=%s — killing cohort",
                        attempt, failed[0],
                    )
                    return failed[0]
                if all(rc == 0 for rc in states):
                    return 0
                if deadline is not None and time.monotonic() > deadline:
                    logger.warning("attempt %d: timed out — killing cohort", attempt)
                    return -1
                time.sleep(self.poll_s)
        finally:
            self._kill_all(procs)

    def _probe_capacity(self) -> int:
        """Current spawnable-worker count per the operator-supplied
        probe; 0 (never grow) without one or on probe failure."""
        if self.capacity_probe is None:
            return 0
        try:
            return int(self.capacity_probe())
        except Exception:  # noqa: BLE001 - a broken probe must not kill recovery
            logger.warning("capacity probe failed — not scaling up",
                           exc_info=True)
            return 0

    # -- public ------------------------------------------------------------
    def run(self) -> CohortOutcome:
        last_rc = -1
        shape = self.num_workers
        attempt = 0  # global, monotonic across shapes (port rotation etc.)
        budget = self.max_restarts + 1  # fresh per shape change
        barred: typing.Set[int] = set()  # shapes whose regrow budget failed
        grown = False  # current shape was reached by scaling UP
        while True:
            rc = self._run_attempt(attempt, shape)
            attempt += 1
            if rc == 0:
                return CohortOutcome(attempts=attempt, returncode=0,
                                     num_workers=shape)
            last_rc = rc
            budget -= 1
            if budget <= 0 and grown:
                # A regrown shape that exhausted its own budget is ruled
                # out for good: without the bar, a probe that keeps
                # reporting a flapping host back would oscillate
                # P-1 <-> P forever instead of converging down.
                barred.add(shape)
            # Scale-up leg (restart boundary): a shrunken cohort grows
            # back toward the original shape when capacity returned.
            if self.elastic and shape < self.num_workers:
                target = min(self.num_workers, self._probe_capacity())
                while target > shape and target in barred:
                    target -= 1
                if target > shape:
                    logger.warning(
                        "capacity returned (%d workers available) — "
                        "re-forming the cohort elastically at %d "
                        "(was %d)", target, target, shape,
                    )
                    shape = target
                    budget = self.max_restarts + 1
                    grown = True
                    continue
            if budget > 0:
                continue
            if self.elastic and shape > self.min_workers:
                # Respawn budget exhausted at this shape: treat it as
                # permanent worker loss and re-form one smaller with a
                # fresh budget.
                logger.warning(
                    "respawn budget exhausted at %d workers — re-forming "
                    "the cohort elastically at %d", shape, shape - 1,
                )
                shape -= 1
                budget = self.max_restarts + 1
                grown = False
                continue
            raise CohortFailed(attempt, last_rc)


def latest_common_checkpoint(
    worker_dirs: typing.Sequence[str],
) -> typing.Optional[int]:
    """Highest checkpoint id COMPLETED by every worker, or None.

    Per-process checkpoints are only globally consistent at trigger
    points all processes reached (deterministic count-based triggers —
    see DPTrainWindowFunction's multi-host contract); a worker that died
    mid-round may be one checkpoint behind its peers, so restoring the
    *latest common* id is the cohort-consistent choice.
    """
    from flink_tensorflow_tpu_torch.checkpoint.store import checkpoint_ids

    common: typing.Optional[set] = None
    for d in worker_dirs:
        ids = set(checkpoint_ids(d))
        common = ids if common is None else (common & ids)
    return max(common) if common else None
