"""The port's cohort supervisor (``parallel/supervisor.py``) held to the
JAX package's.

The policy cases run both supervisors over the same ``python -c`` worker
commands; each ``command`` callable records the ``(worker, num_workers,
attempt)`` spawns it was asked for, and the two sequences and outcomes must be
equal: a restart after one worker fails, giving up after
``max_restarts``, an attempt cut at ``attempt_timeout_s`` (its worker,
deaf to SIGTERM, killed after ``kill_grace_s``), elastic shrink after a
permanent loss, and regrowth at a restart boundary when a
``capacity_probe`` reports the worker back (a regrown shape that fails
its budget is barred).  ``latest_common_checkpoint`` is compared on
directories both stores wrote.

The gang case is the card phase's supervised restart on the CPU: two
gloo ranks of ``tests/_torch_dist_worker.py`` (the resnet-train job of
``functions/train_cell.py:run_supervised_resnet`` on a small ResNet),
count-based checkpoints every 2 steps; on attempt 0 the last rank exits
at step 5, the supervisor kills the other and restarts both, and they
restore from the newest checkpoint both hold.  The restored run's steps,
losses, params and batch statistics equal an uninterrupted supervised
run's bit for bit.
"""

import os
import socket
import sys
import threading

import numpy as np
import pytest
import torch

from flink_tensorflow_tpu.checkpoint.store import write_checkpoint as jax_write_checkpoint
from flink_tensorflow_tpu.parallel.supervisor import CohortFailed as JaxCohortFailed
from flink_tensorflow_tpu.parallel.supervisor import CohortSupervisor as JaxSupervisor
from flink_tensorflow_tpu.parallel.supervisor import (
    latest_common_checkpoint as jax_latest_common,
)
from flink_tensorflow_tpu_torch.checkpoint.store import write_checkpoint
from flink_tensorflow_tpu_torch.functions.train_cell import FAIL_EXIT_CODE
from flink_tensorflow_tpu_torch.parallel import (
    CohortFailed,
    CohortOutcome,
    CohortSupervisor,
    latest_common_checkpoint,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_dist_worker.py")
SUPERVISORS = {"port": (CohortSupervisor, CohortFailed),
               "jax": (JaxSupervisor, JaxCohortFailed)}


def exits(rc: int):
    return [sys.executable, "-S", "-c", f"import sys; sys.exit({rc})"]


def supervise(pkg, policy, num_workers, **kw):
    """Run ``pkg``'s supervisor over ``policy(worker, num_workers,
    attempt) -> argv``; the spawns asked for, and the outcome (or the
    failure's attempts and last rc)."""
    sup_cls, failed_cls = SUPERVISORS[pkg]
    spawns = []

    def command(w, n, a):
        spawns.append((w, n, a))
        return policy(w, n, a)

    sup = sup_cls(command, num_workers, poll_s=0.02, **kw)
    try:
        outcome = sup.run()
        result = ("ok", outcome.attempts, outcome.returncode, outcome.num_workers)
    except failed_cls as exc:
        result = ("failed", exc.attempts, exc.last_rc)
    return spawns, result


def both(policy, num_workers, **kw):
    got = supervise("port", policy, num_workers, **kw)
    assert got == supervise("jax", policy, num_workers, **kw)
    return got


def test_restarts_the_cohort_on_failure(tmp_path):
    def policy(w, n, a):
        fail = a == 0 and w == 1
        body = (f"import sys, pathlib; pathlib.Path(r'{tmp_path}', 'w{w}_a{a}').touch(); "
                f"sys.exit({1 if fail else 0})")
        return [sys.executable, "-S", "-c", body]

    spawns, result = both(policy, 2, max_restarts=2)
    assert spawns == [(0, 2, 0), (1, 2, 0), (0, 2, 1), (1, 2, 1)]
    assert result == ("ok", 2, 0, 2)
    assert sorted(os.listdir(tmp_path)) == ["w0_a0", "w0_a1", "w1_a0", "w1_a1"]


def test_gives_up_after_max_restarts():
    spawns, result = both(lambda w, n, a: exits(3), 2, max_restarts=1)
    assert spawns == [(0, 2, 0), (1, 2, 0), (0, 2, 1), (1, 2, 1)]
    assert result == ("failed", 2, 3)


def test_attempt_timeout_kills_the_cohort_and_restarts(tmp_path):
    """Attempt 0's worker 1 ignores SIGTERM and sleeps past the attempt's
    time limit: the attempt fails with rc -1, the worker is killed after
    the grace, and attempt 1 succeeds."""
    pids = {}

    def policy(w, n, a):
        if a == 0 and w == 1:
            pid_file = tmp_path / f"pid-{len(pids)}"
            pids[len(pids)] = pid_file
            body = ("import os, signal, time; signal.signal(signal.SIGTERM, signal.SIG_IGN); "
                    f"open(r'{pid_file}', 'w').write(str(os.getpid())); time.sleep(60)")
            return [sys.executable, "-S", "-c", body]
        return exits(0)

    spawns, result = both(policy, 2, max_restarts=1, attempt_timeout_s=1.0, kill_grace_s=0.3)
    assert spawns == [(0, 2, 0), (1, 2, 0), (0, 2, 1), (1, 2, 1)]
    assert result == ("ok", 2, 0, 2)
    for pid_file in pids.values():
        pid = int(pid_file.read_text())
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)   # reaped: killed by the supervisor


def test_elastic_shrink_after_a_permanent_loss():
    """Worker 2 of 3 never comes back: the shape-3 budget burns, the
    cohort re-forms at 2 and succeeds."""
    def policy(w, n, a):
        return exits(7 if (n == 3 and w == 2) else 0)

    spawns, result = both(policy, 3, max_restarts=1, elastic=True, min_workers=2)
    assert spawns == [(0, 3, 0), (1, 3, 0), (2, 3, 0), (0, 3, 1), (1, 3, 1), (2, 3, 1),
                      (0, 2, 2), (1, 2, 2)]
    assert result == ("ok", 3, 0, 2)


def test_elastic_regrow_with_a_capacity_probe():
    """Shape 3 fails twice (shrink to 2), shape 2 fails once (the probe
    says 3 are back: regrow), then the regrown 3 succeeds."""
    def policy(w, n, a):
        return exits(1 if a in (0, 1, 2) else 0)

    spawns, result = both(policy, 3, max_restarts=1, elastic=True, min_workers=2,
                          capacity_probe=lambda: 3)
    assert [(n, a) for _, n, a in spawns if _ == 0] == [(3, 0), (3, 1), (2, 2), (3, 3)]
    assert result == ("ok", 4, 0, 3)


def test_elastic_regrow_budget_exhaustion_bars_oscillation():
    """A probe that always reports 3: a regrown shape 3 that burns its
    budget is barred, and the cohort settles at 2."""
    def policy(w, n, a):
        if n == 3:
            return exits(3)
        return exits(1 if a == 2 else 0)

    spawns, result = both(policy, 3, max_restarts=1, elastic=True, min_workers=2,
                          capacity_probe=lambda: 3)
    assert [(n, a) for w, n, a in spawns if w == 0] == [(3, 0), (3, 1), (2, 2), (3, 3),
                                                        (3, 4), (2, 5)]
    assert result == ("ok", 6, 0, 2)


@pytest.mark.parametrize("kw", [dict(num_workers=0), dict(num_workers=2, min_workers=3),
                                dict(num_workers=2, capacity_probe=lambda: 2)])
def test_rejects_bad_arguments(kw):
    n = kw.pop("num_workers")
    for sup_cls, _ in SUPERVISORS.values():
        with pytest.raises(ValueError):
            sup_cls(lambda w, n, a: exits(0), n, **kw)


def test_latest_common_checkpoint(tmp_path):
    got = {}
    for pkg, (write, common) in {"port": (write_checkpoint, latest_common_checkpoint),
                                 "jax": (jax_write_checkpoint, jax_latest_common)}.items():
        d0, d1 = str(tmp_path / pkg / "w0"), str(tmp_path / pkg / "w1")
        for cid in (1, 2, 3):
            write(d0, cid, {"t": {0: {"x": cid}}})
        for cid in (1, 2):   # w1 died before its checkpoint 3 completed
            write(d1, cid, {"t": {0: {"x": cid}}})
        os.makedirs(os.path.join(d1, "chk-000003.tmp"))   # a half-written one
        got[pkg] = (common([d0, d1]), common([d0, str(tmp_path / "missing")]), common([d0]))
    assert got["port"] == got["jax"] == (2, None, 3)


def test_outcome_fields_equal_the_references():
    from flink_tensorflow_tpu.parallel.supervisor import CohortOutcome as JaxOutcome

    assert CohortOutcome(2, 0, 3) == CohortOutcome(attempts=2, returncode=0, num_workers=3)
    assert ([f for f in CohortOutcome.__dataclass_fields__]
            == [f for f in JaxOutcome.__dataclass_fields__])


# -- the supervised gang ------------------------------------------------------------
GANG_CFG = dict(num_classes=4, image_size=32, width=8, stage_sizes=(1, 1), uint8_input=True)
GANG_TIMEOUT_S = 60.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def gang_run(directory, inputs, fail_at_step, procs):
    """A port supervisor over two ``supervised`` ranks in ``directory``;
    the outcome and the ranks' results of the successful attempt."""
    from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, spec

    os.makedirs(directory, exist_ok=True)
    torch.save(dict(inputs, schema=RecordSchema({"image": spec((32, 32, 3), np.uint8),
                                                 "label": spec((), np.int32)})),
               os.path.join(directory, "in.pt"))
    ports = {}
    env = {"OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}

    def command(w, n, a):
        port = ports.setdefault(a, free_port())
        cmd = [sys.executable, WORKER, "--scenario", "supervised", "--rank", str(w),
               "--world", str(n), "--port", str(port), "--dir", str(directory),
               "--attempt", str(a)]
        return cmd + (["--fail-at-step", str(fail_at_step)] if fail_at_step else [])

    sup = CohortSupervisor(command, 2, env=lambda w, n, a: env, max_restarts=1, poll_s=0.05,
                           kill_grace_s=5.0, attempt_timeout_s=GANG_TIMEOUT_S)
    spawn = sup._spawn

    def recorded(attempt, num_workers):
        started = spawn(attempt, num_workers)
        procs.extend(started)
        return started

    sup._spawn = recorded
    outcome = sup.run()
    ranks = [torch.load(os.path.join(directory, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    return outcome, ranks


def test_the_supervisor_restarts_the_gang_from_the_latest_common_checkpoint(tmp_path):
    rng = np.random.RandomState(5)
    records = 48
    inputs = {"config": GANG_CFG, "global_batch": 8, "every_n": 8,
              "images": rng.randint(0, 256, (records, 32, 32, 3)).astype(np.uint8),
              "labels": (np.arange(records) % 4).astype(np.int32)}
    procs, results = [], {}

    def run(name, fail_at_step):
        results[name] = gang_run(tmp_path / name, inputs, fail_at_step, procs)

    threads = [threading.Thread(target=run, args=args)
               for args in (("uninterrupted", None), ("failed", 5))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert set(results) == {"uninterrupted", "failed"}, "a supervisor raised"
    (clean, want), (outcome, got) = results["uninterrupted"], results["failed"]
    assert clean == CohortOutcome(attempts=1, returncode=0, num_workers=2)
    assert outcome == CohortOutcome(attempts=2, returncode=0, num_workers=2)
    assert all(p.poll() is not None for p in procs), "a rank outlived its attempt"
    assert len(procs) == 6
    for r in range(2):
        # Checkpoints every 2 steps; the last rank left at step 5, after
        # checkpoint 2, which both ranks hold: steps 5 and 6 run again.
        assert got[r]["attempt"] == 1 and got[r]["restored_checkpoint"] == 2
        assert got[r]["num_processes"] == 2
        assert [s for s, _ in want[r]["steps"]] == list(range(1, 7))
        assert got[r]["steps"] == want[r]["steps"][4:]
        for coll in ("params", "batch_stats"):
            for name, t in want[r]["params"][coll].items():
                assert torch.equal(got[r]["params"][coll][name], t), (coll, name)
    assert want[0]["steps"] == want[1]["steps"]
    assert sorted(p.returncode for p in procs).count(0) == 4
    assert FAIL_EXIT_CODE in [p.returncode for p in procs]
