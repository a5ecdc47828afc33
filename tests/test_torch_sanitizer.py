"""The port's concurrency sanitizer (``core/sanitizer_rt.py``) and
replay-purity scanner (``analysis/sanitizer.py``) held to the JAX
package's (``tests/test_sanitizer.py``).

Each seeded bug (a lock-order inversion, a waits-for deadlock cycle, a
lost wakeup under the stall watchdog, an alignment-blind gate and a
freeze-blind split coordinator) is run through both packages' sanitizer
and gives the same violation kinds; healthy gates, coordinators and
mailboxes stay clean; a sanitized chained rebalance job with checkpoints
reports no violation; and with the sanitizer off the gates hold plain
``threading`` primitives.  The scanners give the same ``(kind, symbol,
line)`` findings for the reference test's user functions
(``tests/test_sanitizer.py:431-520``)."""

import importlib
import os
import random
import tempfile
import threading
import time
import types

import numpy as np
import pytest

from flink_tensorflow_tpu.analysis import sanitizer as jscan
from flink_tensorflow_tpu_torch.analysis import sanitizer as pscan


def _pkg(name):
    mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
    return types.SimpleNamespace(
        rt=mod("core.sanitizer_rt"), channels=mod("core.channels"), el=mod("core.elements"),
        coord=mod("sources.coordinator"), mailbox=mod("sources.mailbox"),
        sources=mod("sources"), fn=mod("core.functions"), env=mod("core.environment"),
        runtime=mod("core.runtime"))


PKGS = {"jax": _pkg("flink_tensorflow_tpu"), "torch": _pkg("flink_tensorflow_tpu_torch")}


def _kinds(san):
    return [v.kind for v in san.violations]


# -- seeded bugs: the same kinds from both packages ---------------------------------

def seeded_inversion(p):
    san = p.rt.ConcurrencySanitizer("t")
    a, b = san.lock("A"), san.lock("B")

    def ab():
        with a:
            with b:
                pass

    def ba():
        with b:
            with a:
                pass

    for body in (ab, ba, ba):  # sequential: the order alone is the bug
        t = threading.Thread(target=body)
        t.start()
        t.join(5.0)
    with pytest.raises(p.rt.SanitizerError):
        san.check()
    return san


def seeded_deadlock_cycle(p):
    san = p.rt.ConcurrencySanitizer("t")
    a, b = san.lock("A"), san.lock("B")
    holds_a, release_a = threading.Event(), threading.Event()

    def t1():
        with a:
            holds_a.set()
            release_a.wait(10.0)
            with b:  # blocks: the test thread holds B
                pass

    th = threading.Thread(target=t1, daemon=True)
    th.start()
    assert holds_a.wait(5.0)
    b.acquire()
    release_a.set()
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        with san._mu:
            if any(w[0] == "lock" and w[1] == "B" for w in san._waiting.values()):
                break
        time.sleep(0.01)
    with pytest.raises(p.rt.SanitizerError, match="waits-for cycle"):
        a.acquire()  # closes the cycle: raises instead of hanging
    b.release()
    th.join(5.0)
    assert not th.is_alive()
    return san


def seeded_lost_wakeup(p):
    san = p.rt.ConcurrencySanitizer("t", stall_timeout_s=0.3)
    cond = san.condition("mbox.cond")
    parked = threading.Event()

    def buggy_wait():
        with cond:
            parked.set()
            cond.wait()  # untimed, and its notify came before the park

    with cond:
        cond.notify()
    th = threading.Thread(target=buggy_wait, daemon=True, name="lost-wakeup-victim")
    th.start()
    assert parked.wait(5.0)
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and "stall" not in _kinds(san):
        time.sleep(0.05)
    stall = next(v for v in san.violations if v.kind == "stall")
    assert "mbox.cond" in stall.message
    assert stall.dump and "state dump" in stall.dump and "buggy_wait" in stall.dump
    san.shutdown()
    with cond:
        cond.notify_all()
    th.join(5.0)
    return san


def seeded_alignment_blind_gate(p):
    class AlignmentBlindGate(p.channels.InputGate):
        """Delivers an element of a blocked channel instead of stashing it."""

        def poll(self, timeout=None):
            with self._not_empty:
                if not self._queue:
                    return None
                idx, element = self._queue.popleft()
            if self._san is not None:
                self._san.gate_delivered(self._san_name, idx)
            return idx, element

    san = p.rt.ConcurrencySanitizer("t")
    gate = AlignmentBlindGate(2, sanitizer=san, name="g")
    gate.block_channel(0)
    p.channels.ChannelWriter(gate, 0).write(p.el.StreamRecord(1, None))
    assert gate.poll(timeout=0.5) is not None
    return san


def seeded_freeze_blind_coordinator(p):
    class FreezeBlindCoordinator(p.coord.SplitCoordinator):
        def poll_split(self, reader_index):
            with self._lock:
                return self._dispense_locked(reader_index)

    san = p.rt.ConcurrencySanitizer("t")
    src = p.sources.ReplaySplitSource(list(range(20)), num_splits=4)
    coord = FreezeBlindCoordinator(src, 2, sanitizer=san, name="replay")
    coord.on_barrier(1, 0)  # frozen: reader 1 has not passed
    status, split = coord.poll_split(1)
    assert status == p.coord.ASSIGNED and split is not None
    return san


def seeded_snapshot_order(p):
    san = p.rt.ConcurrencySanitizer("t")
    for pos in range(3):
        san.chain_snapshot("op.0", 1, pos, 3)
        san.chain_snapshot("op.0", 2, pos, 3)
    assert san.violations == []
    san.chain_snapshot("op.0", 3, 0, 3)
    san.chain_snapshot("op.0", 3, 2, 3)
    return san


SEEDED = {
    "inversion": (seeded_inversion, ["lock-order-inversion"]),
    "deadlock_cycle": (seeded_deadlock_cycle, ["deadlock-cycle"]),
    "lost_wakeup": (seeded_lost_wakeup, ["stall"]),
    "alignment_blind_gate": (seeded_alignment_blind_gate, ["barrier-blocked-channel"]),
    "freeze_blind_coordinator": (seeded_freeze_blind_coordinator, ["assignment-freeze"]),
    "snapshot_order": (seeded_snapshot_order, ["snapshot-order"]),
}


@pytest.mark.parametrize("case", sorted(SEEDED))
def test_seeded_bug_gives_the_same_violation_kinds(case):
    body, want = SEEDED[case]
    kinds = {name: _kinds(body(p)) for name, p in PKGS.items()}
    assert kinds["torch"] == kinds["jax"] == want


# -- healthy machinery stays clean ----------------------------------------------------

@pytest.mark.parametrize("name", sorted(PKGS))
def test_consistent_lock_order_and_timed_waits_are_clean(name):
    rt = PKGS[name].rt
    san = rt.ConcurrencySanitizer("t", stall_timeout_s=0.1)
    a, b = san.lock("A"), san.lock("B")
    for _ in range(3):
        with a:
            with b:
                pass
    cond = san.condition("c")
    with cond:
        cond.wait(0.3)  # timed: wakes itself, never a stall
    time.sleep(0.2)
    san.shutdown()
    assert san.violations == []
    assert san.report().startswith("sanitizer[t]: clean")


def test_healthy_gate_stashes_and_stays_clean():
    p = PKGS["torch"]
    san = p.rt.ConcurrencySanitizer("t")
    gate = p.channels.InputGate(2, sanitizer=san, name="g")
    gate.block_channel(0)
    p.channels.ChannelWriter(gate, 0).write(p.el.StreamRecord(1, None))
    p.channels.ChannelWriter(gate, 1).write(p.el.StreamRecord(2, None))
    idx, e = gate.poll(timeout=1.0)
    assert (idx, e.value) == (1, 2)
    gate.unblock_all()
    idx, e = gate.poll(timeout=1.0)
    assert (idx, e.value) == (0, 1)
    assert san.violations == []
    kinds = [ev[0] for ev in san._hb]
    assert kinds == ["align.block", "align.unblock"]


def test_healthy_coordinator_waits_through_the_freeze_and_stays_clean():
    p = PKGS["torch"]
    san = p.rt.ConcurrencySanitizer("t")
    src = p.sources.ReplaySplitSource(list(range(20)), num_splits=4)
    coord = p.coord.SplitCoordinator(src, 2, sanitizer=san, name="replay")
    coord.on_barrier(1, 0)
    assert coord.poll_split(1) == (p.coord.WAIT, None)
    coord.on_barrier(1, 1)
    assert coord.poll_split(1)[0] == p.coord.ASSIGNED
    assert san.violations == []


def test_sanitized_mailbox_roundtrip_and_close():
    p = PKGS["torch"]
    san = p.rt.ConcurrencySanitizer("t")
    m = p.mailbox.SourceMailbox(sanitizer=san, name="src.0.mailbox")
    m.notify()
    assert m.wait(0.0) is True
    m.close()
    assert m.wait(None) is True
    assert san.violations == []
    assert m._cond.name == "src.0.mailbox"


@pytest.mark.parametrize("sanitize", [False, True])
def test_parallel_split_source_with_count_checkpoints_completes(sanitize, tmp_path):
    """Twin of ``TestFreezeDeadlockRegression``: split readers parked on a
    frozen assignment still cut their barriers."""
    p = PKGS["torch"]
    env = p.env.StreamExecutionEnvironment(parallelism=2)
    env.configure(sanitize=sanitize)
    env.enable_checkpointing(str(tmp_path), every_n_records=16)
    src = p.sources.ReplaySplitSource(list(range(200)), num_splits=8)
    out = (env.from_source(src, name="replay", parallelism=2)
           .map(lambda v: v, name="ident", parallelism=2)
           .sink_to_list())
    env.execute("freeze-deadlock-regression", timeout=120)
    assert sorted(out) == list(range(200))
    if sanitize:
        assert env.metric_registry.report()["sanitizer.violations"] == 0


@pytest.mark.parametrize("name", sorted(PKGS))
def test_chained_rebalance_checkpoint_job_is_clean(name):
    p = PKGS[name]
    with tempfile.TemporaryDirectory() as d:
        env = p.env.StreamExecutionEnvironment(parallelism=2)
        env.configure(sanitize=True)
        env.enable_checkpointing(d, every_n_records=8)
        out = (env.from_collection(list(range(64)), parallelism=1)
               .map(lambda v: v + 1, name="inc", parallelism=1)
               .rebalance()
               .map(lambda v: v * 2, name="dbl", parallelism=2)
               .sink_to_list())
        env.execute("sanitized-job", timeout=120)
        assert sorted(out) == sorted((v + 1) * 2 for v in range(64))
        snap = env.metric_registry.report()
        assert snap["sanitizer.violations"] == 0
        assert snap["sanitizer.tracked_ops"] > 0
        assert snap["sanitizer.cohort.hb_recorded"] > 0


def test_a_violation_fails_the_join_with_sanitizer_error(tmp_path):
    """A violation recorded while the job runs surfaces at ``join`` as a
    ``SanitizerError`` (not a ``JobFailure``: no restart replays over it),
    and the happens-before log is dumped for the violation."""
    p = PKGS["torch"]
    hb = str(tmp_path / "hb.json")

    class Inverting(p.fn.MapFunction):
        def open(self, ctx):
            self._a, self._b = ctx.sanitizer.lock("user.A"), ctx.sanitizer.lock("user.B")

        def map(self, value):
            first, second = (self._a, self._b) if value % 2 else (self._b, self._a)
            with first:
                with second:
                    return value

    env = p.env.StreamExecutionEnvironment(parallelism=1)
    env.configure(sanitize=True, sanitize_log_path=hb)
    env.from_collection([1, 2, 3]).map(Inverting(), name="inv").sink_to_list()
    with pytest.raises(p.rt.SanitizerError) as err:
        env.execute("inverting", timeout=60)
    assert not isinstance(err.value, p.runtime.JobFailure)
    doc = p.rt.load_hb_log(hb)
    assert doc["reason"] == "violation"
    assert [v["kind"] for v in doc["violations"]] == ["lock-order-inversion"]


def test_env_var_enables_the_sanitizer(monkeypatch):
    p = PKGS["torch"]
    monkeypatch.setenv("FLINK_TPU_SANITIZE", "1")
    assert p.rt.env_enabled()
    env = p.env.StreamExecutionEnvironment(parallelism=1)
    env.from_collection([1, 2, 3]).sink_to_list()
    assert p.runtime.LocalExecutor(env.graph).sanitizer is not None


@pytest.mark.parametrize("name", sorted(PKGS))
def test_off_by_default_no_instrumentation(name, monkeypatch):
    monkeypatch.delenv("FLINK_TPU_SANITIZE", raising=False)
    p = PKGS[name]
    env = p.env.StreamExecutionEnvironment(parallelism=1)
    # A rebalance edge cuts the chain, so the job has gates.
    env.from_collection([1, 2, 3]).rebalance().map(lambda v: v, parallelism=2).sink_to_list()
    ex = p.runtime.LocalExecutor(env.graph)
    assert ex.sanitizer is None
    assert ex._gates
    for gate in ex._gates:
        assert gate._san is None
        assert isinstance(gate._lock, type(threading.Lock()))
    assert isinstance(ex.coordinator._lock, type(threading.Lock()))


def test_shake_mode_reads_its_seed(monkeypatch):
    p = PKGS["torch"]
    monkeypatch.setenv("FLINK_TPU_SANITIZE_SHAKE", "20260806")
    san = p.rt.ConcurrencySanitizer("t")
    assert san.shake_seed == 20260806
    lock = san.lock("L")
    for _ in range(20):
        with lock:
            pass
    assert san.violations == []


# -- the replay-purity scanner ----------------------------------------------------------

_SCAN_GLOBAL = 0


def _impure_process_element(self, value, ctx, out):
    out.collect((value, time.time(), random.random()))


def _io_process_element(self, value, ctx, out):
    with open("/tmp/never-written", "a") as f:  # noqa: F841
        pass
    out.collect(value)


def _global_mut_map(self, value):
    global _SCAN_GLOBAL
    _SCAN_GLOBAL += 1
    return value


def _seeded(v):
    rng = np.random.RandomState(0)
    return v + float(rng.rand())


def _helper_clock():
    return time.perf_counter()


def _calls_a_helper(v):
    return v + _helper_clock()


def _user_objects(p):
    """The reference test's user functions, bound to each package's base
    classes (the scanners skip their own package's code only)."""
    acc = []
    cls = lambda n, base, **m: type(n, (base,), m)()  # noqa: E731
    return {
        "impure_keyed": cls("_ImpureKeyedFn", p.fn.ProcessFunction,
                            process_element=_impure_process_element),
        "io_keyed": cls("_IOKeyedFn", p.fn.ProcessFunction, process_element=_io_process_element),
        "global_mut": cls("_GlobalMutFn", p.fn.MapFunction, map=_global_mut_map),
        "wallclock_lambda": lambda v: (v, time.time()),
        "closure_lambda": lambda v: acc.append(v) or v,
        "pure_lambda": lambda v: v * 2,
        "seeded": _seeded,
        "helper_chain": _calls_a_helper,
        "np_global_rng": lambda v: v + np.random.rand(),
    }


def _findings(scan, objs):
    return {name: sorted((f.kind, f.symbol, f.line) for f in scan.scan_callable(obj))
            for name, obj in objs.items()}


def test_scanners_give_the_same_findings():
    got_j = _findings(jscan, _user_objects(PKGS["jax"]))
    got_t = _findings(pscan, _user_objects(PKGS["torch"]))
    assert got_t == got_j
    kinds = {name: {k for k, _, _ in rows} for name, rows in got_t.items()}
    assert kinds["impure_keyed"] == {"wall-clock", "unseeded-random"}
    assert kinds["io_keyed"] == {"io"}
    assert kinds["global_mut"] == {"global-mutation"}
    assert kinds["closure_lambda"] == {"mutable-closure"}
    assert kinds["helper_chain"] == {"wall-clock"}
    assert kinds["np_global_rng"] == {"unseeded-random"}
    assert kinds["pure_lambda"] == kinds["seeded"] == set()


def test_the_reference_test_functions_scan_the_same():
    """The classes of ``tests/test_sanitizer.py`` themselves, their methods
    scanned as bare functions by both scanners."""
    path = os.path.join(os.path.dirname(__file__), "test_sanitizer.py")
    spec = importlib.util.spec_from_file_location("_jax_test_sanitizer", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    for cls, meth in ((module._ImpureKeyedFn, "process_element"),
                      (module._IOKeyedFn, "process_element"), (module._GlobalMutFn, "map")):
        fn = getattr(cls, meth)
        j = sorted((f.kind, f.symbol, f.line, f.where) for f in jscan.scan_callable(fn))
        t = sorted((f.kind, f.symbol, f.line, f.where) for f in pscan.scan_callable(fn))
        assert t == j and t


def test_the_port_is_framework_code_to_its_own_scanner():
    from flink_tensorflow_tpu_torch.core import stream

    fn = stream.DataStream.map
    assert pscan.scan_code(fn.__code__, fn.__globals__) is not None
    assert not pscan._is_user_code(fn.__code__)
    assert pscan._is_user_code(_seeded.__code__)
    op = types.SimpleNamespace(function=_user_objects(PKGS["torch"])["impure_keyed"],
                               key_selector=lambda v: v)
    assert {f.kind for f in pscan.scan_operator(op)} == {"wall-clock", "unseeded-random"}
