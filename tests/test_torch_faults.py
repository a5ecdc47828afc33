"""The chaos plane of the port (``flink_tensorflow_tpu_torch/core/faults.py``)
held to the JAX package's (``tests/test_faults.py``).

The same spec strings parse to the same ``FaultSpec`` fields (or the same
``ValueError``) in both packages; the same injector fires the same faults
at the same positions; and the reference's keyed job
(``tests/test_faults.py:64``, n = 120, every = 20) under a killed source,
a killed keyed worker, a failed checkpoint write, a stall that forces a
checkpoint abort and an unrecovered kill commits, in both packages, the
bytes a clean run commits, with the same restarts, declined checkpoints
and ``faults.<kind>`` counts.  A severed record-plane edge fails the
reference's cohort (its receiver takes the torn transport for a lost
process); the port's writer reconnects and its receiver adopts the new
connection, so the job commits the clean output.  Every multi-process test
has its own timeout and no assert depends on timing."""

import dataclasses
import os
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest

import flink_tensorflow_tpu as jx
import flink_tensorflow_tpu_torch as pt
from flink_tensorflow_tpu.core import faults as jfaults
from flink_tensorflow_tpu_torch.core import faults as pfaults

sys.path.insert(0, os.path.dirname(__file__))
from _torch_ports import free_ports  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_distributed_worker.py")
NUM_KEYS = 4


def _pkg(name):
    """The modules of one package a keyed job needs, by the same names."""
    import importlib

    mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
    return types.SimpleNamespace(
        env=mod("core.environment"), fn=mod("core.functions"), state=mod("core.state"),
        files=mod("io.files"), serde=mod("tensors.serde"), tv=mod("tensors.value"),
        runtime=mod("core.runtime"), store=mod("checkpoint.store"))


PKGS = {"jax": _pkg("flink_tensorflow_tpu"), "torch": _pkg("flink_tensorflow_tpu_torch")}


def _keyed_sum(p):
    SUM = p.state.StateDescriptor("sum", default_factory=lambda: 0)

    class KeyedSum(p.fn.ProcessFunction):
        def process_element(self, value, ctx, out):
            state = ctx.state(SUM)
            cur = state.value() + int(value)
            state.update(cur)
            out.collect(p.tv.TensorValue({"v": np.int64(cur)},
                                         {"key": int(ctx.current_key), "i": int(value)}))

    return KeyedSum()


def committed_bytes(p, out_dir):
    return sorted(bytes(p.serde.encode_record(r)) for r in p.files.read_committed(out_dir))


def run_keyed_job(p, tmp_path, tag, *, n=120, every=20, faults=None, restart=None,
                  throttle=0.002, timeout_s=0.0):
    """source -> key_by -> KeyedSum (par 2) -> 2PC sink with count-based
    checkpoints (``tests/test_faults.py:64``); returns (env, out_dir)."""
    out = str(tmp_path / f"out-{tag}")
    env = p.env.StreamExecutionEnvironment(parallelism=2)
    env.enable_checkpointing(str(tmp_path / f"chk-{tag}"), every_n_records=every)
    if timeout_s:
        env.configure(checkpoint=dataclasses.replace(env.config.checkpoint, timeout_s=timeout_s))
    if faults is not None:
        env.configure(faults=faults)
    env.source_throttle_s = throttle
    (env.from_collection(list(range(n)), name="src")
     .key_by(lambda x: x % NUM_KEYS)
     .process(_keyed_sum(p), name="count", parallelism=2)
     .add_sink(p.files.ExactlyOnceRecordFileSink(out), name="sink", parallelism=1))
    strategy = None if restart is None else p.env.RestartStrategy(**restart)
    env.execute(f"faults-{tag}", timeout=120, restart_strategy=strategy)
    return env, out


def _count(rep, key):
    v = rep.get(key, 0)
    return v["count"] if isinstance(v, dict) else v


# -- the spec grammar and the injector --------------------------------------------

SPECS = ["kill:count.0@50", "stall:count.1@80~0.5#1", "store_fail@2", "delay:sum.1@5~0.01x3",
         "sever:rsink.0@3", "blackhole:a.b.2@7~1.5#4", " kill:src.0@1 ", "store_fail@9#2"]
BAD = ["nuke:a.0@1", "kill@5", "kill:a.0", "kill:a.0@0", "stall:a.0@3~-1", "delay:a.0@1~0.1x0",
       "", "kill:a@1", "store_fail@x"]


@pytest.mark.parametrize("text", SPECS)
def test_specs_parse_to_the_same_fields(text):
    j, t = jfaults.parse_fault_spec(text), pfaults.parse_fault_spec(text)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.scope == j.scope


@pytest.mark.parametrize("text", BAD)
def test_malformed_specs_raise_in_both(text):
    with pytest.raises(ValueError):
        jfaults.parse_fault_spec(text)
    with pytest.raises(ValueError):
        pfaults.parse_fault_spec(text)


def test_plans_env_override_and_job_config_validation(monkeypatch):
    text = "kill:a.0@1;sever:b.1@2;;store_fail@3#1"
    assert ([dataclasses.asdict(s) for s in pfaults.FaultPlan.parse(text).specs]
            == [dataclasses.asdict(s) for s in jfaults.FaultPlan.parse(text).specs])
    seq = [pfaults.FaultSpec("kill", "x", 0, 7), "stall:y.1@2~0.1"]
    assert [s.kind for s in pfaults.FaultPlan.resolve(seq).specs] == ["kill", "stall"]
    assert pfaults.FaultPlan.resolve(None) is None
    monkeypatch.setenv("FLINK_TPU_FAULTS", "kill:x.0@7")
    assert pfaults.FaultPlan.resolve("store_fail@1").specs[0] == pfaults.FaultSpec("kill", "x", 0, 7)
    assert jfaults.FaultPlan.resolve("store_fail@1").specs[0] == jfaults.FaultSpec("kill", "x", 0, 7)
    monkeypatch.delenv("FLINK_TPU_FAULTS")
    with pytest.raises(ValueError):
        pt.JobConfig(faults="kill@5").validate()
    with pytest.raises(ValueError):
        jx.JobConfig(faults="kill@5").validate()
    assert pt.FaultPlan is pfaults.FaultPlan and pt.FaultSpec is pfaults.FaultSpec


def _drive(mod, plan_text, epoch):
    """Every hook of one injector over fixed positions: what fires, raises
    and drops, in order (durations 0, so nothing sleeps)."""
    inj = mod.FaultInjector(mod.FaultPlan.parse(plan_text, seed=3), epoch=epoch)
    trace = [("active", inj.active)]
    for scope in ("src.0", "count.1"):
        for off in range(1, 8):
            try:
                inj.record_point(scope, off)
                trace.append((scope, off, "ok"))
            except mod.InjectedFault:
                trace.append((scope, off, "kill"))
    hook = inj.edge_hook("sum", 1)
    trace.append(("no-hook", inj.edge_hook("sum", 0) is None))
    for frame in range(1, 9):
        try:
            trace.append(("edge", frame, hook() if hook is not None else None))
        except mod.InjectedConnectionError:
            trace.append(("edge", frame, "sever"))
    for cid in range(1, 5):
        try:
            inj.store_point(cid)
            trace.append(("store", cid, "ok"))
        except mod.InjectedStoreFailure:
            trace.append(("store", cid, "fail"))
    return trace, list(inj.fired)


@pytest.mark.parametrize("epoch", [0, 1, 2])
def test_injectors_fire_the_same_schedule(epoch):
    plan = ("kill:src.0@3;stall:count.1@2~0;kill:count.1@5#1;sever:sum.1@2;"
            "delay:sum.1@4~0x2;blackhole:sum.1@6~0;store_fail@2;store_fail@3#1")
    assert _drive(pfaults, plan, epoch) == _drive(jfaults, plan, epoch)


def test_delay_jitter_is_seeded_like_the_reference(monkeypatch):
    slept = {}
    for name, mod in (("jax", jfaults), ("torch", pfaults)):
        got = []
        monkeypatch.setattr(mod.time, "sleep", got.append)
        hook = mod.FaultInjector(mod.FaultPlan.parse("delay:e.0@1~0.5x4", seed=11)).edge_hook("e", 0)
        for _ in range(5):
            hook()
        slept[name] = got
    assert slept["torch"] == slept["jax"] and len(slept["jax"]) == 4


# -- faulted keyed jobs in both packages ----------------------------------------

@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    """The clean run's committed bytes, the same in both packages."""
    tmp = tmp_path_factory.mktemp("clean")
    got = {name: committed_bytes(p, run_keyed_job(p, tmp, name)[1]) for name, p in PKGS.items()}
    assert got["torch"] == got["jax"] and len(got["jax"]) == 120
    return got["jax"]


CASES = {
    "kill_source": dict(faults="kill:src.0@50", restart=dict(max_restarts=2, delay_s=0.01)),
    # Subtask 0: every key of ``x % 4`` lands in its key groups at
    # parallelism 2 (see the test below).
    "kill_keyed_worker": dict(faults="kill:count.0@25", restart=dict(max_restarts=2)),
    "store_fail": dict(faults="store_fail@2", every=15),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_faulted_job_commits_the_clean_bytes_in_both(clean, tmp_path, case):
    reports = {}
    for name, p in PKGS.items():
        env, out = run_keyed_job(p, tmp_path, f"{case}-{name}", **CASES[case])
        assert committed_bytes(p, out) == clean, name
        reports[name] = env.metric_registry.report()
    for key in ("recovery.restarts_total", "recovery.checkpoints_aborted", "faults.kill",
                "faults.store_fail", "faults.fired_total"):
        assert _count(reports["torch"], key) == _count(reports["jax"], key), key
    if case.startswith("kill"):
        assert _count(reports["torch"], "recovery.restarts_total") == 1
        assert _count(reports["torch"], "recovery.recovery_duration_s") == 1
    else:
        assert _count(reports["torch"], "faults.store_fail") == 1
        assert _count(reports["torch"], "recovery.checkpoints_aborted") == 1
        ids = PKGS["torch"].store.checkpoint_ids(str(tmp_path / f"chk-{case}-torch"))
        assert 2 not in ids and any(i > 2 for i in ids)


def test_the_reference_worker_kill_targets_an_idle_subtask(clean, tmp_path):
    """``tests/test_faults.py``'s worker kill, ``kill:count.1@25``, never
    fires: keys 0-3 all hash to subtask 0 at parallelism 2, so count.1
    sees no record.  Both packages agree (no kill, no restart)."""
    for name, p in PKGS.items():
        env, out = run_keyed_job(p, tmp_path, f"idle-{name}", faults="kill:count.1@25",
                                 restart=dict(max_restarts=2))
        rep = env.metric_registry.report()
        assert committed_bytes(p, out) == clean, name
        assert _count(rep, "faults.kill") == 0 and _count(rep, "recovery.restarts_total") == 0
        assert rep["count.1.records_in"]["count"] == 0, name


@pytest.mark.parametrize("name", sorted(PKGS))
def test_unrecovered_kill_fails_the_job(tmp_path, name):
    p = PKGS[name]
    with pytest.raises(p.runtime.JobFailure):
        run_keyed_job(p, tmp_path, "nokill", faults="kill:src.0@10")


def test_stall_aborts_a_checkpoint_then_a_later_one_completes(clean, tmp_path):
    """The stalled keyed subtask holds alignment past the 0.25 s deadline:
    the sweeper declines the expired checkpoints, a later one lands, and
    nothing is lost or doubled, in both packages."""
    for name, p in PKGS.items():
        out = str(tmp_path / f"out-stall-{name}")
        chk = str(tmp_path / f"chk-stall-{name}")
        env = p.env.StreamExecutionEnvironment(parallelism=2)
        env.enable_checkpointing(chk, every_n_records=10)
        env.configure(checkpoint=dataclasses.replace(env.config.checkpoint, timeout_s=0.25),
                      faults="stall:count.0@20~0.6")
        env.source_throttle_s = 0.012
        (env.from_collection(list(range(120)), name="src")
         .key_by(lambda x: x % NUM_KEYS)
         .process(_keyed_sum(p), name="count", parallelism=2)
         .add_sink(p.files.ExactlyOnceRecordFileSink(out), name="sink", parallelism=1))
        handle = env.execute_async("faults-stall")
        handle.wait(120)
        coordinator = handle.executor.coordinator
        rep = env.metric_registry.report()
        assert rep["recovery.checkpoints_aborted"] >= 1, name
        assert _count(rep, "faults.stall") == 1, name
        assert committed_bytes(p, out) == clean, name
        latest = p.store.latest_checkpoint_id(chk)
        assert latest is not None and latest > min(coordinator.aborted_ids), name


def test_off_by_default_the_executor_holds_no_injector(tmp_path, monkeypatch):
    monkeypatch.delenv("FLINK_TPU_FAULTS", raising=False)
    env = pt.StreamExecutionEnvironment(parallelism=1)
    env.from_collection([1, 2, 3]).map(lambda v: v).sink_to_list()
    handle = env.execute_async("off")
    handle.wait(30)
    assert handle.executor.faults is None and handle.executor.sanitizer is None
    # A plan armed for epoch 1 only: the first attempt holds no injector.
    env = pt.StreamExecutionEnvironment(parallelism=1)
    env.configure(faults="kill:src.0@1#1")
    env.from_collection([1, 2, 3], name="src").sink_to_list()
    handle = env.execute_async("epoch-1-only")
    handle.wait(30)
    assert handle.executor.faults is None


# -- heartbeat death ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["jax", "torch"])
def test_a_silent_peer_fails_fast(name):
    """Twin of ``TestHeartbeatDeathDetection``: a 2-process cohort whose peer
    never comes up fails on the heartbeat, not at the join's timeout."""
    mod = jx if name == "jax" else pt
    runtime = PKGS[name].runtime
    my_port, dead_port = free_ports(2)
    env = mod.StreamExecutionEnvironment(parallelism=1)
    env.set_distributed(mod.DistributedConfig(
        0, 2, (f"127.0.0.1:{my_port}", f"127.0.0.1:{dead_port}"),
        connect_timeout_s=0.5, heartbeat_timeout_s=0.4, telemetry_interval_s=0.0))
    env.source_throttle_s = 0.05
    env.from_collection(list(range(60)), name="src").map(lambda x: x, name="ident").sink_to_list()
    t0 = time.monotonic()
    with pytest.raises(runtime.JobFailure, match="cohort peer 1 silent"):
        env.execute("hb", timeout=30)
    assert time.monotonic() - t0 < 25.0


# -- a severed record-plane edge ------------------------------------------------------

def _cohort_threads(mod, faults, out, chk):
    """A 2-process keyed job on threads of this process, the fault plan on
    both processes; returns each process's error (or None) and metrics."""
    ports = free_ports(2)
    peers = tuple(f"127.0.0.1:{p}" for p in ports)
    errors, reports = {}, {}

    def run(proc):
        p = PKGS["jax" if mod is jx else "torch"]
        env = mod.StreamExecutionEnvironment(parallelism=1)
        try:
            env.set_distributed(mod.DistributedConfig(proc, 2, peers, connect_timeout_s=10.0))
            env.configure(faults=faults, sanitize=True)
            env.source_throttle_s = 0.002
            env.enable_checkpointing(chk, every_n_records=20)
            (env.from_collection(list(range(120)), parallelism=1)
             .key_by(lambda x: x % NUM_KEYS)
             .process(_keyed_sum(p), name="keyed_sum", parallelism=2)
             .add_sink(p.files.ExactlyOnceRecordFileSink(out), name="sink", parallelism=1))
            env.execute("sever", timeout=60)
            errors[proc] = None
        except BaseException as exc:  # noqa: BLE001 - compared below
            errors[proc] = exc
        reports[proc] = env.metric_registry.report()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(90)
    assert not any(t.is_alive() for t in threads), "cohort hung"
    return errors, reports


def test_a_severed_record_plane_edge_fails_the_reference_and_not_the_port(clean, tmp_path):
    """``sever:keyed_sum.1@5`` cuts process 0's edge into keyed_sum.1 (on
    process 1).  The reference's receiver fails on the dead transport's EOF
    ("disconnected before EndOfPartition"); the port's adopts the writer's
    new connection, and the job commits the clean bytes with one
    reconnect."""
    errors, _ = _cohort_threads(jx, "sever:keyed_sum.1@5", str(tmp_path / "jout"),
                                str(tmp_path / "jchk"))
    assert any(e is not None and "EndOfPartition" in repr(e.__cause__ or e)
               for e in errors.values()), errors
    out = str(tmp_path / "out")
    errors, reports = _cohort_threads(pt, "sever:keyed_sum.1@5", out, str(tmp_path / "chk"))
    assert errors == {0: None, 1: None}
    assert committed_bytes(PKGS["torch"], out) == clean
    assert _count(reports[0], "faults.sever") == 1
    assert _count(reports[0], "recovery.edge_reconnects") == 1
    assert reports[0]["shuffle.out.keyed_sum.1.ch0.reconnects"] == 1
    assert reports[0]["sanitizer.violations"] == 0 and reports[1]["sanitizer.violations"] == 0


# -- a sever with frames still queued, and the frame numbers that prove no gap ---------

def _edge_under_a_stalled_consumer(pkg):
    """One record-plane edge (gate capacity 2, a frame per 256 KiB record,
    the writer on its own reactor, 64 KiB socket buffers at both ends)
    whose consumer stalls while 4 MiB are written, so that, whatever the
    timing, more than 1 MiB is still on the writer's send queue when the
    next frame severs the edge.  Returns the values the gate took up to
    end-of-partition, the record count, the receiver's errors, the writer's
    metric report and the number of frames the writer resent."""
    import importlib
    import socket

    mod = lambda m: importlib.import_module(f"{pkg}.core.{m}")  # noqa: E731
    el, shuffle, channels, reactor = (mod("elements"), mod("shuffle"), mod("channels"),
                                      mod("reactor"))
    reg = importlib.import_module(f"{pkg}.metrics.registry").MetricRegistry()
    errors = []
    gate = channels.InputGate(1, capacity=2)
    server = shuffle.ShuffleServer("127.0.0.1", on_error=errors.append)
    server._listener.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 16)
    server.register_gate("op", 0, gate)
    server.start()
    loop = reactor.Reactor(name="writer-reactor")
    loop.start()
    cut = threading.Event()

    def hook():
        if cut.is_set():
            cut.clear()
            raise ConnectionError("injected sever")
        return None

    w = shuffle.RemoteChannelWriter("127.0.0.1", server.port, "op", 0, 0, connect_timeout_s=10.0,
                                    metrics=reg, flush_bytes=0, reactor=loop, fault_hook=hook)
    resent = []
    teardown = w._teardown_transport

    def spy():
        frames = teardown()
        resent.append(len(frames) if frames else 0)
        return frames

    w._teardown_transport = spy
    rec = lambda i: el.StreamRecord(np.full(1 << 16, i, np.float32))  # noqa: E731
    got = []
    try:
        w.write(rec(0))
        w._sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 1 << 16)
        # The receiver holds at most 2 records in the gate, 1 MiB parsed
        # from its last read and its socket buffer; the writer's kernel its
        # own buffer: the rest of 4 MiB stays on the send queue.
        i = 16
        for j in range(1, i):
            w.write(rec(j))
        cut.set()
        w.write(rec(i))
        total = i + 9
        for j in range(i + 1, total):
            w.write(rec(j))
        w.write(el.EndOfPartition())
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and not errors:
            item = gate.poll(timeout=0.2)
            if item is None:
                continue
            if isinstance(item[1], el.EndOfPartition):
                break
            got.append(int(item[1].value[0]))
        return got, total, errors, reg.report(), resent
    finally:
        w.close()
        server.close()
        loop.close()


def test_a_sever_with_frames_queued_resends_them_in_order():
    """The port's writer resends the frames its dead connection never
    wrote (more than 1 MiB of them, queued behind a stalled consumer), so
    every record arrives once and in order.  The reference's writer drops
    that queue with the connection and its receiver fails the job on the
    EOF without end-of-partition (or on the frame the close cut), so only a
    restart recovers it there."""
    got, total, errors, report, resent = _edge_under_a_stalled_consumer("flink_tensorflow_tpu_torch")
    assert errors == []
    assert resent and resent[0] >= 4
    assert got == list(range(total))
    assert report["shuffle.out.op.0.ch0.reconnects"] == 1
    _, _, jerrors, _, _ = _edge_under_a_stalled_consumer("flink_tensorflow_tpu")
    assert jerrors and any(("EndOfPartition" in str(e) or "truncated" in str(e))
                           for e in jerrors), jerrors


def _raw_route(port, seq, values, tail=b"", eop=False):
    """A hand-made writer: the handshake at frame ``seq``, a record frame
    per value, then ``tail`` (bytes of a cut frame) or end-of-partition.
    A receiver that refuses the connection may close it under the sends."""
    import socket

    from flink_tensorflow_tpu_torch.core import elements as el
    from flink_tensorflow_tpu_torch.core.shuffle import _send_obj

    sock = socket.create_connection(("127.0.0.1", port), timeout=10.0)
    try:
        _send_obj(sock, ("op", 0, 0, {"epoch": 0, "seq": seq}))
        for v in values:
            _send_obj(sock, el.StreamRecord(v))
        if tail:
            sock.sendall(tail)
        if eop:
            _send_obj(sock, el.EndOfPartition())
    except (BrokenPipeError, ConnectionResetError):
        pass
    return sock


@pytest.mark.parametrize("seq,outcome", [(3, None), (5, "frames were lost"),
                                         (2, "frames would repeat")])
def test_a_reconnect_must_resume_at_the_next_frame(seq, outcome):
    """Three frames and the first half of a fourth, then the connection
    ends; a new connection of the channel resumes at frame ``seq``.  Frame
    3 (the cut one, resent whole) joins and the channel goes on; a gap or a
    repeat fails the job, and nothing of the new connection is delivered."""
    from flink_tensorflow_tpu_torch.core import elements as el
    from flink_tensorflow_tpu_torch.core.channels import InputGate
    from flink_tensorflow_tpu_torch.core.shuffle import ShuffleServer, encode_obj_frame

    errors = []
    gate = InputGate(1, capacity=64)
    server = ShuffleServer("127.0.0.1", on_error=errors.append)
    server.register_gate("op", 0, gate)
    server.start()
    try:
        cut = b"".join(bytes(p) for p in encode_obj_frame(el.StreamRecord(3))[0])
        first = _raw_route(server.port, 0, [0, 1, 2], tail=cut[: len(cut) // 2])
        first.close()
        second = _raw_route(server.port, seq, [3, 4], eop=True)
        got, deadline = [], time.monotonic() + 10.0
        while time.monotonic() < deadline:
            item = gate.poll(timeout=0.1)
            if item is not None:
                if isinstance(item[1], el.EndOfPartition):
                    break
                got.append(item[1].value)
            elif errors:
                break
        second.close()
    finally:
        server.close()
    if outcome is None:
        assert errors == [] and got == [0, 1, 2, 3, 4]
    else:
        assert got == [0, 1, 2]
        assert len(errors) == 1 and outcome in str(errors[0])


def test_a_first_connection_past_frame_0_fails():
    from flink_tensorflow_tpu_torch.core.channels import InputGate
    from flink_tensorflow_tpu_torch.core.shuffle import ShuffleServer

    errors = []
    gate = InputGate(1, capacity=8)
    server = ShuffleServer("127.0.0.1", on_error=errors.append)
    server.register_gate("op", 0, gate)
    server.start()
    try:
        sock = _raw_route(server.port, 4, [7])
        deadline = time.monotonic() + 10.0
        while not errors and time.monotonic() < deadline:
            time.sleep(0.02)
        sock.close()
        assert gate.poll(timeout=0.2) is None
    finally:
        server.close()
    assert len(errors) == 1 and "none of its earlier frames arrived" in str(errors[0])


def _spawn(index, ports, out, extra_env, *, n=120, chk=None, every=20, restore_id=-1,
           throttle=0.002, epoch=0):
    cmd = [sys.executable, WORKER, "--index", str(index), "--ports", ",".join(map(str, ports)),
           "--out", out, "--n", str(n), "--every", str(every), "--restore-id", str(restore_id),
           "--throttle", str(throttle), "--epoch", str(epoch)]
    if chk:
        cmd += ["--chk", chk]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    env.update(extra_env)
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _wait(procs, timeout):
    deadline = time.monotonic() + timeout
    results = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError("a worker hung")
        results.append((p.returncode, out.decode(errors="replace")))
    return results


def _expected(n):
    sums, rows = {}, []
    for i in range(n):
        k = i % NUM_KEYS
        sums[k] = sums.get(k, 0) + i
        rows.append((k, i, sums[k]))
    return sorted(rows)


def _rows(out):
    from flink_tensorflow_tpu_torch.io.files import read_committed

    return sorted((int(r.meta["key"]), int(r.meta["i"]), int(r["v"])) for r in read_committed(out))


def test_two_process_sever_commits_the_clean_output_and_stitches_clean(tmp_path):
    """Two worker processes, ``FLINK_TPU_FAULTS`` severing the keyed edge
    into process 1 at its 5th frame, then delaying it: the writer
    reconnects, the committed output is the clean one, and the two
    processes' happens-before logs stitch with no violation."""
    from flink_tensorflow_tpu_torch.core.sanitizer_rt import load_hb_log
    from flink_tensorflow_tpu_torch.core.sanitizer_stitch import stitch

    out, hb = str(tmp_path / "out"), str(tmp_path / "hb.json")
    faults = {"FLINK_TPU_FAULTS": "sever:keyed_sum.1@5;delay:keyed_sum.1@12~0.002x5",
              "FLINK_TPU_SANITIZE": "1", "FLINK_TPU_SANITIZE_LOG": hb}
    ports = free_ports(2)
    results = _wait([_spawn(i, ports, out, faults, chk=str(tmp_path / "chk"))
                     for i in range(2)], timeout=30)
    for rc, log in results:
        assert rc == 0, log[-3000:]
    assert "re-established" in results[0][1]
    assert _rows(out) == _expected(120)
    docs = [load_hb_log(str(tmp_path / f"hb.proc{i}.json")) for i in range(2)]
    report = stitch(docs)
    assert report["violations"] == [] and report["local_violations"] == []
    kinds = {row[0] for doc in docs for row in doc["events"]}
    assert {"frame.send", "frame.recv", "frame.deliver", "epoch.handshake"} <= kinds


@pytest.mark.slow
def test_two_process_soak_kill_recovers_byte_identical(tmp_path):
    """Twin of ``TestCohortChaosSoak``: process 0's keyed subtask dies at its
    60th record, the survivor fails, and the cohort restarted at epoch 1
    from the newest common checkpoint with the sanitizer on commits the
    clean output, its logs stitching with no violation."""
    from flink_tensorflow_tpu_torch.core.sanitizer_rt import load_hb_log
    from flink_tensorflow_tpu_torch.core.sanitizer_stitch import stitch
    from flink_tensorflow_tpu_torch.parallel import latest_common_checkpoint

    n, every = 240, 40
    out, chk = str(tmp_path / "out"), str(tmp_path / "chk")
    ports = free_ports(2)
    results = _wait([_spawn(0, ports, out, {"FLINK_TPU_FAULTS": "kill:keyed_sum.0@60"}, n=n,
                            chk=chk, every=every, throttle=0.005),
                     _spawn(1, ports, out, {}, n=n, chk=chk, every=every, throttle=0.005)],
                    timeout=120)
    assert results[0][0] != 0 and results[1][0] != 0, results
    common = latest_common_checkpoint([os.path.join(chk, f"proc-{i:05d}") for i in range(2)])
    assert common is not None
    hb = str(tmp_path / "hb.json")
    ports = free_ports(2)
    results = _wait([_spawn(i, ports, out, {"FLINK_TPU_SANITIZE": "1",
                                            "FLINK_TPU_SANITIZE_LOG": hb},
                            n=n, chk=chk, every=every, restore_id=common, throttle=0.005,
                            epoch=1) for i in range(2)], timeout=180)
    for rc, log in results:
        assert rc == 0, log[-3000:]
    assert _rows(out) == _expected(n)
    docs = [load_hb_log(str(tmp_path / f"hb.proc{i}.json")) for i in range(2)]
    assert all(doc["reason"] == "shutdown" for doc in docs)
    report = stitch(docs)
    assert report["violations"] == [] and report["local_violations"] == []
