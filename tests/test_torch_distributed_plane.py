"""One job graph across a process cohort on the port's record plane
(``core/distributed.py``), on the CPU; twins of the reference's
``tests/test_distributed_plane.py``.

Most cohorts run as threads of this process, two or three executors
joined over real TCP and shm channels (as the reference's
``tests/test_record_plane.py:504`` runs its sanitizer cohort).  Kill and
restore, the 2 -> 3 rescale, the elastic supervisor and the gang over
gloo run real processes of ``tests/_torch_distributed_worker.py``
(``CUDA_VISIBLE_DEVICES`` empty).  Peer lists are known before the
servers bind, so a cohort whose bind lost a port race
(``EADDRINUSE``) runs again on fresh ports.
"""

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from flink_tensorflow_tpu_torch.checkpoint import store
from flink_tensorflow_tpu_torch.core import functions as fn
from flink_tensorflow_tpu_torch.core.distributed import (
    DistributedConfig,
    DistributedExecutor,
    process_of_subtask,
)
from flink_tensorflow_tpu_torch.core.environment import StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.core.shuffle import ShuffleServer
from flink_tensorflow_tpu_torch.core.state import StateDescriptor
from flink_tensorflow_tpu_torch.io.files import ExactlyOnceRecordFileSink, read_committed
from flink_tensorflow_tpu_torch.parallel.supervisor import (
    CohortSupervisor,
    latest_common_checkpoint,
)
from flink_tensorflow_tpu_torch.tensors.value import TensorValue

from _torch_ports import free_ports

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_distributed_worker.py")
NUM_KEYS = 4
SUM = StateDescriptor("sum", default_factory=lambda: 0)
ADDR_IN_USE = "Address already in use"


def _peers(ports):
    return tuple(f"127.0.0.1:{p}" for p in ports)


def expected_emissions(n):
    sums = {k: 0 for k in range(NUM_KEYS)}
    out = []
    for i in range(n):
        k = i % NUM_KEYS
        sums[k] += i
        out.append((k, i, sums[k]))
    return sorted(out)


def expected_windows(n, size):
    per_key = {k: [] for k in range(NUM_KEYS)}
    for i in range(n):
        per_key[i % NUM_KEYS].append(i)
    out = []
    for k, vals in per_key.items():
        for j in range(0, len(vals), size):
            chunk = vals[j:j + size]
            out.append((k, sum(chunk), len(chunk), chunk[0]))
    return sorted(out)


class KeyedSum(fn.ProcessFunction):
    def process_element(self, value, ctx, out):
        state = ctx.state(SUM)
        cur = state.value() + int(value)
        state.update(cur)
        out.collect(TensorValue({"v": np.int64(cur)},
                                {"key": int(ctx.current_key), "i": int(value)}))


class WindowSum(fn.WindowFunction):
    def process_window(self, key, window, elements, out):
        vals = [int(v) for v in elements]
        out.collect(TensorValue({"s": np.int64(sum(vals))},
                                {"key": int(key), "n": len(vals), "first": vals[0]}))


class EventWindowSum(fn.WindowFunction):
    def process_window(self, key, window, elements, out):
        vals = [int(v["v"]) for v in elements]
        out.collect(TensorValue({"s": np.int64(sum(vals))},
                                {"key": int(key), "n": len(vals),
                                 "start": round(float(window.start), 3)}))


def _read_sums(out_dir):
    return sorted((int(r.meta["key"]), int(r.meta["i"]), int(r["v"]))
                  for r in read_committed(out_dir))


# -- in-process cohorts ---------------------------------------------------------------

def run_cohort_threads(num_procs, build, *, timeout=90.0, **config):
    """Run ``build(env, proc)`` as a cohort of ``num_procs`` executors on
    threads of this process; returns each process's ``build`` result.  A
    cohort whose bind lost a port race runs again on fresh ports."""
    for _ in range(3):
        peers = _peers(free_ports(num_procs))
        results, errors = {}, []

        def run(proc):
            try:
                env = StreamExecutionEnvironment(parallelism=1)
                env.set_distributed(DistributedConfig(proc, num_procs, peers,
                                                      connect_timeout_s=10.0, **config))
                results[proc] = build(env, proc)
                env.execute("cohort", timeout=timeout)
            except BaseException as exc:  # noqa: BLE001 - reported below
                errors.append(exc)

        threads = [threading.Thread(target=run, args=(p,)) for p in range(num_procs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout + 30)
        if any(ADDR_IN_USE in repr(e) or ADDR_IN_USE in repr(e.__cause__) for e in errors):
            continue
        assert not errors, f"cohort failed: {errors!r}"
        return results
    raise AssertionError("no free ports for the cohort")


def keyed_sum_job(out, n=80, par=2):
    def build(env, proc):
        (env.from_collection(list(range(n)), parallelism=1)
         .key_by(lambda x: x % NUM_KEYS)
         .process(KeyedSum(), name="keyed_sum", parallelism=par)
         .add_sink(ExactlyOnceRecordFileSink(out), name="sink", parallelism=1))
    return build


@pytest.mark.parametrize("num_procs", [2, 3])
def test_keyed_edge_spans_processes(tmp_path, num_procs):
    """source -> key_by -> keyed sum (one subtask per process) -> 2PC sink:
    the committed output is the exact running-sum sequence."""
    out = str(tmp_path / "out")
    run_cohort_threads(num_procs, keyed_sum_job(out, n=96, par=num_procs))
    assert _read_sums(out) == expected_emissions(96)


def test_three_process_cohort_with_checkpoints(tmp_path):
    """Three processes, checkpoints every 24 records into one shared
    directory: the commit gate waits on two peers per checkpoint, every
    process writes its shard, and the output is exactly once."""
    out, chk = str(tmp_path / "out"), str(tmp_path / "chk")

    def build(env, proc):
        env.enable_checkpointing(chk, every_n_records=24)
        keyed_sum_job(out, n=96, par=3)(env, proc)

    run_cohort_threads(3, build)
    assert _read_sums(out) == expected_emissions(96)
    dirs = [os.path.join(chk, f"proc-{i:05d}") for i in range(3)]
    assert latest_common_checkpoint(dirs) == 4
    meta = store.read_shard_meta(dirs[2], 4)["job"]
    assert meta["num_processes"] == 3 and meta["process_index"] == 2
    assert meta["participants"] == [0, 1, 2]
    assert meta["task_parallelism"] == {"collection": 1, "keyed_sum": 3, "sink": 1}


def test_keyed_count_window_spans_processes(tmp_path):
    out = str(tmp_path / "out")
    n, window = 78, 5

    def build(env, proc):
        (env.from_collection(list(range(n)), parallelism=1)
         .key_by(lambda x: x % NUM_KEYS)
         .count_window(window, latency_budget_s=600.0)
         .apply(WindowSum(), name="keyed_window", parallelism=2)
         .add_sink(ExactlyOnceRecordFileSink(out), name="sink", parallelism=1))

    run_cohort_threads(2, build)
    got = sorted((int(r.meta["key"]), int(r["s"]), int(r.meta["n"]), int(r.meta["first"]))
                 for r in read_committed(out))
    assert got == expected_windows(n, window)


def test_rebalance_fan_in_and_traffic_metrics(tmp_path):
    """A par-2 map rebalanced down to a par-1 sink on process 0: process
    1's records cross to it (columnar frames), and both ends count the
    same records on the edge."""
    got, regs = [], {}

    def build(env, proc):
        regs[proc] = env.metric_registry
        recs = [TensorValue({"x": np.full(8, i, np.float32)}, {"i": i}) for i in range(200)]
        (env.from_collection(recs, parallelism=2)
         .map(lambda r: r, name="work", parallelism=2)
         .sink_to_callable(got.append, name="sink", parallelism=1))

    run_cohort_threads(2, build)
    assert sorted(int(r.meta["i"]) for r in got) == list(range(200))
    out1, in0 = regs[1].report(), regs[0].report()
    assert out1["shuffle.out.sink.0.ch1.records"] == in0["shuffle.in.sink.0.ch1.records"] == 100
    assert out1["shuffle.out.sink.0.ch1.bytes"] == in0["shuffle.in.sink.0.ch1.bytes"]


def event_ts_of(i):
    """i * 0.25 s, except every (i % 23 == 7, i > 40) record, 9 s late."""
    base = i * 0.25
    return base - 9.0 if i > 40 and i % 23 == 7 else base


def event_time_job(out, n=96):
    def build(env, proc):
        records = [TensorValue({"v": np.int64(i)}, {"i": i, "key": i % NUM_KEYS})
                   for i in range(n)]
        stamped = env.from_collection(records, parallelism=1).assign_timestamps(
            lambda r: event_ts_of(int(r.meta["i"])), out_of_orderness_s=0.5,
            watermark_every=8)
        main = (stamped.key_by(lambda r: int(r.meta["key"])).time_window(2.0)
                .apply(EventWindowSum(), name="et_window", parallelism=2, late_tag="late"))
        main.add_sink(ExactlyOnceRecordFileSink(os.path.join(out, "main")), name="sink_main",
                      parallelism=1)
        (main.side_output("late")
         .map(lambda r: TensorValue({"v": r["v"]}, {"i": int(r.meta["i"]),
                                                     "key": int(r.meta["key"])}),
              name="late_project", parallelism=1)
         .add_sink(ExactlyOnceRecordFileSink(os.path.join(out, "late")), name="sink_late",
                   parallelism=1))
        (stamped.key_by(lambda r: int(r.meta["key"])).session_window(1.0)
         .apply(EventWindowSum(), name="et_session", parallelism=2)
         .add_sink(ExactlyOnceRecordFileSink(os.path.join(out, "session")),
                   name="sink_session", parallelism=1))
    return build


def _read_event_windows(out_dir):
    return sorted((int(r.meta["key"]), int(r["s"]), int(r.meta["n"]), float(r.meta["start"]))
                  for r in read_committed(out_dir))


def test_event_time_windows_and_late_outputs_span_processes(tmp_path):
    """Event-time windows, a late side output and session windows keyed
    over two processes commit what one process commits."""
    base, dist = str(tmp_path / "base"), str(tmp_path / "dist")
    run_cohort_threads(1, event_time_job(base))
    run_cohort_threads(2, event_time_job(dist))
    main = _read_event_windows(os.path.join(base, "main"))
    late = _read_sums(os.path.join(base, "late"))
    session = _read_event_windows(os.path.join(base, "session"))
    assert main and late and session
    assert _read_event_windows(os.path.join(dist, "main")) == main
    assert _read_sums(os.path.join(dist, "late")) == late
    assert _read_event_windows(os.path.join(dist, "session")) == session


def test_interval_join_inputs_originate_on_different_processes(tmp_path):
    """The left input starts on process 0, the right on process 1 (a par-2
    generator emitting from subtask 1 only): every pair crossed the plane."""
    from flink_tensorflow_tpu_torch.io.sources import GeneratorSource

    n = 96
    out = str(tmp_path / "pairs")
    left = [TensorValue({"v": np.int64(i)}, {"i": i, "key": i % 2}) for i in range(n)]
    right = [TensorValue({"v": np.int64(100 + j)}, {"i": j, "key": j % 2}) for j in range(n)]

    def build(env, proc):
        ls = (env.from_collection(left, parallelism=1)
              .assign_timestamps(lambda r: int(r.meta["i"]) * 0.5, watermark_every=4,
                                 name="ts_left")
              .key_by(lambda r: int(r.meta["key"])))
        rs = (env.from_source(GeneratorSource(lambda s, p: iter(right) if s == 1 else iter(())),
                              name="right_src", parallelism=2)
              .assign_timestamps(lambda r: int(r.meta["i"]) * 0.5 + 0.25, watermark_every=4,
                                 name="ts_right")
              .key_by(lambda r: int(r.meta["key"])))
        (ls.interval_join(rs, lower_s=-1.6, upper_s=1.6)
         .apply(lambda a, b: TensorValue({"s": np.int64(int(a["v"]) + int(b["v"]))},
                                         {"li": int(a.meta["i"]), "rj": int(b.meta["i"]),
                                          "key": int(a.meta["key"])}),
                name="ijoin", parallelism=2)
         .add_sink(ExactlyOnceRecordFileSink(out), name="sink_pairs", parallelism=1))

    run_cohort_threads(2, build)
    got = sorted((int(r.meta["key"]), int(r.meta["li"]), int(r.meta["rj"]), int(r["s"]))
                 for r in read_committed(out))
    assert got == sorted((i % 2, i, j, i + 100 + j) for i in range(n) for j in (i - 2, i, i + 2)
                         if 0 <= j < n)


def _widedeep_tiny():
    from flink_tensorflow_tpu_torch.functions import train_cell
    from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
    from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, spec

    cfg = dict(hash_buckets=50, embed_dim=2, num_cat_slots=2, num_dense=4, num_wide=4,
               hidden=(8,))
    mdef = get_model_def("widedeep", **cfg)
    schema = RecordSchema({"wide": spec((4,)), "dense": spec((4,)),
                           "cat": spec((2,), np.int32), "label": spec((), np.int32)})
    rng = np.random.RandomState(7)
    records = []
    for i in range(600):
        user = int(rng.randint(6))
        x_wide = rng.rand(4).astype(np.float32)
        records.append(TensorValue({"wide": x_wide, "dense": rng.rand(4).astype(np.float32),
                                    "cat": rng.randint(0, 50, (2,)).astype(np.int32),
                                    "label": np.int32(x_wide[user % 4] > 0.5)},
                                   meta={"user": user}))
    return train_cell, mdef, schema, records


def _read_steps(out_dir):
    return sorted((int(r.meta["key"]), int(r["step"]), float(r["loss"]))
                  for r in read_committed(out_dir))


def test_keyed_online_training_spans_processes(tmp_path):
    """``train_cell.run_widedeep_cohort`` (the widedeep-online cell's job:
    ``key_by(user) -> OnlineTrainFunction(scope="key", mini_batch=32,
    steps_per_dispatch=16)`` into the 2PC sink) keyed over two processes
    commits what the one-process run at the same keyed parallelism
    commits: every (key, step) once, losses bit for bit (each key trains
    its own model on its own events; barriers cut the source at the same
    positions)."""
    train_cell, mdef, schema, records = _widedeep_tiny()
    cpu = lambda task, index: "cpu"  # noqa: E731
    base, chk_base = str(tmp_path / "base"), str(tmp_path / "chk_base")
    train_cell.run_widedeep_cohort(mdef, schema, records, None, out=base,
                                   checkpoint_root=chk_base, every_n_records=128,
                                   device_provider=cpu)
    want = _read_steps(base)
    assert len({(k, s) for k, s, _ in want}) == len(want) == train_cell.expected_steps(
        records, 32)
    out, chk = str(tmp_path / "out"), str(tmp_path / "chk")

    def build(env, proc):
        env.set_device_provider(cpu)
        env.enable_checkpointing(chk, every_n_records=128)
        from flink_tensorflow_tpu_torch.functions.training_function import OnlineTrainFunction
        from flink_tensorflow_tpu_torch.parallel.optim import adam

        (env.from_collection(records, parallelism=1).key_by(lambda r: r.meta["user"])
         .process(OnlineTrainFunction(mdef, adam(train_cell.WIDEDEEP_LR), train_schema=schema,
                                      scope="key", mini_batch=train_cell.MINI_BATCH,
                                      steps_per_dispatch=train_cell.STEPS_PER_DISPATCH),
                  name="keyed_train", parallelism=2)
         .add_sink(ExactlyOnceRecordFileSink(out), name="sink", parallelism=1))

    run_cohort_threads(2, build)
    assert _read_steps(out) == want


def test_manual_checkpoint_refused_on_a_distributed_job():
    env = StreamExecutionEnvironment(parallelism=1)
    env.set_distributed(DistributedConfig(0, 1, _peers(free_ports(1))))
    env.configure(source_throttle_s=0.01)
    env.from_collection(list(range(50)), parallelism=1).sink_to_list()
    handle = env.execute_async("dist-manual")
    try:
        with pytest.raises(RuntimeError, match="not available on distributed"):
            handle.trigger_checkpoint()
    finally:
        handle.wait(60)


def test_a_cohort_refuses_what_the_reference_refuses(tmp_path):
    from flink_tensorflow_tpu_torch.core.environment import RestartStrategy
    from flink_tensorflow_tpu_torch.sources import ReplaySplitSource

    env = StreamExecutionEnvironment(parallelism=1)
    env.set_distributed(DistributedConfig(0, 2, _peers(free_ports(2))))
    env.enable_checkpointing(str(tmp_path), every_n_records=4)
    env.from_collection(list(range(8))).sink_to_list()
    with pytest.raises(ValueError, match="CohortSupervisor"):
        env.execute(restart_strategy=RestartStrategy(max_restarts=1))
    env.enable_checkpointing(str(tmp_path), interval_s=1.0)
    with pytest.raises(ValueError, match="count-based"):
        env.execute_async()
    ports = free_ports(1)
    with pytest.raises(ValueError, match="count-based"):
        DistributedExecutor(env.graph, distributed=DistributedConfig(0, 1, _peers(ports)),
                            checkpoint_dir=str(tmp_path))
    # A split source spread over the cohort (an enumerator per process).
    env = StreamExecutionEnvironment(parallelism=1)
    env.set_distributed(DistributedConfig(0, 2, _peers(free_ports(2))))
    env.from_source(ReplaySplitSource([list(range(4)), list(range(4))]), name="split",
                    parallelism=2).sink_to_list()
    with pytest.raises(ValueError, match="spread over a process cohort"):
        env.execute_async()


def test_gang_parallelism_must_match_the_cohort():
    from flink_tensorflow_tpu_torch.core.runtime_context import RuntimeContext
    from flink_tensorflow_tpu_torch.functions.training_function import DPTrainWindowFunction
    from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
    from flink_tensorflow_tpu_torch.parallel.mesh import make_mesh
    from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, spec

    mdef = get_model_def("lenet", compute_dtype="float32")
    gang = DPTrainWindowFunction(mdef, train_schema=RecordSchema(
        {"image": spec((28, 28, 1)), "label": spec((), np.int32)}), global_batch=4)
    mesh = make_mesh({"data": 1}, devices=["cpu"])
    for parallelism, procs in ((1, 2), (3, 2), (2, 1)):
        ctx = RuntimeContext("dp", 0, parallelism, mesh=mesh, num_processes=procs)
        with pytest.raises(RuntimeError, match="every process joins"):
            gang.clone().open(ctx)


def test_a_silent_peer_fails_the_job_fast():
    """Heartbeats on, and a peer that never comes up: process 0 (every
    subtask on it, so no record-plane connect touches the peer) fails
    with CohortPeerLost right after the first-contact grace."""
    from flink_tensorflow_tpu_torch.core.runtime import JobFailure

    env = StreamExecutionEnvironment(parallelism=1)
    env.set_distributed(DistributedConfig(0, 2, _peers(free_ports(2)), connect_timeout_s=0.5,
                                          heartbeat_timeout_s=0.4))
    env.source_throttle_s = 0.05
    env.from_collection(list(range(60)), name="src").map(lambda x: x, name="ident").sink_to_list()
    t0 = time.monotonic()
    with pytest.raises(JobFailure, match="cohort peer 1 silent"):
        env.execute("hb", timeout=30)
    assert time.monotonic() - t0 < 10.0


def test_heartbeats_keep_a_live_cohort_running(tmp_path):
    out = str(tmp_path / "out")
    run_cohort_threads(2, keyed_sum_job(out, n=96), heartbeat_timeout_s=0.5)
    assert _read_sums(out) == expected_emissions(96)


def _gate_executor(ports, timeout_s):
    """An executor of process 0 of two (not started), both participants."""
    env = StreamExecutionEnvironment(parallelism=1)
    env.from_collection(list(range(4)), parallelism=2).sink_to_list(parallelism=2)
    return DistributedExecutor(env.graph, distributed=DistributedConfig(0, 2, _peers(ports)),
                               checkpoint_timeout_s=timeout_s)


def test_the_commit_gate_waits_for_every_participant():
    """The gate announces the local shard to every peer and opens once
    each has announced the same id; a timed-out id withholds its commit
    without wedging the next; a cancel releases a waiting gate at once."""
    ports = free_ports(2)
    heard = []
    peer = ShuffleServer("127.0.0.1", ports[1], on_control=lambda s, m: heard.append((s, m)))
    peer.start()
    executor = _gate_executor(ports, timeout_s=30.0)
    try:
        result = {}
        t = threading.Thread(target=lambda: result.setdefault(5, executor._global_commit_gate(5)))
        t.start()
        deadline = time.monotonic() + 10.0
        while not heard and time.monotonic() < deadline:
            time.sleep(0.01)
        assert heard == [(0, ("ckpt_durable", 5, 0))]
        time.sleep(0.1)
        assert t.is_alive(), "the gate opened before the peer's shard was durable"
        executor._on_control(1, ("ckpt_durable", 5, 1))
        t.join(5.0)
        assert result == {5: True}
        executor.checkpoint_timeout_s = 0.3
        t0 = time.monotonic()
        assert executor._global_commit_gate(6) is False  # the peer never announced 6
        assert 0.25 < time.monotonic() - t0 < 5.0
        executor._on_control(1, ("ckpt_durable", 7, 1))
        assert executor._global_commit_gate(7) is True   # 6 did not wedge the gate
        assert not executor._durable_acks                 # ids up to 7 reaped
        executor.checkpoint_timeout_s = 60.0
        t = threading.Thread(target=lambda: result.setdefault(8, executor._global_commit_gate(8)))
        t.start()
        time.sleep(0.2)
        t0 = time.monotonic()
        executor.cancel()
        t.join(5.0)
        assert result[8] is False and time.monotonic() - t0 < 2.0
    finally:
        executor.cancel()
        peer.close()


# -- configuration and placement, against the JAX package -------------------------------

def test_round_robin_placement_equals_jax():
    from flink_tensorflow_tpu.core.distributed import process_of_subtask as jax_place

    for n in (1, 2, 3, 5):
        assert [process_of_subtask(i, n) for i in range(12)] == [jax_place(i, n)
                                                                for i in range(12)]


BAD_CONFIGS = [
    dict(process_index=2, num_processes=2, peers=("a:1", "b:2")),
    dict(process_index=0, num_processes=0, peers=()),
    dict(process_index=0, num_processes=2, peers=("a:1",)),
    dict(process_index=0, num_processes=1, peers=("nocolon",)),
    dict(process_index=0, num_processes=1, peers=("a:x",)),
    dict(process_index=0, num_processes=1, peers=("a:1",), connect_timeout_s=0),
    dict(process_index=0, num_processes=1, peers=("a:1",), telemetry_interval_s=-1),
    dict(process_index=0, num_processes=1, peers=("a:1",), restart_epoch=-1),
    dict(process_index=0, num_processes=1, peers=("a:1",), heartbeat_timeout_s=-0.5),
]


@pytest.mark.parametrize("kwargs", BAD_CONFIGS)
def test_config_validation_errors_equal_jax(kwargs):
    from flink_tensorflow_tpu.core.distributed import DistributedConfig as JaxConfig

    with pytest.raises(ValueError) as jax_err:
        JaxConfig(**kwargs).validate()
    with pytest.raises(ValueError) as port_err:
        DistributedConfig(**kwargs).validate()
    assert str(port_err.value) == str(jax_err.value)


def test_config_helpers_equal_jax():
    from flink_tensorflow_tpu.core.distributed import DistributedConfig as JaxConfig

    kw = dict(process_index=1, num_processes=3, peers=("h0:10", "h1:11", "[::1]:12"))
    port, ref = DistributedConfig(**kw).validate(), JaxConfig(**kw).validate()
    for p in range(3):
        assert port.endpoint(p) == ref.endpoint(p)
        assert port.process_checkpoint_dir("/b", p) == ref.process_checkpoint_dir("/b", p)
    assert port.process_checkpoint_dir("/b") == ref.process_checkpoint_dir("/b")


def _write_shard(base, proc, cid, num_processes, tasks, participants=None):
    job = {0: {"max_parallelism": 128, "num_processes": num_processes,
               "process_index": proc, "task_parallelism": {}}}
    if participants is not None:
        job[0]["participants"] = participants
    snaps = {"__job__": job}
    for task, idx in tasks:
        snaps.setdefault(task, {})[idx] = {"x": idx}
    store.write_checkpoint(os.path.join(base, f"proc-{proc:05d}"), cid, snaps)


def _shards_partial_newer(base):
    for cid in (1, 2):
        for p in range(2):
            _write_shard(base, p, cid, 2, [("op", p)])
    _write_shard(base, 0, 3, 2, [("op", 0)])


def _shards_stale(base):
    for p in range(3):
        _write_shard(base, p, 1, 3, [("op", p)])
    for p in range(2):
        _write_shard(base, p, 2, 2, [("op", p)])


def _shards_idle_process(base):
    # A cohort of 3 whose operators run at parallelism 2: process 2 is idle
    # and writes no shard; its checkpoints are complete all the same.
    for cid in (1, 2):
        for p in range(2):
            _write_shard(base, p, cid, 3, [("op", p)], participants=[0, 1])


def _shards_lost(base):
    _write_shard(base, 0, 1, 2, [("op", 0)])


@pytest.mark.parametrize("tree,asked", [
    (_shards_partial_newer, None), (_shards_partial_newer, 3), (_shards_partial_newer, 1),
    (_shards_stale, None), (_shards_stale, 1), (_shards_idle_process, None),
    (_shards_lost, None), (_shards_lost, 1)])
def test_select_cohort_checkpoint_equals_jax(tmp_path, tree, asked):
    """The same hand-built shard trees: the port picks the id and shards
    the JAX package picks, or raises where it raises, with its message."""
    from flink_tensorflow_tpu.checkpoint import store as jax_store

    base = str(tmp_path)
    tree(base)

    def answer(mod):
        try:
            return mod.select_cohort_checkpoint(base, asked)
        except (FileNotFoundError, ValueError) as exc:
            return type(exc).__name__, str(exc)

    assert answer(store) == answer(jax_store)


def test_merge_covers_all_shards_as_jax(tmp_path):
    from flink_tensorflow_tpu.checkpoint import store as jax_store

    base = str(tmp_path)
    for p in range(3):
        _write_shard(base, p, 1, 3, [("op", p)])
    cid, snaps = store.read_cohort_checkpoint(base)
    assert cid == 1 and sorted(snaps["op"]) == [0, 1, 2]
    assert (cid, snaps) == jax_store.read_cohort_checkpoint(base)


# -- subprocess cohorts -----------------------------------------------------------------

def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def _spawn(index, ports, out, chk=None, n=80, every=20, restore_id=-1, throttle=0.0,
           job="keyed_sum", par=2, extra=()):
    cmd = [sys.executable, WORKER, "--index", str(index), "--ports", ",".join(map(str, ports)),
           "--out", out, "--n", str(n), "--every", str(every), "--restore-id", str(restore_id),
           "--throttle", str(throttle), "--job", job, "--par", str(par), *extra]
    if chk:
        cmd += ["--chk", chk]
    return subprocess.Popen(cmd, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _wait(proc, timeout=120):
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        raise AssertionError(f"worker hung:\n{out.decode(errors='replace')}")
    return proc.returncode, out.decode(errors="replace")


def run_cohort_procs(num_procs, **kw):
    """A cohort of worker processes to its end, again on fresh ports if a
    bind lost a port race; returns the logs."""
    for _ in range(3):
        ports = free_ports(num_procs)
        results = [_wait(p) for p in [_spawn(i, ports, **kw) for i in range(num_procs)]]
        if any(ADDR_IN_USE in log for _, log in results):
            continue
        for rc, log in results:
            assert rc == 0, f"worker failed:\n{log}"
        return results
    raise AssertionError("no free ports for the cohort")


def _start_and_kill_after_a_common_checkpoint(num_procs, victim, out, chk, n, every):
    """Start a throttled cohort, SIGKILL ``victim`` once a checkpoint is in
    every shard, and wait for the others to fail; returns that checkpoint."""
    dirs = [os.path.join(chk, f"proc-{i:05d}") for i in range(num_procs)]
    for _ in range(3):
        ports = free_ports(num_procs)
        procs = [_spawn(i, ports, out, chk=chk, n=n, every=every, throttle=0.005)
                 for i in range(num_procs)]
        deadline = time.monotonic() + 60.0
        common = None
        while time.monotonic() < deadline:
            common = latest_common_checkpoint(dirs)
            if common is not None or any(p.poll() is not None for p in procs):
                break
            time.sleep(0.02)
        if common is None:
            logs = [_wait(p)[1] for p in procs]
            if any(ADDR_IN_USE in log for log in logs):
                continue
            raise AssertionError(f"no common checkpoint before exit:\n{logs}")
        procs[victim].send_signal(signal.SIGKILL)
        results = [_wait(p) for p in procs]
        for i, (rc, log) in enumerate(results):
            # The survivors notice the peer loss and fail, never hang or
            # report success on a truncated stream.
            assert rc != 0, f"worker {i} ignored the peer loss:\n{log}"
        return latest_common_checkpoint(dirs)
    raise AssertionError("no free ports for the cohort")


@pytest.mark.parametrize("victim", [1, 0])
def test_kill_and_restore_exactly_once(tmp_path, victim):
    """Kill one worker after a checkpoint crossed the wire and landed in
    both shards, restore both from the newest common checkpoint: the
    committed output is exactly once.  Victim 0 hosts the source and the
    2PC sink; victim 1 the peer keyed subtask."""
    out, chk = str(tmp_path / "out"), str(tmp_path / "chk")
    n, every = 240, 40
    common = _start_and_kill_after_a_common_checkpoint(2, victim, out, chk, n, every)
    assert common is not None
    run_cohort_procs(2, out=out, chk=chk, n=n, every=every, restore_id=common)
    assert _read_sums(out) == expected_emissions(n)


def test_cohort_rescale_on_restore(tmp_path):
    """Kill a two-process cohort, restore as THREE processes at keyed
    parallelism 3: every process merges both shards and keyed state moves
    by key group; the output is still exactly once."""
    out, chk = str(tmp_path / "out"), str(tmp_path / "chk")
    n, every = 240, 40
    common = _start_and_kill_after_a_common_checkpoint(2, 0, out, chk, n, every)
    run_cohort_procs(3, out=out, chk=chk, n=n, every=every, restore_id=common, par=3)
    assert _read_sums(out) == expected_emissions(n)


def _elastic_command(out, chk, n, every, plan):
    ports = {}

    def command(w, num_workers, attempt):
        special = plan(w, num_workers, attempt)
        if special == "gone":
            return [sys.executable, "-S", "-c", "import sys; sys.exit(7)"]
        port_list = ports.setdefault(attempt, free_ports(num_workers))
        cmd = [sys.executable, WORKER, "--index", str(w),
               "--ports", ",".join(map(str, port_list)), "--out", out, "--chk", chk,
               "--n", str(n), "--every", str(every), "--par", "3", "--throttle", "0.005",
               "--epoch", str(attempt), "--restore-id", "-1" if attempt == 0 else "-2"]
        if special is not None:
            cmd += ["--die-after-checkpoint", str(special)]
        return cmd

    return command


def test_permanent_worker_loss_reforms_at_p_minus_1(tmp_path):
    """One of three workers is gone for good: the supervisor burns the
    shape-3 budget, re-forms at 2, and the two restore by merging the
    three shards; the output is exactly once."""
    out, chk = str(tmp_path / "out"), str(tmp_path / "chk")

    def plan(w, num_workers, attempt):
        if num_workers == 3 and w == 2:
            return 2 if attempt == 0 else "gone"
        return None

    sup = CohortSupervisor(_elastic_command(out, chk, 240, 40, plan), 3, env=lambda *a: _env(),
                           max_restarts=1, poll_s=0.05, kill_grace_s=8.0,
                           attempt_timeout_s=150.0, elastic=True, min_workers=2)
    outcome = sup.run()
    assert (outcome.num_workers, outcome.attempts, outcome.returncode) == (2, 3, 0)
    assert _read_sums(out) == expected_emissions(240)


def test_returned_capacity_regrows_cohort(tmp_path):
    """Shrink 3 -> 2, the shrunken cohort checkpoints and fails, the probe
    reports the host back, and the cohort re-forms at 3, carrying the
    2-shape state back up; exactly once across shrink and regrow."""
    out, chk = str(tmp_path / "out"), str(tmp_path / "chk")

    def plan(w, num_workers, attempt):
        if num_workers == 3 and w == 2:
            return {0: 2, 1: "gone"}.get(attempt)
        if num_workers == 2 and w == 1 and attempt == 2:
            return 4
        return None

    sup = CohortSupervisor(_elastic_command(out, chk, 240, 40, plan), 3, env=lambda *a: _env(),
                           max_restarts=1, poll_s=0.05, kill_grace_s=8.0,
                           attempt_timeout_s=150.0, elastic=True, min_workers=2,
                           capacity_probe=lambda: 3)
    outcome = sup.run()
    assert (outcome.num_workers, outcome.attempts, outcome.returncode) == (3, 4, 0)
    assert _read_sums(out) == expected_emissions(240)


def test_regrow_budget_exhaustion_bars_oscillation(tmp_path):
    """A probe that keeps reporting a flapping host: the regrown shape 3
    fails its whole budget and is barred, and the real two-process cohort
    finishes by restoring its own checkpoint, exactly once."""
    out, chk = str(tmp_path / "out"), str(tmp_path / "chk")

    def plan(w, num_workers, attempt):
        if num_workers == 3:
            return "gone"
        if w == 1 and attempt == 2:
            return 2
        return None

    sup = CohortSupervisor(_elastic_command(out, chk, 240, 40, plan), 3, env=lambda *a: _env(),
                           max_restarts=1, poll_s=0.05, kill_grace_s=8.0,
                           attempt_timeout_s=150.0, elastic=True, min_workers=2,
                           capacity_probe=lambda: 3)
    outcome = sup.run()
    # 0, 1: shape 3 fails -> 2; 2: shape 2 fails after checkpoint 2 -> the
    # probe regrows 3; 3, 4: shape 3 fails -> barred -> 2; 5 succeeds.
    assert (outcome.num_workers, outcome.attempts, outcome.returncode) == (2, 6, 0)
    assert _read_sums(out) == expected_emissions(240)


def test_gang_under_the_distributed_executor_equals_the_per_rank_job(tmp_path):
    """resnet-train at a tiny size on two gloo processes: the gang at
    parallelism 2 under the DistributedExecutor (one job, source
    interleaved so each rank reads its partition, losses rebalanced to
    process 0) against the per-rank job on the same ranks: the same
    losses and final params and statistics, bit for bit, and process 0's
    sink receives every (rank, step) once."""
    out, chk = str(tmp_path / "out"), str(tmp_path / "chk")
    for _ in range(3):
        gloo, *ports = free_ports(3)
        procs = [_spawn(i, ports, out, chk=chk, n=48, every=8, job="gang",
                        extra=("--gloo-port", str(gloo))) for i in range(2)]
        results = [_wait(p, timeout=180) for p in procs]
        if not any(ADDR_IN_USE in log for _, log in results):
            break
    for rc, log in results:
        assert rc == 0, f"rank failed:\n{log}"
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    steps = 48 // 8
    per_rank = ranks[0]["per_rank"]
    assert [s for s, _ in per_rank] == list(range(1, steps + 1))
    assert sorted((g, s) for g, s, _ in ranks[0]["cohort"]) == [
        (g, s) for g in range(2) for s in range(1, steps + 1)]
    assert ranks[1]["cohort"] == []
    for g, s, loss in ranks[0]["cohort"]:
        assert loss == per_rank[s - 1][1]
    for r in ranks:
        assert r["per_rank"] == per_rank
        for coll in r["per_rank_variables"]:
            for name, t in r["per_rank_variables"][coll].items():
                assert torch.equal(r["cohort_variables"][coll][name], t), name
    # Checkpoints every 8 records of each source subtask: 2 steps apart.
    dirs = [os.path.join(chk, f"proc-{i:05d}") for i in range(2)]
    assert latest_common_checkpoint(dirs) == 3
