"""Aligned checkpoints, restore, restart and rescale in the port, each
scenario run through both packages on the same records: the final keyed
state of the port's run equals the JAX run's (twins of
``tests/test_checkpoint.py``, ``tests/test_failover.py::TestRestartStrategy``
and ``TestPeriodicCheckpoints``, and ``tests/test_rescale.py``).  Also: a
torch tensor in keyed state reads back from disk as a CPU object, and a
checkpoint pins its ``max_parallelism``."""

import os
import threading
import time

import numpy as np
import pytest
import torch

import flink_tensorflow_tpu as jax_pkg
from flink_tensorflow_tpu.checkpoint import store as jax_store
from flink_tensorflow_tpu.core import environment as jax_env
from flink_tensorflow_tpu.core import functions as jax_fn
from flink_tensorflow_tpu.core import operators as jax_ops
from flink_tensorflow_tpu.core import runtime as jax_runtime
from flink_tensorflow_tpu.core import state as jax_state
from flink_tensorflow_tpu_torch.checkpoint import store as port_store
from flink_tensorflow_tpu_torch.core import environment as port_env
from flink_tensorflow_tpu_torch.core import functions as port_fn
from flink_tensorflow_tpu_torch.core import operators as port_ops
from flink_tensorflow_tpu_torch.core import runtime as port_runtime
from flink_tensorflow_tpu_torch.core import state as port_state


class Pkg:
    def __init__(self, name, env, fn, ops, runtime, state, store):
        self.name = name
        self.Env = env.StreamExecutionEnvironment
        self.RestartStrategy = env.RestartStrategy
        self.fn = fn
        self.StateNotRescalable = ops.StateNotRescalable
        self.JobFailure = runtime.JobFailure
        self.JobTimeout = runtime.JobTimeout
        self.Descriptor = state.StateDescriptor
        self.store = store


PKGS = [Pkg("jax", jax_env, jax_fn, jax_ops, jax_runtime, jax_state, jax_store),
        Pkg("torch", port_env, port_fn, port_ops, port_runtime, port_state, port_store)]
assert jax_pkg.StreamExecutionEnvironment is jax_env.StreamExecutionEnvironment

N = 300
KEYS = 3
EXPECTED = {k: len([x for x in range(N) if x % KEYS == k]) for k in range(KEYS)}


def both(scenario, tmp_path):
    """``scenario(pkg, dir)`` in each package; returns ``{name: result}``
    after asserting the port's result equals the JAX package's."""
    out = {p.name: scenario(p, str(tmp_path / p.name)) for p in PKGS}
    assert out["torch"] == out["jax"]
    return out["torch"]


def keyed_counter(pkg):
    count = pkg.Descriptor("count", default_factory=lambda: 0)

    class KeyedCounter(pkg.fn.ProcessFunction):
        def process_element(self, value, ctx, out):
            state = ctx.state(count)
            n = state.value() + 1
            state.update(n)
            out.collect((ctx.current_key, n))

    return KeyedCounter()


def build_counter(pkg, env):
    return (env.from_collection(list(range(N))).key_by(lambda x: x % KEYS)
            .process(keyed_counter(pkg), parallelism=2).sink_to_list())


def finals(out):
    result = {}
    for key, n, *_ in out:
        result[key] = max(result.get(key, 0), n)
    return result


# -- tests/test_checkpoint.py -------------------------------------------------
def test_checkpoint_restore_is_exactly_once(tmp_path):
    def scenario(pkg, d):
        env1 = pkg.Env(parallelism=2)
        env1.enable_checkpointing(d)
        env1.source_throttle_s = 0.005
        build_counter(pkg, env1)
        handle = env1.execute_async()
        time.sleep(0.4)
        snapshots = handle.trigger_checkpoint(timeout=30)
        offsets = [s["operator"]["offset"] for s in snapshots["collection"].values()]
        assert 0 < sum(offsets) < N, offsets
        handle.cancel()
        handle.wait(timeout=30)
        assert pkg.store.latest_checkpoint_id(d) == 1
        env2 = pkg.Env(parallelism=2)
        out = build_counter(pkg, env2)
        env2.execute(restore_from=d, timeout=60)
        return finals(out)

    assert both(scenario, tmp_path) == EXPECTED


def test_uninterrupted_run_matches(tmp_path):
    def scenario(pkg, d):
        env = pkg.Env(parallelism=2)
        out = build_counter(pkg, env)
        env.execute(timeout=60)
        return sorted(out)

    assert finals(both(scenario, tmp_path)) == EXPECTED


def test_checkpoint_store_roundtrip_reads_across_packages(tmp_path):
    snap = {"task": {0: {"keyed": {"w": {1: np.arange(5)}}, "operator": None, "function": None}}}
    for writer, reader in ((port_store, jax_store), (jax_store, port_store)):
        d = str(tmp_path / writer.__name__.split(".")[0])
        path = writer.write_checkpoint(d, 7, snap)
        assert path.endswith("chk-000007")
        cid, loaded = reader.read_checkpoint(d)
        assert cid == 7
        np.testing.assert_array_equal(loaded["task"][0]["keyed"]["w"][1], np.arange(5))


def test_checkpoint_after_finish_uses_final_snapshots(tmp_path):
    def scenario(pkg, d):
        env = pkg.Env(parallelism=2)
        build_counter(pkg, env)
        handle = env.execute_async()
        handle.wait(timeout=60)
        snaps = handle.trigger_checkpoint(timeout=10)
        keyed = {}
        for s in snaps["keyed_process"].values():
            keyed.update(s["keyed"].get("count", {}))
        return sum(s["operator"]["offset"] for s in snaps["collection"].values()), keyed

    assert both(scenario, tmp_path) == (N, EXPECTED)


def test_concurrent_triggers_queue_instead_of_failing(tmp_path):
    def scenario(pkg, d):
        env = pkg.Env(parallelism=2)
        env.source_throttle_s = 0.002
        build_counter(pkg, env)
        handle = env.execute_async()
        time.sleep(0.1)
        results, errors = [], []

        def fire():
            try:
                results.append(handle.trigger_checkpoint(timeout=30))
            except Exception as e:  # noqa: BLE001 - recorded for the assert
                errors.append(e)

        threads = [threading.Thread(target=fire) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        handle.cancel()
        handle.wait(timeout=30)
        return errors, len(results), sorted(handle.executor.coordinator.completed_ids)

    assert both(scenario, tmp_path) == ([], 3, [1, 2, 3])


def retention_run(pkg, d, retain, *, restore_id=None, n=70, every=10):
    env = pkg.Env(parallelism=1)
    env.enable_checkpointing(d, every_n_records=every, retain_last=retain)
    out = env.from_collection(list(range(n)), parallelism=1).map(lambda x: x + 1).sink_to_list()
    env.execute("retention", timeout=60, restore_from=None if restore_id is None else d,
                restore_checkpoint_id=restore_id)
    return out


class TestRetention:
    def test_prunes_to_newest_n(self, tmp_path):
        def scenario(pkg, d):
            out = retention_run(pkg, d, retain=2)
            return pkg.store.checkpoint_ids(d), sorted(out)

        ids, out = both(scenario, tmp_path)
        assert ids == [6, 7] and out == list(range(1, 71))

    def test_restore_from_retained(self, tmp_path):
        def scenario(pkg, d):
            retention_run(pkg, d, retain=2)
            cid = pkg.store.checkpoint_ids(d)[-1]
            return cid, sorted(retention_run(pkg, d, retain=2, restore_id=cid))

        cid, out = both(scenario, tmp_path)
        assert out == list(range(cid * 10 + 1, 71))

    @pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
    def test_retain_and_trigger_validation(self, pkg, tmp_path):
        env = pkg.Env(parallelism=1)
        env.enable_checkpointing(str(tmp_path), every_n_records=4, retain_last=0)
        with pytest.raises(ValueError, match="retain_last"):
            env.config.validate()
        env.enable_checkpointing(str(tmp_path), every_n_records=4, retain_last=1)
        env.configure(checkpoint=env.config.checkpoint.__class__(
            dir=str(tmp_path), interval_s=1.0, every_n_records=4))
        with pytest.raises(ValueError, match="mutually exclusive"):
            env.config.validate()

    def test_prune_helper_keeps_newest(self, tmp_path):
        def scenario(pkg, d):
            for cid in range(1, 6):
                pkg.store.write_checkpoint(d, cid, {"op": {0: {"v": cid}}})
            deleted = pkg.store.prune_checkpoints(d, keep_last=2)
            return deleted, pkg.store.checkpoint_ids(d), pkg.store.prune_checkpoints(d, 2)

        assert both(scenario, tmp_path) == ([1, 2, 3], [4, 5], [])

    def test_manual_trigger_path_prunes(self, tmp_path):
        def scenario(pkg, d):
            env = pkg.Env(parallelism=1)
            env.enable_checkpointing(d, retain_last=1)
            env.configure(source_throttle_s=0.01)
            env.from_collection(list(range(300)), parallelism=1).map(lambda x: x).sink_to_list()
            handle = env.execute_async("manual-retention")
            for _ in range(3):
                handle.trigger_checkpoint()
            handle.wait(60)
            return len(pkg.store.checkpoint_ids(d))

        assert both(scenario, tmp_path) == 1

    def test_orphaned_pruning_dir_is_reaped(self, tmp_path):
        def scenario(pkg, d):
            for cid in (1, 2, 3):
                pkg.store.write_checkpoint(d, cid, {"op": {0: {"v": cid}}})
            os.rename(os.path.join(d, "chk-000001"), os.path.join(d, "chk-000001.pruning"))
            ids = pkg.store.checkpoint_ids(d)
            pkg.store.prune_checkpoints(d, keep_last=2)
            return ids, sorted(os.listdir(d))

        assert both(scenario, tmp_path) == ([2, 3], ["chk-000002", "chk-000003"])


# -- tests/test_failover.py -----------------------------------------------------
def fail_once(pkg, fail_at, crashed):
    count = pkg.Descriptor("count", lambda: 0)

    class FailOnce(pkg.fn.ProcessFunction):
        """Counts records per key; crashes once at a chosen record count
        (the flag is shared across clones and restarts)."""

        def __init__(self):
            self._seen = 0

        def clone(self):
            return FailOnce()

        def process_element(self, value, ctx, out):
            self._seen += 1
            if not crashed[0] and self._seen >= fail_at:
                crashed[0] = True
                raise RuntimeError("injected failure")
            state = ctx.state(count)
            state.update((state.value() or 0) + 1)
            out.collect((ctx.current_key, state.value(), value))

        def snapshot_state(self):
            return {"seen": self._seen}

        def restore_state(self, state):
            self._seen = state["seen"]

    return FailOnce()


class TestRestartStrategy:
    def test_restart_resumes_from_checkpoint(self, tmp_path):
        n = 200

        def scenario(pkg, d):
            crashed = [False]
            env = pkg.Env(parallelism=2)
            env.enable_checkpointing(d, interval_s=0.05)
            env.source_throttle_s = 0.002
            out = (env.from_collection(list(range(n))).key_by(lambda x: x % 4)
                   .process(fail_once(pkg, 50, crashed), name="count").sink_to_list())
            result = env.execute(timeout=120, restart_strategy=pkg.RestartStrategy(max_restarts=2))
            rep = env.metric_registry.report()
            return (result.restarts, crashed[0], finals(out), {v for _, _, v in out} == set(range(n)),
                    rep["recovery.restarts_total"], rep["recovery.recovery_duration_s"]["count"])

        assert both(scenario, tmp_path) == (1, True, {k: n // 4 for k in range(4)}, True, 1, 1)

    def test_restarts_exhausted_raises(self, tmp_path):
        def scenario(pkg, d):
            env = pkg.Env(parallelism=1)
            env.enable_checkpointing(d)

            class AlwaysFail(pkg.fn.MapFunction):
                def map(self, value):
                    raise RuntimeError("boom")

            env.from_collection([1, 2, 3]).map(AlwaysFail()).sink_to_list()
            with pytest.raises(pkg.JobFailure):
                env.execute(timeout=60, restart_strategy=pkg.RestartStrategy(max_restarts=1))
            return env.metric_registry.report()["recovery.restarts_total"]

        assert both(scenario, tmp_path) == 1

    def test_timeout_is_not_retried(self, tmp_path):
        def scenario(pkg, d):
            env = pkg.Env(parallelism=1)
            env.enable_checkpointing(d)
            env.source_throttle_s = 0.05
            env.from_collection(list(range(1000))).map(lambda x: x).sink_to_list()
            t0 = time.monotonic()
            with pytest.raises(pkg.JobTimeout):
                env.execute(timeout=0.5, restart_strategy=pkg.RestartStrategy(max_restarts=5))
            return time.monotonic() - t0 < 5.0

        assert both(scenario, tmp_path)

    @pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
    def test_restart_requires_checkpointing(self, pkg):
        env = pkg.Env(parallelism=1)
        env.from_collection([1]).sink_to_list()
        with pytest.raises(ValueError):
            env.execute(restart_strategy=pkg.RestartStrategy())

    @pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
    def test_backoff_schedule(self, pkg):
        s = pkg.RestartStrategy(delay_s=0.5, backoff_multiplier=2.0, max_delay_s=3.0, jitter=0.1)
        other = PKGS[0].RestartStrategy(delay_s=0.5, backoff_multiplier=2.0, max_delay_s=3.0,
                                        jitter=0.1)
        assert [s.delay_for(a) for a in range(1, 6)] == [other.delay_for(a) for a in range(1, 6)]


class TestPeriodicCheckpoints:
    def test_periodic_snapshots_written(self, tmp_path):
        def scenario(pkg, d):
            env = pkg.Env(parallelism=1)
            env.enable_checkpointing(d, interval_s=0.05)
            env.source_throttle_s = 0.005
            out = env.from_collection(list(range(100))).map(lambda x: x).sink_to_list()
            env.execute(timeout=60)
            return pkg.store.latest_checkpoint_id(d) is not None, sorted(out)

        assert both(scenario, tmp_path) == (True, list(range(100)))


# -- tests/test_rescale.py --------------------------------------------------------
def keyed_sum(pkg):
    class KeyedSum(pkg.fn.ProcessFunction):
        def open(self, ctx):
            self._desc = pkg.Descriptor("sum")

        def process_element(self, value, ctx, out):
            state = ctx.state(self._desc)
            total = (state.value() or 0) + value["amount"]
            state.update(total)
            out.collect({"key": ctx.current_key, "sum": total})

    return KeyedSum()


def build_sum(pkg, env, records, parallelism, source_parallelism=1):
    return (env.from_collection(records, parallelism=source_parallelism)
            .key_by(lambda r: r["key"])
            .process(keyed_sum(pkg), name="keyed_sum", parallelism=parallelism)
            .sink_to_list())


RECORDS = [{"key": f"k{i % 10}", "amount": i} for i in range(300)]


def run_until_checkpoint(pkg, d, parallelism, source_parallelism=1):
    env = pkg.Env(parallelism=1)
    env.enable_checkpointing(d)
    env.source_throttle_s = 0.002
    build_sum(pkg, env, RECORDS, parallelism, source_parallelism)
    handle = env.execute_async("rescale")
    time.sleep(0.2)
    snaps = handle.trigger_checkpoint()
    handle.cancel()
    handle.wait(timeout=30)
    state = {}
    for s in snaps["keyed_sum"].values():
        state.update(s["keyed"].get("sum", {}))
    return state


@pytest.mark.parametrize("old_p,new_p", [(2, 3), (3, 2), (1, 4)])
def test_keyed_state_redistributes(tmp_path, old_p, new_p):
    def scenario(pkg, d):
        run_until_checkpoint(pkg, d, old_p)
        env2 = pkg.Env(parallelism=1)
        env2.enable_checkpointing(d)
        out = build_sum(pkg, env2, RECORDS, new_p)
        env2.execute("rescale", restore_from=d, timeout=120)
        sums = {}
        for r in out:
            sums[r["key"]] = max(sums.get(r["key"], 0), r["sum"])
        return sums

    want = {}
    for r in RECORDS:
        want[r["key"]] = want.get(r["key"], 0) + r["amount"]
    assert both(scenario, tmp_path) == want


@pytest.mark.parametrize("old_p,new_p", [(2, 3), (3, 2), (1, 4)])
def test_rescale_hook_matches_jax_on_the_same_snapshot(old_p, new_p):
    """The same checkpointed tables through both packages' ``rescale``
    land each key on the same new subtask."""
    rng = np.random.RandomState(old_p * 10 + new_p)
    keys = [f"k{i}" for i in range(40)] + list(range(40)) + [(i, "t") for i in range(10)]
    old = {i: {"keyed": {"sum": {}}, "function": None, "operator": {"timers": []}}
           for i in range(old_p)}
    for key in keys:
        owner = jax_pkg.core.partitioning.subtask_for_key(key, old_p, 128)
        old[owner]["keyed"]["sum"][key] = int(rng.randint(1000))
    for index in range(new_p):
        want = jax_ops.ProcessOperator("p", keyed_sum(PKGS[0]), lambda r: r).rescale(
            old, index, new_p, 128)
        got = port_ops.ProcessOperator("p", keyed_sum(PKGS[1]), lambda r: r).rescale(
            old, index, new_p, 128)
        assert got == want


def test_source_rescale_raises(tmp_path):
    def scenario(pkg, d):
        run_until_checkpoint(pkg, d, 2, source_parallelism=2)
        env2 = pkg.Env(parallelism=1)
        env2.enable_checkpointing(d)
        build_sum(pkg, env2, RECORDS, 2, source_parallelism=4)  # changed!
        with pytest.raises(pkg.StateNotRescalable, match="source"):
            env2.execute("src", restore_from=d, timeout=120)
        return True

    assert both(scenario, tmp_path)


# -- the port's own rules -------------------------------------------------------
def test_torch_tensor_in_keyed_state_reads_back_on_the_cpu(tmp_path):
    """Keyed state holding tensors checkpoints through the port's runtime
    and reads back as CPU tensors (on the card, ``tests/
    test_torch_keyed_cuda.py`` writes CUDA tensors the same way)."""
    weights = port_state.StateDescriptor("w")

    class Accumulate(port_fn.ProcessFunction):
        def process_element(self, value, ctx, out):
            state = ctx.state(weights)
            prev = state.value()
            state.update(torch.full((3,), float(value)) + (0 if prev is None else prev))

    d = str(tmp_path)
    env = port_env.StreamExecutionEnvironment(parallelism=1)
    env.enable_checkpointing(d, every_n_records=5)
    env.from_collection(list(range(10))).key_by(lambda x: x % 2).process(Accumulate()) \
        .sink_to_list()
    env.execute(timeout=60)
    cid, snaps = port_store.read_checkpoint(d)
    table = snaps["keyed_process"][0]["keyed"]["w"]
    assert cid == 2 and set(table) == {0, 1}
    for key, value in table.items():
        assert isinstance(value, torch.Tensor) and value.device.type == "cpu"
        assert value.tolist() == [float(sum(range(key, 10, 2)))] * 3


def test_to_host_moves_tensors_and_keeps_host_objects():
    import dataclasses
    import collections

    @dataclasses.dataclass(frozen=True)
    class Holder:
        t: object
        n: int = 3

    Pair = collections.namedtuple("Pair", "a b")
    host = {"a": np.arange(3), "b": [1, (2, "x")]}
    assert port_store.to_host(host) is host
    t = torch.arange(4.0)
    obj = {"h": Holder(t), "p": Pair(t, 1), "l": [t]}
    assert port_store.to_host(obj) is obj  # CPU tensors stay as they are


def test_max_parallelism_pin_raises(tmp_path):
    d = str(tmp_path)
    env = port_env.StreamExecutionEnvironment(parallelism=2)
    env.enable_checkpointing(d, every_n_records=50)
    build_counter(PKGS[1], env)
    env.execute(timeout=60)
    assert port_store.latest_checkpoint_id(d) is not None
    env2 = port_env.StreamExecutionEnvironment(parallelism=2)
    env2.configure(max_parallelism=64)
    build_counter(PKGS[1], env2)
    with pytest.raises(ValueError, match="max_parallelism=128"):
        env2.execute(restore_from=d, timeout=60)
    env3 = port_env.StreamExecutionEnvironment(parallelism=4)
    env3.configure(max_parallelism=1)
    build_counter(PKGS[1], env3)
    with pytest.raises(ValueError, match="exceeds max_parallelism"):
        env3.execute(timeout=60)
