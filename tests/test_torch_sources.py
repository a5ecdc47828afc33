"""The port's split sources (``flink_tensorflow_tpu_torch/sources/``) held
to the JAX package's (``flink_tensorflow_tpu/sources/``).

Each case runs the same inputs, made here from numpy seeds, through both
packages and compares the results:

- exactly: ``range_splits``, the enumerators' order, add-back and
  snapshots, the file chunking, the mailbox's signals, the paced
  schedule (``NotReady`` due times and ``sched_ts`` stamps, on one
  injected clock), the coordinators' freeze and thaw, chain plans;
- as multisets, with the same invariants in both: jobs whose timing
  varies from run to run (readers pulling splits, mid-split snapshots,
  restores and a 2 -> 3 rescale, count-based barriers), where every
  record must come out exactly once.

The mirrored classes are those of ``tests/test_split_sources.py`` except
its lint, Prometheus and schema tests, whose planes the port does not
have yet.
"""

import dataclasses
import threading
import time
import types

import numpy as np
import pytest

import flink_tensorflow_tpu.sources as jax_sources
import flink_tensorflow_tpu.sources.paced as jax_paced
import flink_tensorflow_tpu_torch.sources as port_sources
import flink_tensorflow_tpu_torch.sources.paced as port_paced
from flink_tensorflow_tpu import StreamExecutionEnvironment as JaxEnv
from flink_tensorflow_tpu.analysis.chaining import compute_chains as jax_chains
from flink_tensorflow_tpu.checkpoint.store import checkpoint_ids as jax_checkpoint_ids
from flink_tensorflow_tpu.core import functions as jax_fn
from flink_tensorflow_tpu.io.files import write_record_file as jax_write
from flink_tensorflow_tpu.tensors import TensorValue as JaxTensorValue
from flink_tensorflow_tpu_torch.analysis.chaining import compute_chains as port_chains
from flink_tensorflow_tpu_torch.checkpoint.store import checkpoint_ids as port_checkpoint_ids
from flink_tensorflow_tpu_torch.core import functions as port_fn
from flink_tensorflow_tpu_torch.core.environment import StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.io.files import write_record_file as port_write
from flink_tensorflow_tpu_torch.sources.coordinator import SplitCoordinator
from flink_tensorflow_tpu_torch.tensors.value import TensorValue

PKGS = {
    "port": types.SimpleNamespace(Env=StreamExecutionEnvironment, src=port_sources,
                                  paced=port_paced, fn=port_fn, write=port_write,
                                  TensorValue=TensorValue, chains=port_chains,
                                  checkpoint_ids=port_checkpoint_ids),
    "jax": types.SimpleNamespace(Env=JaxEnv, src=jax_sources, paced=jax_paced, fn=jax_fn,
                                 write=jax_write, TensorValue=JaxTensorValue,
                                 chains=jax_chains, checkpoint_ids=jax_checkpoint_ids),
}
BOTH = pytest.mark.parametrize("pkg", ["port", "jax"])
WAIT_S = 20.0


def wait_for(cond, what):
    deadline = time.monotonic() + WAIT_S
    while not cond():
        if time.monotonic() > deadline:
            pytest.fail(f"timed out waiting for {what}")
        time.sleep(0.005)


def report(env):
    return env.metric_registry.report()


def write_skewed_files(p, directory, sizes, tag):
    """One frame file per size; each record carries a running ``id``."""
    paths, idx = [], 0
    for f, n in enumerate(sizes):
        path = str(directory / f"{tag}-part-{f:02d}.rec")
        p.write(path, [p.TensorValue({"x": np.float32(idx + i)}, {"id": idx + i})
                       for i in range(n)])
        idx += n
        paths.append(path)
    return paths, idx


def split_rows(splits):
    return [(type(s).__name__, dataclasses.asdict(s)) for s in splits]


# -- primitives ----------------------------------------------------------------
@pytest.mark.parametrize("total,num_splits", [(10, 4), (3, 8), (0, 4), (200, 7), (1, 1),
                                              (97, 13)])
def test_range_splits_partition_exactly(total, num_splits):
    got = port_sources.range_splits(total, num_splits)
    assert split_rows(got) == split_rows(jax_sources.range_splits(total, num_splits))
    assert [i for s in got for i in range(s.start, s.stop)] == list(range(total))


def enumerator_trace(p):
    e = p.src.ListSplitEnumerator(p.src.range_splits(12, 3))
    first = e.next_split(0)
    e.add_splits_back([first])
    trace = [first.split_id]
    while (s := e.next_split(1)) is not None:
        trace.append(s.split_id)
    return trace


def test_enumerator_fifo_and_add_back_front():
    got = enumerator_trace(PKGS["port"])
    assert got == enumerator_trace(PKGS["jax"])
    assert got == ["range[0:4]", "range[0:4]", "range[4:8]", "range[8:12]"]


def snapshot_trace(p):
    e = p.src.ListSplitEnumerator(p.src.range_splits(8, 2))
    snap = e.snapshot_state()
    live = e.next_split(0)
    live.offset = 3
    restored = p.src.ListSplitEnumerator([])
    restored.restore_state(snap)
    again = restored.next_split(0)
    return live.split_id, again.split_id, again.offset, live.freeze() is not live


def test_enumerator_snapshot_insulated_from_live_mutation():
    got = snapshot_trace(PKGS["port"])
    assert got == snapshot_trace(PKGS["jax"]) == ("range[0:4]", "range[0:4]", 0, True)


def mailbox_trace(p):
    m = p.src.SourceMailbox()
    m.notify()   # posted while the loop is busy, before it parks
    m.notify()
    first = m.wait(timeout=0.0)
    t0 = time.monotonic()
    second = m.wait(timeout=0.05)   # drained: a real park
    parked = time.monotonic() - t0 >= 0.04
    woke = []
    t = threading.Thread(target=lambda: woke.append(m.wait(timeout=WAIT_S)))
    t.start()
    time.sleep(0.02)
    m.close()
    t.join(WAIT_S)
    m.notify()   # a no-op after close
    return first, second, parked, woke, m.wait(timeout=None), m.closed


def test_mailbox_signal_not_lost_between_waits_and_close_is_sticky():
    got = mailbox_trace(PKGS["port"])
    assert got == mailbox_trace(PKGS["jax"]) == (True, False, True, [True], True, True)


@pytest.mark.parametrize("case", ["replay_0", "file_0", "paced_rate", "paced_cycles",
                                  "paced_jitter", "paced_splits"])
def test_invalid_args_rejected(case):
    for p in PKGS.values():
        build = {"replay_0": lambda: p.src.ReplaySplitSource([1], num_splits=0),
                 "file_0": lambda: p.src.FileSplitSource(["x"], records_per_split=0),
                 "paced_rate": lambda: p.src.PacedSplitSource([1], rate_hz=0.0),
                 "paced_cycles": lambda: p.src.PacedSplitSource([1], rate_hz=1.0, cycles=0),
                 "paced_jitter": lambda: p.src.PacedSplitSource([1], 1.0, jitter="x"),
                 "paced_splits": lambda: p.src.PacedSplitSource([1], 1.0, num_splits=0)}[case]
        with pytest.raises(ValueError):
            build()


@BOTH
def test_from_source_rejects_unknown_source_type(pkg):
    with pytest.raises(TypeError):
        PKGS[pkg].Env(parallelism=1).from_source(object())


def test_plan_split_counts_equal_the_references(tmp_path):
    def counts(p):
        return [p.src.ReplaySplitSource(list(range(10)), num_splits=4).plan_split_count(),
                p.src.ReplaySplitSource([], num_splits=4).plan_split_count(),
                p.src.FileSplitSource(["a", "b"]).plan_split_count(),
                p.src.FileSplitSource(["a"], records_per_split=3).plan_split_count(),
                p.src.PacedSplitSource(list(range(5)), 1.0, num_splits=3,
                                       cycles=2).plan_split_count(),
                p.src.PacedSplitSource(list(range(5)), 1.0, cycles=None).plan_split_count()]

    assert counts(PKGS["port"]) == counts(PKGS["jax"]) == [4, 0, 2, None, 6, None]


# -- jobs: every record once ---------------------------------------------------
@BOTH
def test_from_source_runs_the_split_loop_and_every_record_once(pkg, monkeypatch):
    p = PKGS[pkg]
    loops = []
    if pkg == "port":
        from flink_tensorflow_tpu_torch.core.runtime import _Subtask

        body = _Subtask.run_split_source

        def counted(st):
            loops.append(st.scope)
            body(st)

        monkeypatch.setattr(_Subtask, "run_split_source", counted)
    env = p.Env(parallelism=1)
    out = (env.from_source(p.src.ReplaySplitSource(list(range(200)), num_splits=7),
                           name="replay", parallelism=3)
           .rebalance().map(lambda x: x, name="m", parallelism=2).sink_to_list())
    handle = env.execute_async()
    handle.wait(60)
    if pkg == "port":
        sources = [st for st in handle.executor.subtasks if st.t.name == "replay"]
        assert all(st.mailbox is not None for st in sources)
        assert sorted(loops) == ["replay.0", "replay.1", "replay.2"]
    assert sorted(out) == list(range(200))
    rep = report(env)
    assert sum(rep[f"replay.{i}.splits_completed"] for i in range(3)) == 7
    assert rep["replay.0.splits_assigned"] == 7


def readers_job(p, kind, tmp_path, data):
    """``data`` (ints) through a ``kind`` split source at parallelism 4 ->
    rebalance -> map -> sink; the ints that came out and the splits each
    reader completed."""
    env = p.Env(parallelism=1)
    if kind == "replay":
        source = p.src.ReplaySplitSource(list(data), num_splits=9)
    elif kind == "paced":
        source = p.src.PacedSplitSource(list(data), 4000.0, jitter="poisson", seed=3,
                                        num_splits=9)
    else:
        sizes = [len(data) // 2] + [len(data) // 16] * 8
        paths, _ = write_skewed_files(p, tmp_path, sizes, f"{kind}-{id(p)}")
        source = p.src.FileSplitSource(paths)
    value = (lambda r: int(r.meta["id"])) if kind == "file" else (lambda x: int(x))
    out = (env.from_source(source, name="src", parallelism=4).rebalance()
           .map(value, name="m", parallelism=2).sink_to_list())
    env.execute(timeout=60)
    rep = report(env)
    return sorted(out), [rep[f"src.{i}.splits_completed"] for i in range(4)]


@pytest.mark.parametrize("kind", ["replay", "file", "paced"])
def test_records_exactly_once_across_4_readers(kind, tmp_path):
    data = np.random.RandomState(4).permutation(96)
    port_out, port_done = readers_job(PKGS["port"], kind, tmp_path, data)
    jax_out, jax_done = readers_job(PKGS["jax"], kind, tmp_path, data)
    want = list(range(96)) if kind == "file" else sorted(int(x) for x in data)
    assert port_out == jax_out == want
    assert sum(port_done) == sum(jax_done) == 9


@BOTH
def test_chains_with_forward_downstream(pkg):
    p = PKGS[pkg]
    env = p.Env(parallelism=1)
    out = (env.from_source(p.src.ReplaySplitSource(list(range(50)), num_splits=2),
                           name="replay", parallelism=1)
           .map(lambda x: x * 2, name="dbl", parallelism=1).sink_to_list())
    handle = env.execute_async()
    assert len(handle.executor.subtasks) == 1 and handle.executor._gates == []
    handle.wait(60)
    assert sorted(out) == [2 * x for x in range(50)]


def test_file_splits_chunk_as_the_reference(tmp_path):
    rows = {}
    for pkg, p in PKGS.items():
        paths, _ = write_skewed_files(p, tmp_path, [10, 3], pkg)
        e = p.src.FileSplitSource(paths, records_per_split=4).create_enumerator()
        splits = []
        while (s := e.next_split(0)) is not None:
            splits.append((s.split_id.replace(pkg, "P"), s.start, s.stop, s.offset))
        rows[pkg] = splits
    assert rows["port"] == rows["jax"]
    assert [(a, b) for _, a, b, _ in rows["port"]] == [(0, 4), (4, 8), (8, 10), (0, 3)]


@BOTH
def test_per_file_splits_roundtrip(pkg, tmp_path):
    p = PKGS[pkg]
    paths, total = write_skewed_files(p, tmp_path, [5, 3, 2], pkg)
    env = p.Env(parallelism=1)
    out = (env.from_source(p.src.FileSplitSource(paths), name="files", parallelism=2)
           .rebalance().map(lambda r: int(r.meta["id"]), name="ids", parallelism=1)
           .sink_to_list())
    env.execute(timeout=60)
    assert sorted(out) == list(range(total))


@BOTH
def test_skewed_files_work_stealing_at_parallelism_4(pkg, tmp_path):
    """One file holds about half the records; with 12 splits and 4 pulling
    readers, every reader completes a split and one of them takes more
    than a static quarter of the splits."""
    p = PKGS[pkg]
    sizes = [60, 12, 8] + [4] * 9
    paths, total = write_skewed_files(p, tmp_path, sizes, pkg)
    env = p.Env(parallelism=1)
    env.source_throttle_s = 0.001  # keep the four readers overlapped
    out = (env.from_source(p.src.FileSplitSource(paths), name="files", parallelism=4)
           .rebalance().map(lambda r: int(r.meta["id"]), name="ids", parallelism=2)
           .sink_to_list())
    env.execute(timeout=120)
    assert sorted(out) == list(range(total))
    per_subtask = [report(env)[f"files.{i}.splits_completed"] for i in range(4)]
    assert sum(per_subtask) == len(sizes)
    assert all(v >= 1 for v in per_subtask), per_subtask
    assert max(per_subtask) > len(sizes) // 4, per_subtask


# -- the paced schedule ----------------------------------------------------------
class Clock:
    """A monotonic clock that moves only when told."""

    def __init__(self, t: float):
        self.t = t

    def monotonic(self) -> float:
        return self.t


def schedule(p, monkeypatch, *, jitter, seed, num_splits, offset, start_delay_s):
    """Every split's reader on one injected clock: the due time of each
    ``NotReady`` (the clock jumps to it) and each record's ``sched_ts``."""
    clock = Clock(1000.0)
    monkeypatch.setattr(p.paced, "time", clock)
    records = [p.TensorValue({"x": np.float32(i)}, {"id": i}) for i in range(23)]
    source = p.src.PacedSplitSource(records, 50.0, jitter=jitter, seed=seed,
                                    num_splits=num_splits, start_delay_s=start_delay_s)
    enum = source.create_enumerator()
    reader = source.create_reader(None)
    trace = []
    while (split := enum.next_split(0)) is not None:
        split.offset = min(offset, split.stop - split.start)
        for value in reader.read(split):
            if isinstance(value, p.src.NotReady):
                trace.append(("wait", value.due))
                clock.t = value.due
            else:
                trace.append((int(value.meta["id"]), value.meta["sched_ts"]))
    return trace


@pytest.mark.parametrize("jitter,seed,num_splits,offset,start_delay_s", [
    ("poisson", 0, 1, 0, 1.5), ("poisson", 7, 3, 0, 0.0), ("poisson", 11, 4, 2, 0.25),
    ("none", 0, 2, 0, 0.5), ("none", 0, 1, 5, 0.0)])
def test_paced_schedule_and_stamps_equal_the_references(monkeypatch, jitter, seed, num_splits,
                                                         offset, start_delay_s):
    kw = dict(jitter=jitter, seed=seed, num_splits=num_splits, offset=offset,
              start_delay_s=start_delay_s)
    got = schedule(PKGS["port"], monkeypatch, **kw)
    want = schedule(PKGS["jax"], monkeypatch, **kw)
    assert got == want
    ids = [k for k, _ in got if k != "wait"]
    assert len(ids) == 23 - num_splits * offset if offset else ids == list(range(23))


@BOTH
def test_paces_and_stamps_schedule(pkg):
    p = PKGS[pkg]
    n, rate = 12, 120.0
    env = p.Env(parallelism=1)
    records = [p.TensorValue({"x": np.float32(i)}, {"id": i}) for i in range(n)]
    out = []
    (env.from_source(p.src.PacedSplitSource(records, rate, jitter="none", num_splits=1),
                     name="paced", parallelism=1)
     .sink_to_callable(lambda r: out.append((r.meta["sched_ts"], time.monotonic(),
                                             r.meta["id"]))))
    t0 = time.monotonic()
    env.execute(timeout=60)
    wall = time.monotonic() - t0
    assert [rid for _, _, rid in out] == list(range(n))
    assert wall >= (n - 1) / rate * 0.9   # open loop: no faster than the schedule
    assert all(arrived >= sched - 1e-3 for sched, arrived, _ in out)


@BOTH
def test_unbounded_runs_until_cancelled(pkg):
    p = PKGS[pkg]
    env = p.Env(parallelism=1)
    out = (env.from_source(p.src.PacedSplitSource(list(range(4)), 400.0, jitter="none",
                                                  num_splits=1, cycles=None),
                           name="forever", parallelism=1).sink_to_list())
    handle = env.execute_async()
    wait_for(lambda: len(out) > 4, "a second cycle")
    handle.cancel()
    # The cancel wakes the mailbox park: the thread ends promptly.
    for st in handle.executor.subtasks:
        st.thread.join(timeout=5.0)
        assert not st.thread.is_alive()


@BOTH
def test_barriers_served_during_schedule_waits(pkg, tmp_path):
    """A sparse schedule parks the source for about 1 s at a time; a
    checkpoint triggered in the wait completes at once."""
    p = PKGS[pkg]
    env = p.Env(parallelism=1)
    env.enable_checkpointing(str(tmp_path / "chk"))
    records = [p.TensorValue({"x": np.float32(i)}, {"id": i}) for i in range(4)]
    (env.from_source(p.src.PacedSplitSource(records, 1.0, jitter="none", num_splits=1),
                     name="sparse", parallelism=1).sink_to_list())
    handle = env.execute_async()
    time.sleep(0.2)   # parked inside the first gap
    t0 = time.monotonic()
    snaps = handle.trigger_checkpoint(timeout=30)
    latency = time.monotonic() - t0
    handle.cancel()
    handle.wait(timeout=30)
    assert "sparse" in snaps
    assert latency < 0.5, f"the barrier took {latency:.2f} s: the park must wake for it"


# -- chaining --------------------------------------------------------------------
def window_plan(p, split: bool):
    class SumWindow(p.fn.WindowFunction):
        def process_window(self, key, window, elements, out):
            out.collect(sum(elements))

    env = p.Env(parallelism=1)
    source = (env.from_source(p.src.ReplaySplitSource(list(range(32)), num_splits=2),
                              name="replay", parallelism=1) if split
              else env.from_collection(list(range(32)), parallelism=1))
    source.count_window(4, timeout_s=1.0).apply(SumWindow(), name="timed",
                                                parallelism=1).sink_to_list()
    plan = p.chains(env.graph)
    return env, plan.names(), sorted(plan.unchained_reasons.values())


def test_timer_window_fuses_behind_a_split_source_and_a_legacy_source_still_cuts():
    env, names, reasons = window_plan(PKGS["port"], split=True)
    assert (names, reasons) == window_plan(PKGS["jax"], split=True)[1:]
    assert ["replay", "timed", "collect"] in names and reasons == []
    assert "replay -> timed -> collect" in env.describe()
    legacy, names, reasons = window_plan(PKGS["port"], split=False)
    assert (names, reasons) == window_plan(PKGS["jax"], split=False)[1:]
    assert ["collection"] in names and any("timer-driven" in r for r in reasons)
    assert "collection -> timed" not in legacy.describe()


@BOTH
def test_chained_timeout_fires_mid_stream(pkg):
    """A count-or-timeout window inside the split-source chain flushes at
    its deadline while the paced source is parked."""
    p = PKGS[pkg]

    class SumWindow(p.fn.WindowFunction):
        def process_window(self, key, window, elements, out):
            out.collect(sum(elements))

    env = p.Env(parallelism=1)
    out = (env.from_source(p.src.PacedSplitSource(list(range(12)), 50.0, jitter="none",
                                                  num_splits=1), name="paced", parallelism=1)
           .count_window(100, timeout_s=0.06).apply(SumWindow(), name="win", parallelism=1)
           .sink_to_list())
    handle = env.execute_async()
    assert len(handle.executor.subtasks) == 1 and handle.executor._gates == []
    handle.wait(60)
    assert len(out) >= 2 and sum(out) == sum(range(12))
    assert not [k for k in report(env) if k.endswith("_queue_puts")]


# -- checkpoints -------------------------------------------------------------------
def replay_pipeline(p, env, n=200, num_splits=5, parallelism=2):
    return (env.from_source(p.src.ReplaySplitSource(list(range(n)), num_splits=num_splits),
                            name="replay", parallelism=parallelism)
            .rebalance().map(lambda x: x, name="m", parallelism=2).sink_to_list())


def mid_split_checkpoint(p, ckpt, parallelism=2):
    env = p.Env(parallelism=1)
    env.enable_checkpointing(ckpt)
    env.source_throttle_s = 0.005
    replay_pipeline(p, env, parallelism=parallelism)
    handle = env.execute_async()
    time.sleep(0.25)
    snaps = handle.trigger_checkpoint(timeout=30)
    handle.cancel()
    handle.wait(timeout=30)
    return snaps


@BOTH
def test_mid_split_snapshot_is_consistent(pkg, tmp_path):
    """At the barrier every split is in one place: a reader's in-flight
    snapshot (with its offset) or reader 0's pool, and the counts add up."""
    snaps = mid_split_checkpoint(PKGS[pkg], str(tmp_path / "chk"))
    ops = {i: s["operator"] for i, s in snaps["replay"].items()}
    emitted = sum(s["offset"] for s in ops.values())
    assert 0 < emitted < 200, "the checkpoint should be mid-stream"
    in_flight = [s["in_flight"] for s in ops.values() if s["in_flight"]]
    pool = ops[0]["pool"] or []
    ids = {s.split_id for s in in_flight} | {s.split_id for s in pool}
    assert len(ids) == len(in_flight) + len(pool), "a split both in flight and pooled"
    remaining = sum((s.stop - s.start) - s.offset for s in in_flight)
    pooled = sum((s.stop - s.start) - s.offset for s in pool)
    assert emitted + remaining + pooled == 200


@pytest.mark.parametrize("pkg,new_parallelism", [("port", 2), ("jax", 2), ("port", 3),
                                                 ("jax", 3)])
def test_restore_resumes_at_offsets_exactly_once(pkg, new_parallelism, tmp_path):
    """Restored at the same parallelism, or rescaled 2 -> 3: exactly the
    records not emitted before the barrier come out, each once."""
    p = PKGS[pkg]
    ckpt = str(tmp_path / "chk")
    snaps = mid_split_checkpoint(p, ckpt)
    emitted = sum(s["operator"]["offset"] for s in snaps["replay"].values())
    assert 0 < emitted < 200
    env = p.Env(parallelism=1)
    out = replay_pipeline(p, env, parallelism=new_parallelism)
    env.execute(restore_from=ckpt, timeout=60)
    assert len(out) == len(set(out)) == 200 - emitted
    rep = report(env)
    assert sum(rep[f"replay.{i}.splits_completed"] for i in range(new_parallelism)) >= 1


def count_based_job(p, ckpt, *, n, num_splits, parallelism, every_n):
    env = p.Env(parallelism=1)
    env.enable_checkpointing(ckpt, every_n_records=every_n)
    out = replay_pipeline(p, env, n=n, num_splits=num_splits, parallelism=parallelism)
    env.execute(timeout=60)
    return sorted(out), p.checkpoint_ids(ckpt)


@pytest.mark.parametrize("num_splits,parallelism,every_n", [(4, 1, 20), (2, 3, 20),
                                                             (10, 2, 15)])
def test_count_based_barriers_on_split_sources(num_splits, parallelism, every_n, tmp_path):
    """``every_n_records`` cuts at per-reader counts on the split loop.  At
    parallelism 3 over 2 splits one reader finds nothing and finishes; at
    10 splits of 10 and barriers every 15, a reader that ends a split
    short of its position while assignment is frozen has its barrier cut
    at its wait by the freeze-deadlock guard (and once only, when it later
    reaches the position), or the checkpoint would wait for it forever."""
    kw = dict(n=100, num_splits=num_splits, parallelism=parallelism, every_n=every_n)
    port_out, port_ids = count_based_job(PKGS["port"], str(tmp_path / "port"), **kw)
    jax_out, jax_ids = count_based_job(PKGS["jax"], str(tmp_path / "jax"), **kw)
    assert port_out == jax_out == list(range(100))
    assert port_ids and max(port_ids) >= 2 and jax_ids and max(jax_ids) >= 2


# -- the coordinator -------------------------------------------------------------
class Mailbox:
    def __init__(self):
        self.signals = 0

    def notify(self):
        self.signals += 1


def coordinator_trace(coord_cls, src):
    """Freeze, thaw by cancel, thaw by a finished reader, pool snapshots."""
    coord = coord_cls(src.ReplaySplitSource(list(range(40)), num_splits=4), 3)
    boxes = [Mailbox() for _ in range(3)]
    for i, box in enumerate(boxes):
        coord.add_reader(i, box)
    trace = []

    def poll(i):
        status, split = coord.poll_split(i)
        trace.append((status, split.split_id if split else None))

    poll(0)
    pool = coord.on_barrier(1, 0)                 # reader 0 cuts 1: frozen
    trace.append(("pool", [s.split_id for s in pool]))
    trace.append(("reader1_pool", coord.on_barrier(1, 1)))
    poll(2)                                       # wait: frozen
    trace.append(("pending", coord.pending_alignments(2), coord.pending_alignments(0)))
    coord.cancel_alignment(1)                     # the sweeper aborted 1: thaw
    trace.append(("signals", [b.signals for b in boxes]))
    poll(2)
    coord.on_barrier(2, 1)
    poll(0)
    coord.reader_finished(0)
    coord.reader_finished(2)                      # 2 now counts as passed by all
    trace.append(("signals", [b.signals for b in boxes], coord.pending_alignments(0)))
    poll(1)
    poll(1)
    poll(1)
    trace.append(("live", coord.live_pool_state(), coord.splits_dispensed))
    return trace


def test_coordinator_freezes_thaws_and_snapshots_as_the_reference():
    from flink_tensorflow_tpu.sources.coordinator import SplitCoordinator as JaxCoordinator

    got = coordinator_trace(SplitCoordinator, port_sources)
    assert got == coordinator_trace(JaxCoordinator, jax_sources)
    assert ("wait", None) in got and got[-1] == ("live", [], 4)


def test_restored_pool_reaches_the_enumerator_before_any_split():
    """The pool a restore delivers, and splits added back, are what the
    first readers pull."""
    got = {}
    for pkg, src in (("port", port_sources), ("jax", jax_sources)):
        from flink_tensorflow_tpu.sources.coordinator import SplitCoordinator as JaxCoordinator

        cls = SplitCoordinator if pkg == "port" else JaxCoordinator
        coord = cls(src.ReplaySplitSource(list(range(40)), num_splits=4), 2)
        pool = src.range_splits(40, 4)[2:]
        back = dataclasses.replace(src.range_splits(40, 4)[0], offset=7)
        coord.deliver_restored_state(pool)
        coord.add_splits_back([back])
        got[pkg] = [(s.split_id, s.offset) for s in
                    iter(lambda: coord.poll_split(0)[1], None)]
    assert got["port"] == got["jax"] == [("range[0:10]", 7), ("range[20:30]", 0),
                                         ("range[30:40]", 0)]


def aborted_freeze_job(p, tmp_path, name):
    """Two readers over 6 splits, each chained into a map; reader 1's map
    stalls on its first record.  Reader 0 cuts count-based barriers the
    stalled reader cannot ack, so assignment freezes; the sweeper aborts
    them, and only the abort's ``cancel_alignment`` lets reader 0 pull
    more splits while reader 1 is still stalled."""
    holder = {}

    class Stall(p.fn.MapFunction):
        def open(self, ctx):
            self.index = ctx.subtask_index

        def map(self, value):
            if self.index == 1 and not holder.get("released"):
                holder["released"] = True
                wait_for(lambda: holder.get("ex") is not None
                         and holder["ex"].coordinator.aborted_ids, "an abort")
                # Thawed: reader 0 pulls and finishes more splits.
                wait_for(lambda: report(holder["env"]).get("src.0.splits_completed", 0) >= 3,
                         "reader 0 to pull splits after the abort")
            return value

    env = p.Env(parallelism=1)
    env.enable_checkpointing(str(tmp_path / name), every_n_records=5)
    env.configure(checkpoint=dataclasses.replace(env.config.checkpoint, timeout_s=0.5))
    out = (env.from_source(p.src.ReplaySplitSource(list(range(60)), num_splits=6),
                           name="src", parallelism=2)
           .map(Stall(), name="stall", parallelism=2).rebalance()
           .map(lambda v: v, name="m", parallelism=1).sink_to_list())
    holder["env"] = env
    handle = env.execute_async()
    holder["ex"] = handle.executor
    handle.wait(60)
    return sorted(out), list(handle.executor.coordinator.aborted_ids)


@BOTH
def test_an_aborted_checkpoint_thaws_split_assignment(pkg, tmp_path):
    out, aborted = aborted_freeze_job(PKGS[pkg], tmp_path, pkg)
    assert out == list(range(60))
    assert aborted
