"""The port's TensorRing and the ring path of ``ModelWindowFunction``,
held to the JAX package on the CPU.

- ``_soa_layout`` gives the JAX package's offsets, and a seeded sequence
  of pushes, claims and releases that wraps the arena claims the same
  views in the port's C++ ring (built with the host compiler here), its
  Python ring, and the JAX package's Python ring (exact).
- A C++ ring that fails to build raises; nothing falls back.
- The ring path gives the list path's outputs bit for bit and in order,
  at one and three transfer lanes, with padding and wraparound
  copy-outs; the Inception cell fires through the ring by default.
- A checkpoint taken with ring tokens buffered holds records, not
  tokens, and a restore from it gives the uninterrupted job's outputs.
- A wedged fetch thread leaves the arena alive until it ends.
"""

import sys
import time

import numpy as np
import pytest

from flink_tensorflow_tpu_torch import RestartStrategy, StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.checkpoint.store import latest_checkpoint_id, read_checkpoint
from flink_tensorflow_tpu_torch.core import functions as fn
from flink_tensorflow_tpu_torch.functions import runner as runner_mod
from flink_tensorflow_tpu_torch.functions.model_function import ModelWindowFunction
from flink_tensorflow_tpu_torch.models import inception_cell, lenet_cell
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.native.ring import TensorRing, _soa_layout
from flink_tensorflow_tpu_torch.ops import _build
from flink_tensorflow_tpu_torch.tensors.batching import BucketPolicy
from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, spec
from flink_tensorflow_tpu_torch.tensors.value import TensorValue

from flink_tensorflow_tpu.native.ring import TensorRing as JaxTensorRing
from flink_tensorflow_tpu.native.ring import _soa_layout as jax_soa_layout
from flink_tensorflow_tpu.tensors.schema import RecordSchema as JaxRecordSchema
from flink_tensorflow_tpu.tensors.schema import TensorSpec as JaxTensorSpec

CPU = lambda task, index: "cpu"  # noqa: E731

SCHEMAS = {
    "static": {"a": ((3, 5), np.float32), "b": ((), np.int32), "c": ((7,), np.uint8)},
    "image": {"image": ((9, 9, 3), np.uint8)},
    "dynamic": {"tokens": ((None,), np.int32), "w": ((2, None), np.float32)},
}


def schemas(name):
    fields = SCHEMAS[name]
    return (RecordSchema({n: spec(s, d) for n, (s, d) in fields.items()}),
            JaxRecordSchema({n: JaxTensorSpec(s, np.dtype(d)) for n, (s, d) in fields.items()}))


def record(name, rng, k):
    """A record of the schema; every other one holds numpy scalars and
    Fortran-ordered arrays, which the C++ ring's one-call push does not
    take (the field-by-field push does)."""
    out = {}
    for n, (shape, dtype) in SCHEMAS[name].items():
        shape = tuple(int(rng.randint(1, 6)) if d is None else d for d in shape)
        a = (rng.randint(0, 255, shape) if np.dtype(dtype).kind in "iu"
             else rng.standard_normal(shape)).astype(dtype)
        out[n] = np.asarray(a) if k % 2 else (np.asfortranarray(a) if a.ndim > 1 else a[()])
    return out


@pytest.mark.parametrize("name", sorted(SCHEMAS))
@pytest.mark.parametrize("capacity", [8, 100])
def test_soa_layout_equals_the_jax_package(name, capacity):
    port, ref = schemas(name)
    assert _soa_layout(port, 16, capacity) == jax_soa_layout(ref, 16, capacity)


@pytest.mark.parametrize("native", [True, False], ids=["cpp", "python"])
@pytest.mark.parametrize("name", ["static", "dynamic"])
def test_claimed_views_equal_the_jax_ring_through_wraps(native, name):
    port, ref = schemas(name)
    ring = TensorRing(port, 12, length_bucket=8, native=native)
    jax_ring = JaxTensorRing(ref, 12, length_bucket=8, native=False)
    assert ring.is_native == native and ring.capacity == jax_ring.capacity == 16
    assert ring.arena.numel() == len(jax_ring._ring.arena_view())
    rng = np.random.RandomState(0)
    pushed = claimed = 0
    for _ in range(400):
        op = rng.randint(3)
        if op == 0:
            rec = record(name, rng, pushed)
            ok = ring.try_push(rec)
            assert ok == jax_ring.try_push(rec)
            pushed += ok
        elif op == 1:
            m = int(rng.randint(1, 7))
            got, n = ring.claim_batch(m)
            want, jn = jax_ring.claim_batch(m)
            assert n == jn
            claimed += n
            for f in want:
                assert got[f].flags.c_contiguous
                np.testing.assert_array_equal(got[f], want[f])
        else:
            c = min(ring._claim_ahead, int(rng.randint(0, 5)))
            ring.release(c)
            jax_ring.release(c)
        assert ring.poppable() == jax_ring.poppable()
    assert pushed > 2 * ring.capacity and claimed > 2 * ring.capacity  # wrapped
    ring.close()
    assert ring.closed and ring.arena is None


def test_the_copier_writes_claimed_slots_and_lets_go_of_copied_records():
    port, _ = schemas("image")
    ring = TensorRing(port, 8)
    rng = np.random.RandomState(4)
    recs = [{"image": rng.randint(0, 255, (9, 9, 3)).astype(np.uint8)} for _ in range(8)]
    for r in recs[:5]:
        assert ring.try_push(r)
    views, n = ring.claim_batch(5, wait=False)
    assert n == 5 and ring.claimed == 5
    ring.wait_copied(ring.claimed)
    np.testing.assert_array_equal(views["image"], np.stack([r["image"] for r in recs[:5]]))
    for r in recs[5:]:
        assert ring.try_push(r)
    assert not ring.try_push(recs[0])            # full: 8 slots, none released
    ring.wait_copied(8)
    ring.release(5)
    # The ring holds a record's arrays only until they are copied.
    assert ring.try_push(recs[0]) and len(ring._sources) <= 1
    ring.close()
    assert ring.closed


def test_a_dynamic_field_past_its_bucket_is_refused_before_a_slot_is_taken():
    port, _ = schemas("dynamic")
    ring = TensorRing(port, 4, length_bucket=4)
    with pytest.raises(ValueError, match="length_bucket"):
        ring.try_push({"tokens": np.zeros(5, np.int32), "w": np.zeros((2, 1), np.float32)})
    assert ring.poppable() == 0


def test_a_failed_native_build_raises(tmp_path, monkeypatch):
    port, _ = schemas("image")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", "false")   # a compiler that always fails
    _build.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="build failed for spsc_ring.cpp"):
            TensorRing(port, 8)
        monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
        with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
            TensorRing(port, 8)
        # The Python ring is there only when asked for.
        assert not TensorRing(port, 8, native=False).is_native
    finally:
        _build.load_library.cache_clear()


# -- the ring path of ModelWindowFunction -----------------------------------

@pytest.fixture(scope="module")
def lenet():
    _, model, _, records = lenet_cell.lenet_cell(0, records=43)
    return model, records


def run(model, records, window, **kw):
    env = StreamExecutionEnvironment(parallelism=1)
    env.set_device_provider(CPU)
    kw.setdefault("policy", BucketPolicy(fixed_batch=4))
    out = (env.from_collection(records).count_window(window, timeout_s=5.0)
           .apply(ModelWindowFunction(model, outputs=("label", "logits"), **kw), name="m")
           .sink_to_list())
    result = env.execute(timeout=120)
    return out, result.metrics


def same(a, b):
    return ([r.meta["id"] for r in a] == [r.meta["id"] for r in b]
            and all(np.array_equal(x["logits"], y["logits"]) and x["label"] == y["label"]
                    for x, y in zip(a, b)))


@pytest.mark.parametrize("lanes", [1, 3])
def test_ring_on_and_off_give_the_same_outputs_in_order(lenet, lanes):
    model, records = lenet
    off, m_off = run(model, records, 4, use_ring=False, transfer_lanes=lanes)
    on, m_on = run(model, records, 4, transfer_lanes=lanes)
    assert [r.meta["id"] for r in off] == list(range(len(records)))
    assert same(on, off)
    # 11 windows: 10 of 4 and the last 3 padded by the last record.
    assert m_on["m.0.ring_batches"] == m_on["m.0.batches"] == 11
    assert m_on["m.0.padded_records"] == 1
    assert "m.0.ring_batches" not in m_off
    assert m_on["m.0.h2d_bytes"] == m_off["m.0.h2d_bytes"] == 11 * 4 * 784 * 4


def test_lanes_one_and_three_agree(lenet):
    model, records = lenet
    one, _ = run(model, records, 4, transfer_lanes=1)
    three, _ = run(model, records, 4, transfer_lanes=3, pipeline_depth=5)
    assert same(one, three)


def test_a_small_ring_under_many_lanes_keeps_every_output(lenet):
    """Twelve lanes (more than the cores here) against a ring of two
    batches, with a short switch interval: ingestion waits on the oldest
    batch at almost every record, and a slot reused under a batch still
    being copied would change its outputs."""
    model, records = lenet
    records = (records * 5)[:200]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        on, m = run(model, records, 4, transfer_lanes=12, ring_capacity=8)
    finally:
        sys.setswitchinterval(interval)
    off, _ = run(model, records, 4, use_ring=False)
    assert same(on, off) and m["m.0.ring_batches"] == 50


def test_wraparound_copies_out_and_keeps_the_outputs(lenet):
    model, records = lenet
    off, _ = run(model, records, 3, policy=BucketPolicy(fixed_batch=3), use_ring=False)
    on, m = run(model, records, 3, policy=BucketPolicy(fixed_batch=3), ring_capacity=8)
    assert same(on, off)
    assert m["m.0.ring_copy_outs"] >= 3
    assert m["m.0.ring_batches"] == 15


def test_use_ring_needs_a_static_schema_and_a_capacity(lenet):
    model, _ = lenet
    ctx = type("Ctx", (), {"device": "cpu", "metrics": None})()
    f = ModelWindowFunction(model, use_ring=True)
    with pytest.raises(ValueError, match="ring_capacity"):
        f.open(ctx)
    f.close()
    f = ModelWindowFunction(model, ring_capacity=8)
    f.open(ctx)
    try:
        assert f._ring is not None and f._ring.capacity == 8
    finally:
        f.close()
    _, bilstm, _ = __import__("flink_tensorflow_tpu_torch.models.bilstm_cell",
                              fromlist=["x"]).bilstm_cell(0, records=2)
    f = ModelWindowFunction(bilstm, use_ring=True, policy=BucketPolicy(fixed_batch=2))
    with pytest.raises(ValueError, match="static"):
        f.open(ctx)
    f.close()


def test_the_inception_cell_fires_through_the_ring_by_default():
    mdef = get_model_def("inception_v3", num_classes=4, image_size=75, uint8_input=True)
    model = mdef.to_model(mdef.init_params(0))
    pixels = np.random.RandomState(0).randint(0, 256, (12, 75, 75, 3), dtype=np.uint8)
    records = [TensorValue({"image": pixels[i]}, {"id": i}) for i in range(12)]
    run_on = inception_cell.run_cell_job(model, records, device_provider=CPU, batch=4, lanes=2)
    run_off = inception_cell.run_cell_job(model, records, device_provider=CPU, batch=4, lanes=2,
                                          use_ring=False)
    assert run_on.metrics["inception.0.ring_batches"] == 3
    assert "inception.0.ring_batches" not in run_off.metrics
    assert [r.meta["id"] for r in run_on.results] == list(range(12))
    for a, b in zip(run_on.results, run_off.results):
        assert a["label"] == b["label"] and a["score"] == b["score"]


class _CrashOnce(fn.MapFunction):
    """Raises once, at the ``at``-th record of the first attempt."""

    crashed = False

    def __init__(self, at):
        self.at = at
        self.seen = 0

    def map(self, value):
        self.seen += 1
        if self.seen == self.at and not _CrashOnce.crashed:
            _CrashOnce.crashed = True
            raise RuntimeError("crash")
        return value


def test_a_checkpoint_with_ring_tokens_buffered_restores_to_the_same_output(lenet, tmp_path):
    model, records = lenet
    want, _ = run(model, records, 4)
    _CrashOnce.crashed = False
    env = StreamExecutionEnvironment(parallelism=1)
    env.set_device_provider(CPU)
    # Barriers after every 5th record: a window of 4 then holds 1-3 tokens.
    env.enable_checkpointing(str(tmp_path), every_n_records=5)
    out = (env.from_collection(records).map(_CrashOnce(18))
           .count_window(4, timeout_s=5.0)
           .apply(ModelWindowFunction(model, outputs=("label", "logits")), name="m")
           .sink_to_list())
    result = env.execute(timeout=120, restart_strategy=RestartStrategy(max_restarts=1))
    assert result.restarts == 1 and _CrashOnce.crashed
    by_id = {}
    for r in out:
        prev = by_id.setdefault(r.meta["id"], r)
        assert np.array_equal(prev["logits"], r["logits"])   # replays agree
    assert sorted(by_id) == list(range(len(records)))
    for w in want:
        assert np.array_equal(by_id[w.meta["id"]]["logits"], w["logits"])
    # Every checkpoint holds the open window's records, never a token.
    buffered = 0
    for cid in range(1, latest_checkpoint_id(str(tmp_path)) + 1):
        _, snaps = read_checkpoint(str(tmp_path), cid)
        for payload in snaps["m"][0]["operator"]["buffers"].values():
            assert all(isinstance(e, TensorValue) for e in payload[1])
            buffered += len(payload[1])
    assert buffered > 0


def test_a_wedged_fetch_leaves_the_arena_alive(lenet, monkeypatch):
    model, records = lenet
    monkeypatch.setattr(runner_mod, "CLOSE_DRAIN_S", 0.3)
    monkeypatch.setattr(runner_mod, "FETCH_JOIN_S", 0.3)
    f = ModelWindowFunction(model, policy=BucketPolicy(fixed_batch=4))
    f.open(type("Ctx", (), {"device": "cpu", "metrics": None})())
    runner, ring = f.runner, f._ring
    gate = __import__("threading").Event()
    process = runner._process_item

    def wedged(item):
        gate.wait()          # the fetch blocks, as on a hung device
        return process(item)

    monkeypatch.setattr(runner, "_process_item", wedged)
    out = fn.Collector(lambda *a: None)
    tokens = [f.ingest_element(r, out) for r in records[:4]]
    f.process_window(None, None, tokens, out)
    t0 = time.monotonic()
    f.close()
    assert time.monotonic() - t0 < 5.0
    assert runner.wedged_fetcher is not None and runner.wedged_fetcher.is_alive()
    assert not ring.closed and ring.arena is not None      # the batch may still read it
    gate.set()
    deadline = time.monotonic() + 10.0
    while not ring.closed and time.monotonic() < deadline:
        time.sleep(0.01)
    assert ring.closed and ring.arena is None               # freed once the thread ended
