"""Device-resident dataflow in the port, on the CPU, held to the JAX package.

Twins of ``tests/test_device_resident.py``: a ``DeviceBatch`` materializes
once and refuses pickling; ``dispatch_device`` feeds upstream tensors to
the method with no H2D, and a batch that does not fit the schema takes
the counted host path; a chained ``model => model`` job gives the same
records with residency on and off; user code, keyed edges and sinks see
host records only; a ``DeviceMapFunction`` link stays on the device;
a ``model => DeviceMapFunction => model`` chain pays one H2D and one D2H
per micro-batch (the runners' and the map's counters); a checkpoint in
the middle of a device segment restores exactly once.  The same chain
through the JAX package, on the same numpy inputs and weights, agrees
within f32 rounding: both run ``tanh(x @ w) + x`` twice in f32 with the
products summed in another order (rtol 1e-5, atol 1e-6 on values of
order 1; the runs read about 1e-7).

Card cases (``cuda``) run the chain on the GPU, where the consumer waits
on the producer's event on its own stream: both arms equal bit for bit.
"""

import pickle
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import flink_tensorflow_tpu as jax_pkg
from flink_tensorflow_tpu.functions import DeviceMapFunction as JaxDeviceMap
from flink_tensorflow_tpu.functions import ModelMapFunction as JaxModelMap
from flink_tensorflow_tpu.models.base import Model as JaxModel
from flink_tensorflow_tpu.models.base import ModelMethod as JaxMethod
from flink_tensorflow_tpu.tensors import RecordSchema as JaxSchema
from flink_tensorflow_tpu.tensors import TensorValue as JaxValue
from flink_tensorflow_tpu.tensors import spec as jax_spec
from flink_tensorflow_tpu_torch import StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.core import functions as fn
from flink_tensorflow_tpu_torch.functions.model_function import (
    DeviceMapFunction,
    ModelMapFunction,
)
from flink_tensorflow_tpu_torch.functions.runner import CompiledMethodRunner
from flink_tensorflow_tpu_torch.models.base import Model, ModelMethod
from flink_tensorflow_tpu_torch.tensors.batching import BucketLadder, BucketPolicy
from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, spec
from flink_tensorflow_tpu_torch.tensors.transfer import DeviceBatch
from flink_tensorflow_tpu_torch.tensors.value import TensorValue

DIM = 8
RTOL, ATOL = 1e-5, 1e-6


def _weights(dim=DIM, seed=0):
    return (np.random.RandomState(seed).randn(dim, dim) * 0.1).astype(np.float32)


class _Res(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.register_buffer("w", torch.from_numpy(w))


def _res_model(dim=DIM, name="resmlp", w=None):
    """``tanh(x @ w) + x`` on a ``[dim]`` f32 field, the reference's model."""
    schema = RecordSchema({"x": spec((dim,), np.float32)})

    def serve(module, inputs):
        return {"x": torch.tanh(inputs["x"] @ module.w) + inputs["x"]}

    return Model(name, _Res(_weights(dim) if w is None else w),
                 {"serve": ModelMethod("serve", schema, ("x",), serve)})


def _jax_res_model(w):
    schema = JaxSchema({"x": jax_spec((w.shape[0],))})

    def serve(params, inputs):
        return {"x": jnp.tanh(inputs["x"] @ params["w"]) + inputs["x"]}

    return JaxModel("resmlp", {"w": jnp.asarray(w)},
                    {"serve": JaxMethod("serve", schema, ("x",), serve)})


def _records(n, dim=DIM, cls=TensorValue):
    return [cls({"x": np.full(dim, i, np.float32) / n}, {"id": i}) for i in range(n)]


class _Ctx:
    device = "cpu"

    def __init__(self):
        from flink_tensorflow_tpu_torch.metrics.registry import MetricGroup

        self.metrics = MetricGroup("test")


def _runner(model, emit_device=False, device="cpu"):
    r = CompiledMethodRunner(model, policy=BucketPolicy(batch=BucketLadder.up_to(4)),
                             device=device)
    r.open(_Ctx())
    r.emit_device_batches = emit_device
    return r


def _run_batch(runner, records):
    runner.dispatch(records)
    return runner.flush()


def test_materialize_once_and_iteration():
    r = _runner(_res_model(), emit_device=True)
    try:
        out = _run_batch(r, _records(3))
        assert len(out) == 1 and isinstance(out[0], DeviceBatch)
        db = out[0]
        assert db.num_records == 3 and db.padded_size == 4 and not db.materialized
        first = db.materialize()
        assert db.materialized and db.materialize() is first   # fetched once
        assert [tv.meta["id"] for tv in first] == [0, 1, 2]
        assert r._metrics.counter("d2h_batches").count == 1
        assert r._metrics.counter("fetch_elided_batches").count == 1
    finally:
        r.close()


def test_results_match_host_path():
    model = _res_model()
    host, dev = _runner(model), _runner(model, emit_device=True)
    try:
        recs = _records(4)
        want = _run_batch(host, recs)
        got = _run_batch(dev, recs)[0].materialize()
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a["x"], b["x"])
    finally:
        host.close()
        dev.close()


def test_pickle_is_refused():
    r = _runner(_res_model(), emit_device=True)
    try:
        db = _run_batch(r, _records(2))[0]
        with pytest.raises(TypeError, match="device-resident"):
            pickle.dumps(db)
    finally:
        r.close()


def test_dispatch_device_consumes_upstream_tensors():
    model = _res_model()
    up, down, mid = _runner(model, emit_device=True), _runner(model), _runner(model)
    try:
        db = _run_batch(up, _records(4))[0]
        assert down.dispatch_device(db) is True
        out = down.flush()
        assert [tv.meta["id"] for tv in out] == [0, 1, 2, 3]
        assert not db.materialized
        assert down._metrics.counter("h2d_elided_batches").count == 1
        assert down._metrics.counter("h2d_bytes").count == 0
        ref = _run_batch(down, _run_batch(mid, _records(4)))   # two host hops
        for a, b in zip(ref, out):
            np.testing.assert_array_equal(a["x"], b["x"])
    finally:
        for r in (up, down, mid):
            r.close()


def test_dispatch_device_schema_mismatch_takes_the_counted_host_path():
    up = _runner(_res_model(), emit_device=True)
    down = _runner(_res_model(dim=DIM * 2))
    try:
        db = _run_batch(up, _records(2))[0]
        assert down.dispatch_device(db) is False          # shape mismatch
        assert down._metrics.counter("device_batch_host_fallbacks").count == 1
    finally:
        up.close()
        down.close()

    # In a job: m1 => m2 fused, but m2's method takes per-record lengths,
    # which a device batch does not carry: each batch materializes (m1's
    # D2H) and takes m2's host path, counted, with the off arm's answer.
    def serve(module, inputs, lengths):
        return {"x": inputs["x"] * 3.0, "n": lengths["x"]}

    ragged = Model("ragged", torch.nn.Identity(), {"serve": ModelMethod(
        "serve", RecordSchema({"x": spec((None,), np.float32)}), ("x", "n"), serve,
        needs_lengths=True)})
    runs = {}
    for on in (True, False):
        env = StreamExecutionEnvironment(parallelism=1)
        env.configure(device_resident=on)
        env.set_device_provider(lambda task, index: "cpu")
        out = (env.from_collection(_records(8))
               .map(ModelMapFunction(_res_model(), micro_batch=4, idle_flush_s=5.0), name="m1")
               .map(ModelMapFunction(ragged, micro_batch=4, idle_flush_s=5.0), name="m2")
               .sink_to_list())
        runs[on] = (out, env.execute(timeout=60).metrics)
    (on, rep), (off, _) = runs[True], runs[False]
    assert rep["m2.0.device_batch_host_fallbacks"] == 2
    assert rep["m1.0.fetch_elided_batches"] == rep["m1.0.d2h_batches"] == 2
    assert rep["m2.0.h2d_batches"] == 2
    assert [r.meta["id"] for r in on] == list(range(8))
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a["x"], b["x"])
        assert int(a["n"]) == DIM


def _chain_env(device_resident, records, micro=4, ckpt=None, throttle=0.0, devmap=False):
    model = _res_model()
    env = StreamExecutionEnvironment(parallelism=1)
    env.configure(device_resident=device_resident)
    env.set_device_provider(lambda task, index: "cpu")
    if ckpt is not None:
        env.enable_checkpointing(ckpt)
    env.source_throttle_s = throttle
    s = env.from_collection(records).map(
        ModelMapFunction(model, micro_batch=micro, idle_flush_s=5.0), name="m1")
    if devmap:
        s = s.map(DeviceMapFunction(lambda t: {"x": t["x"] * 2.0}), name="scale")
    out = s.map(ModelMapFunction(model, micro_batch=micro, idle_flush_s=5.0),
                name="m2").sink_to_list()
    return env, out


def _counts(rep, what):
    return sum(v for k, v in rep.items() if k.endswith("." + what))


def test_on_off_equivalence():
    recs = _records(12)
    env_off, off = _chain_env(False, recs)
    env_off.execute(timeout=120)
    env_on, on = _chain_env(True, recs)
    assert "m1 => m2 -> collect" in env_on.describe()
    env_on.execute(timeout=120)
    assert [r.meta["id"] for r in on] == [r.meta["id"] for r in off] == list(range(12))
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a["x"], b["x"])
    rep_on, rep_off = env_on.metric_registry.report(), env_off.metric_registry.report()
    assert rep_on["m1.0.fetch_elided_batches"] == 3
    assert "m1.0.fetch_elided_batches" not in rep_off


def test_host_boundary_user_code_never_sees_device_batch():
    seen = []
    env = StreamExecutionEnvironment(parallelism=1)
    env.configure(device_resident=True)
    env.set_device_provider(lambda task, index: "cpu")
    out = (env.from_collection(_records(8))
           .map(ModelMapFunction(_res_model(), micro_batch=4, idle_flush_s=5.0,
                                 device_resident=True), name="m1")
           .map(lambda r: (seen.append(type(r).__name__), r)[1], name="host")
           .sink_to_list())
    rep = env.execute(timeout=120).metrics
    assert len(out) == 8 and set(seen) == {"TensorValue"}
    # Forced emission into a host consumer: the D2H lands at the boundary.
    assert rep["m1.0.fetch_elided_batches"] == rep["m1.0.d2h_batches"] == 2


def test_keyed_edge_materializes():
    class Tag(fn.ProcessFunction):
        def process_element(self, value, ctx, out):
            out.collect((ctx.current_key, value.meta["id"]))

    env = StreamExecutionEnvironment(parallelism=1)
    env.configure(device_resident=True)
    env.set_device_provider(lambda task, index: "cpu")
    out = (env.from_collection(_records(8))
           .map(ModelMapFunction(_res_model(), micro_batch=4, idle_flush_s=5.0,
                                 device_resident=True), name="m1")
           .key_by(lambda r: r.meta["id"] % 2).process(Tag(), parallelism=2)
           .sink_to_list(parallelism=2))
    rep = env.execute(timeout=120).metrics
    assert sorted(out) == sorted((i % 2, i) for i in range(8))
    assert rep["m1.0.d2h_batches"] == 2


def test_device_map_link_stays_resident():
    env, out = _chain_env(True, _records(8), devmap=True)
    assert "m1 => scale => m2 -> collect" in env.describe()
    rep = env.execute(timeout=120).metrics
    ref_env, ref = _chain_env(False, _records(8), devmap=True)
    rep_off = ref_env.execute(timeout=120).metrics
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(a["x"], b["x"])
    assert rep["m1.0.fetch_elided_batches"] == 2
    assert rep["m2.0.h2d_elided_batches"] == 2
    assert "scale.0.h2d_batches" not in rep
    # Off: the map lifts each host record to a batch of one.
    assert rep_off["scale.0.h2d_batches"] == rep_off["scale.0.d2h_batches"] == 8


def test_exactly_one_h2d_and_one_d2h_per_batch():
    """model => DeviceMapFunction => model -> sink, 12 records in
    micro-batches of 4: 3 H2Ds (the first model's) and 3 D2Hs (the last
    model's) in the whole job on, twice as many plus the map's per-record
    lifts off."""
    env, out = _chain_env(True, _records(12), devmap=True)
    rep = env.execute(timeout=120).metrics
    assert len(out) == 12
    assert _counts(rep, "h2d_batches") == 3 and rep["m1.0.h2d_batches"] == 3
    assert _counts(rep, "d2h_batches") == 3 and rep["m2.0.d2h_batches"] == 3
    assert _counts(rep, "h2d_bytes") == 3 * 4 * DIM * 4
    env_off, _ = _chain_env(False, _records(12), devmap=True)
    rep_off = env_off.execute(timeout=120).metrics
    assert _counts(rep_off, "h2d_batches") == _counts(rep_off, "d2h_batches") == 3 + 12 + 3


def test_checkpoint_mid_device_segment_is_exactly_once(tmp_path):
    """A barrier while batches ride the device segment: both models flush
    before their snapshots, and the restored run emits exactly the records
    after the barrier, with the uninterrupted run's values."""
    n = 120
    recs = _records(n)
    ckpt = str(tmp_path / "ckpts")
    env_ref, ref = _chain_env(False, recs, devmap=True)
    env_ref.execute(timeout=120)
    by_id = {r.meta["id"]: r for r in ref}

    env1, _ = _chain_env(True, recs, ckpt=ckpt, throttle=0.002, devmap=True)
    handle = env1.execute_async()
    time.sleep(0.25)
    snaps = handle.trigger_checkpoint(timeout=30)
    offset = snaps["collection"][0]["operator"]["offset"]
    assert 0 < offset < n, f"want a mid-stream barrier, offset {offset}"
    assert all(snaps[t][0]["function"] is None for t in ("m1", "m2"))
    handle.cancel()
    handle.wait(timeout=30)

    env2, out2 = _chain_env(True, recs, ckpt=ckpt, devmap=True)
    env2.execute(restore_from=ckpt, timeout=120)
    assert [r.meta["id"] for r in out2] == list(range(offset, n))
    for r in out2:
        np.testing.assert_array_equal(r["x"], by_id[r.meta["id"]]["x"])


def test_chain_equals_jax_chain():
    """model => DeviceMapFunction => model -> sink, residency on in both
    packages, the same numpy inputs and weights."""
    w = _weights(DIM, seed=3)
    n = 12

    env = StreamExecutionEnvironment(parallelism=1)
    env.configure(device_resident=True)
    env.set_device_provider(lambda task, index: "cpu")
    out = (env.from_collection(_records(n))
           .map(ModelMapFunction(_res_model(w=w), micro_batch=4, idle_flush_s=5.0), name="m1")
           .map(DeviceMapFunction(lambda t: {"x": t["x"] * 0.5 + 1.0}), name="affine")
           .map(ModelMapFunction(_res_model(w=w), micro_batch=4, idle_flush_s=5.0), name="m2")
           .sink_to_list())
    rep = env.execute(timeout=120).metrics
    assert rep["m1.0.fetch_elided_batches"] == rep["m2.0.h2d_elided_batches"] == 3

    jenv = jax_pkg.StreamExecutionEnvironment(parallelism=1)
    jenv.configure(device_resident=True)
    jout = (jenv.from_collection(_records(n, cls=JaxValue))
            .map(JaxModelMap(_jax_res_model(w), micro_batch=4, idle_flush_s=5.0), name="m1")
            .map(JaxDeviceMap(lambda a: {"x": a["x"] * 0.5 + 1.0}), name="affine")
            .map(JaxModelMap(_jax_res_model(w), micro_batch=4, idle_flush_s=5.0), name="m2")
            .sink_to_list())
    jrep = jenv.execute(timeout=120).metrics
    assert jrep["m1.0.fetch_elided_batches"] == 3
    assert [r.meta["id"] for r in out] == [r.meta["id"] for r in jout] == list(range(n))
    got = np.stack([r["x"] for r in out])
    want = np.stack([np.asarray(r["x"]) for r in jout])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


cuda = pytest.mark.cuda


@cuda
def test_card_chain_on_off_bit_equal_and_counted():
    """On the card: the consumer runs on its own stream after the
    producer's event.  Both arms equal bit for bit, one H2D and one D2H
    per micro-batch on the on arm."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    n, dim = 256, 512

    def run(on):
        model = _res_model(dim=dim, w=(_weights(dim) / np.sqrt(dim) * 10).astype(np.float32))
        env = StreamExecutionEnvironment(parallelism=1)
        env.configure(device_resident=on)
        out = (env.from_collection(_records(n, dim=dim))
               .map(ModelMapFunction(model, micro_batch=8, idle_flush_s=5.0), name="m1")
               .map(DeviceMapFunction(lambda t: {"x": torch.softmax(t["x"], -1)}), name="sm")
               .map(ModelMapFunction(model, micro_batch=8, idle_flush_s=5.0), name="m2")
               .sink_to_list())
        return out, env.execute(timeout=300).metrics

    (on, rep_on), (off, rep_off) = run(True), run(False)
    assert [r.meta["id"] for r in on] == [r.meta["id"] for r in off] == list(range(n))
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a["x"], b["x"])
    batches = n // 8
    assert rep_on["m1.0.fetch_elided_batches"] == batches
    assert _counts(rep_on, "h2d_batches") == _counts(rep_on, "d2h_batches") == batches
