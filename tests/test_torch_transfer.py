"""Batch assembly and the host <-> device transfer of the port.

CPU cases hold ``tensors/batching.py:assemble`` to the JAX package's on
the same records (exact: pure numpy) and check the transfer's plain
path.  The ``cuda`` cases exercise what only the card has: pinned
staging slots reused under in-flight copies, the side-stream H2D with
its event, the per-batch D2H event, and the whole Quick-start job on the
GPU against direct calls of the same module.  This file imports neither
jax nor flax at the top, so its card cases run where they are absent.
"""

import copy

import numpy as np
import pytest
import torch

from flink_tensorflow_tpu_torch.core.environment import StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.functions.model_function import ModelWindowFunction
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.tensors.batching import (
    BucketLadder,
    BucketPolicy,
    assemble,
    length_key,
)
from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, spec
from flink_tensorflow_tpu_torch.tensors.transfer import DeviceTransfer
from flink_tensorflow_tpu_torch.tensors.value import TensorValue

SCHEMA = RecordSchema({"image": spec((3, 4, 2), np.uint8), "tokens": spec((None,), np.int32)})


def records(n, seed=0):
    rng = np.random.RandomState(seed)
    return [TensorValue({"image": rng.randint(0, 256, (3, 4, 2)).astype(np.uint8),
                         "tokens": rng.randint(1, 9, (int(rng.randint(1, 7)),)).astype(np.int32)},
                        {"id": i}) for i in range(n)]


def needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.parametrize("policy", [BucketPolicy(), BucketPolicy(fixed_batch=8),
                                    BucketPolicy(batch=BucketLadder([2, 6]),
                                                 lengths=BucketLadder([4, 8]))],
                         ids=["pow2", "fixed8", "ladders"])
def test_assemble_matches_jax(policy):
    pytest.importorskip("flax")
    from flink_tensorflow_tpu.tensors import batching as jb
    from flink_tensorflow_tpu.tensors.schema import RecordSchema as JaxSchema
    from flink_tensorflow_tpu.tensors.schema import spec as jax_spec
    from flink_tensorflow_tpu.tensors.value import TensorValue as JaxValue

    recs = records(5)
    jrecs = [JaxValue(dict(r.fields), r.meta) for r in recs]
    jschema = JaxSchema({"image": jax_spec((3, 4, 2), np.uint8),
                         "tokens": jax_spec((None,), np.int32)})
    jpolicy = jb.BucketPolicy(batch=jb.BucketLadder(policy.batch.sizes),
                              lengths=jb.BucketLadder(policy.lengths.sizes),
                              fixed_batch=policy.fixed_batch)
    want = jb.assemble(jrecs, jschema, jpolicy)
    got = assemble(recs, SCHEMA, policy)
    assert set(got.arrays) == set(want.arrays)
    for name in want.arrays:
        np.testing.assert_array_equal(got.arrays[name], want.arrays[name])
        assert got.arrays[name].dtype == want.arrays[name].dtype
    np.testing.assert_array_equal(got.valid, want.valid)
    np.testing.assert_array_equal(got.lengths["tokens"], want.lengths["tokens"])
    assert got.metas == want.metas


def test_assemble_pads_by_replaying_the_first_record_into_the_given_buffers():
    recs = records(3)
    made = {}

    def alloc(name, shape, dtype):
        made[name] = np.full(shape, 99, dtype)
        return made[name]

    batch = assemble(recs, SCHEMA, BucketPolicy(fixed_batch=4), alloc=alloc)
    assert all(batch.arrays[n] is made[n] for n in batch.arrays)
    # The dynamic field's lengths come from the same allocator.
    assert batch.lengths["tokens"] is made[length_key("tokens")]
    assert set(made) == {"image", "tokens", length_key("tokens")}
    np.testing.assert_array_equal(batch.arrays["image"][3], recs[0]["image"])
    assert batch.num_records == 3 and batch.padded_size == 4
    out = batch.unbatch({"y": np.arange(4)})
    assert [int(r["y"]) for r in out] == [0, 1, 2]
    assert [r.meta["id"] for r in out] == [0, 1, 2]
    with pytest.raises(ValueError, match="exceed fixed_batch"):
        assemble(records(5), SCHEMA, BucketPolicy(fixed_batch=4))


def test_cpu_transfer_shares_memory_and_fetches_read_only_arrays():
    transfer = DeviceTransfer(torch.device("cpu"))
    shipped = transfer.assemble_and_ship(records(2), SCHEMA, BucketPolicy())
    batch, dev = shipped.batch, shipped.inputs
    # The [B] int32 lengths of the dynamic field cross with the fields.
    assert shipped.h2d_bytes == sum(a.nbytes for a in batch.arrays.values()) + 2 * 4
    np.testing.assert_array_equal(shipped.lengths["tokens"].numpy(), batch.lengths["tokens"])
    assert dev["image"].data_ptr() == batch.arrays["image"].ctypes.data
    host = transfer.finish_fetch(transfer.start_fetch({"y": dev["tokens"] * 2}))
    assert not host["y"].flags.writeable
    np.testing.assert_array_equal(host["y"], batch.arrays["tokens"] * 2)


@pytest.mark.parametrize("callers_flag", [True, False])
def test_cudnn_heuristics_held_while_any_runner_is_open(callers_flag):
    """Runners on the card turn cuDNN's timed search off while open and
    give the caller's flag back when the last of them closes; a runner on
    the CPU leaves it alone."""
    from flink_tensorflow_tpu_torch.functions import runner as runner_mod

    before = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = callers_flag
    try:
        runner_mod.hold_cudnn_heuristics()
        runner_mod.hold_cudnn_heuristics()
        assert torch.backends.cudnn.benchmark is False
        runner_mod.release_cudnn_heuristics()
        assert torch.backends.cudnn.benchmark is False
        runner_mod.release_cudnn_heuristics()
        assert torch.backends.cudnn.benchmark is callers_flag

        mdef = get_model_def("inception_v3", num_classes=4, image_size=75, uint8_input=True)
        cpu = runner_mod.CompiledMethodRunner(mdef.to_model(mdef.init_params(0)), device="cpu")
        cpu.open()
        assert torch.backends.cudnn.benchmark is callers_flag
        cpu.close()
    finally:
        torch.backends.cudnn.benchmark = before


@pytest.mark.cuda
def test_staging_slots_survive_many_batches_in_flight():
    """20 batches shipped and fetched back to back through 2 staging
    slots: every slot is refilled while earlier copies and computes are
    queued, and every result must still be its own batch's."""
    needs_cuda()
    device = torch.device("cuda")
    transfer = DeviceTransfer(device, slots=2)
    stream = torch.cuda.Stream(device)
    schema = RecordSchema({"x": spec((1 << 16,), np.float32)})
    handles, wants = [], []
    with torch.cuda.stream(stream):
        for k in range(20):
            vals = [TensorValue({"x": np.full((1 << 16,), 4 * k + j, np.float32)})
                    for j in range(4)]
            dev = transfer.assemble_and_ship(vals, schema, BucketPolicy(fixed_batch=4)).inputs
            torch.cuda._sleep(200_000)                    # keep the compute stream busy
            handles.append(transfer.start_fetch({"s": dev["x"].sum(dim=1)}))
            wants.append([4 * k + j for j in range(4)])
    for handle, want in zip(handles, wants):
        got = transfer.finish_fetch(handle)["s"]
        np.testing.assert_array_equal(got, np.asarray(want, np.float32) * (1 << 16))


@pytest.mark.cuda
def test_quick_start_job_on_the_card_equals_direct_calls():
    """On the GPU (no device provider): 40 records in batches of 4 reuse
    every pinned staging slot several times; each record's label and
    score must equal a direct call of the same module on the same batch
    (cuDNN's heuristic algorithm choice is the same on every thread)."""
    needs_cuda()
    mdef = get_model_def("inception_v3", num_classes=10, image_size=75, uint8_input=True)
    model = mdef.to_model(mdef.init_params(0))
    images = np.random.RandomState(11).randint(0, 256, (40, 75, 75, 3)).astype(np.uint8)
    env = StreamExecutionEnvironment(parallelism=1)
    out = (env.from_collection([TensorValue({"image": im}, {"i": i})
                                for i, im in enumerate(images)])
           .count_window(4, timeout_s=5.0)
           .apply(ModelWindowFunction(model, policy=BucketPolicy(fixed_batch=4),
                                      warmup_batches=(4,), outputs=("label", "score"),
                                      pipeline_depth=6))
           .sink_to_list())
    env.execute(timeout=300)
    assert sorted(r.meta["i"] for r in out) == list(range(40))
    got = {r.meta["i"]: (int(r["label"]), float(r["score"])) for r in out}
    module = copy.deepcopy(model.params).to("cuda")
    serve = model.method("serve").fn
    with torch.inference_mode():
        for lo in range(0, 40, 4):
            want = serve(module, {"image": torch.from_numpy(images[lo:lo + 4]).cuda()})
            for j in range(4):
                assert got[lo + j] == (int(want["label"][j]), float(want["score"][j]))


@pytest.mark.cuda
def test_lengths_ride_the_pinned_staging_slot_without_new_allocations():
    """Batches of changing length buckets through 2 staging slots: the
    lengths reach the card with the fields, and once each slot has held
    the largest batch, smaller buckets are views of its buffers (no
    pinned allocation in the steady state)."""
    needs_cuda()
    device = torch.device("cuda")
    transfer = DeviceTransfer(device, slots=2)
    stream = torch.cuda.Stream(device)
    with torch.cuda.stream(stream):
        for _ in range(2):   # the largest batch, once per slot
            big = records(4, seed=9)
            big[0] = TensorValue({"image": big[0]["image"], "tokens": np.ones(64, np.int32)})
            transfer.assemble_and_ship(big, SCHEMA, BucketPolicy())
        warm = transfer.pinned_allocations
        for k in range(12):
            shipped = transfer.assemble_and_ship(records(1 + k % 4, seed=k), SCHEMA,
                                                 BucketPolicy())
            tokens = shipped.inputs["tokens"].cpu().numpy()
            lengths = shipped.lengths["tokens"]
            assert lengths.device.type == "cuda" and lengths.dtype == torch.int32
            np.testing.assert_array_equal(lengths.cpu().numpy(), shipped.batch.lengths["tokens"])
            for row, n in zip(tokens, shipped.batch.lengths["tokens"]):
                assert not row[n:].any()
    assert transfer.pinned_allocations == warm
    assert shipped.pinned_allocations == 0


@pytest.mark.cuda
def test_bilstm_window_job_on_the_card_equals_direct_calls():
    """Variable-length records through count_window(8) on the card: each
    record's logits equal a direct call of the same module on the same
    padded batch and lengths."""
    needs_cuda()
    mdef = get_model_def("bilstm", vocab_size=100, embed_dim=16, hidden_dim=32)
    model = mdef.to_model(mdef.init_params(0))
    rng = np.random.RandomState(5)
    recs = [TensorValue({"tokens": rng.randint(0, 100, (int(rng.randint(1, 40)),))
                         .astype(np.int32)}, {"i": i}) for i in range(16)]
    env = StreamExecutionEnvironment(parallelism=1)
    out = (env.from_collection(recs).count_window(8)
           .apply(ModelWindowFunction(model, warmup_batches=(8,), warmup_length_bucket=64))
           .sink_to_list())
    result = env.execute(timeout=300)
    assert sorted(r.meta["i"] for r in out) == list(range(16))
    assert result.metrics["window.0.pinned_allocations"] == 0
    got = {r.meta["i"]: r["logits"] for r in out}
    module = copy.deepcopy(model.params).to("cuda")
    with torch.inference_mode():
        for lo in (0, 8):
            batch = assemble(recs[lo:lo + 8], mdef.input_schema, BucketPolicy())
            want = module(torch.from_numpy(batch.arrays["tokens"]).cuda(),
                          torch.from_numpy(batch.lengths["tokens"]).cuda()).cpu().numpy()
            for j in range(8):
                np.testing.assert_array_equal(got[lo + j], want[j])


@pytest.mark.cuda
def test_bundle_loaded_by_a_map_on_the_card_equals_direct_calls(tmp_path):
    """A port bundle loaded at open() by ModelMapFunction on the card: 12
    records in micro-batches of 4 (no lull, so the batches are the
    arrival order's fours) equal direct calls of the loaded module."""
    from flink_tensorflow_tpu_torch.functions.model_function import ModelMapFunction
    from flink_tensorflow_tpu_torch.models.loaders import SavedModelLoader, save_bundle

    needs_cuda()
    mdef = get_model_def("lenet")
    path = str(tmp_path / "lenet")
    save_bundle(mdef, mdef.init_params(0), path)
    images = np.random.RandomState(2).rand(12, 28, 28, 1).astype(np.float32)
    env = StreamExecutionEnvironment(parallelism=1)
    out = (env.from_collection([TensorValue({"image": im}, {"i": i})
                                for i, im in enumerate(images)])
           .map(ModelMapFunction(path, micro_batch=4, idle_flush_s=5.0), name="map")
           .sink_to_list())
    result = env.execute(timeout=300)
    assert [r.meta["i"] for r in out] == list(range(12))
    assert result.metrics["map.0.batches"] == 3
    module = copy.deepcopy(SavedModelLoader(path).load().params).to("cuda")
    with torch.inference_mode():
        for lo in range(0, 12, 4):
            want = mdef.methods["serve"].fn(module, {"image": torch.from_numpy(
                images[lo:lo + 4]).cuda()})
            for j in range(4):
                np.testing.assert_array_equal(out[lo + j]["logits"],
                                              want["logits"][j].cpu().numpy())
