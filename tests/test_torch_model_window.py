"""The Quick-start job through the port on the CPU, held to the JAX job.

Twin of ``tests/test_model_functions.py::TestModelWindowFunction``: uint8
images through ``from_collection -> count_window -> ModelWindowFunction
-> sink_to_list``, with a device provider that returns ``cpu``.  The
model is Inception-v3 at 75 px and 10 classes in bf16, with the same
flax weights in both packages (``test_torch_inception.flax_variables``).
Every record id must come back exactly once with the JAX job's label.
The labels are compared under ``test_torch_inception``'s bf16
tolerance: each of these records has a top-1/top-2 logit gap of more
than twice that tolerance in the JAX job, which the test asserts too.
"""

import numpy as np
import pytest
import torch

# The reference models are flax modules; where flax is absent (a GPU machine
# without it) the module skips instead of failing to collect.
pytest.importorskip("flax")

from flink_tensorflow_tpu import StreamExecutionEnvironment as JaxEnv
from flink_tensorflow_tpu.functions import ModelWindowFunction as JaxModelWindowFunction
from flink_tensorflow_tpu.models import get_model_def as jax_model_def
from flink_tensorflow_tpu.tensors import TensorValue as JaxTensorValue
from flink_tensorflow_tpu_torch.core.environment import StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.core.runtime import JobFailure
from flink_tensorflow_tpu_torch.functions.model_function import ModelWindowFunction
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.tensors.batching import BucketPolicy
from flink_tensorflow_tpu_torch.tensors.value import TensorValue
from test_torch_inception import BF16_TOL, CLASSES, SIZE, flax_variables

N = 10
CFG = dict(num_classes=CLASSES, image_size=SIZE, uint8_input=True)


@pytest.fixture(scope="module")
def variables():
    return flax_variables(jax_model_def("inception_v3", **CFG), 0)


@pytest.fixture(scope="module")
def pixels():
    return np.random.RandomState(7).randint(0, 256, (N, SIZE, SIZE, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def model(variables):
    return get_model_def("inception_v3", **CFG).to_model(variables)


@pytest.fixture(scope="module")
def jax_labels(variables, pixels):
    """The JAX Quick-start job's label per record id (and its logits)."""
    jmodel = jax_model_def("inception_v3", **CFG).to_model(variables)
    env = JaxEnv(parallelism=1)
    results = (env.from_collection([JaxTensorValue({"image": p}, {"i": i})
                                    for i, p in enumerate(pixels)])
               .count_window(4).apply(JaxModelWindowFunction(jmodel)).sink_to_list())
    env.execute(timeout=120)
    assert sorted(r.meta["i"] for r in results) == list(range(N))
    logits = {r.meta["i"]: np.asarray(r["logits"], np.float32) for r in results}
    top2 = np.sort(np.stack([logits[i] for i in range(N)]), -1)[:, -2:]
    scale = max(np.abs(v).max() for v in logits.values())
    assert ((top2[:, 1] - top2[:, 0]) > 2 * BF16_TOL * scale).all()
    return {r.meta["i"]: int(r["label"]) for r in results}


def run_job(model, pixels, window, fn, *, timeout_s=None):
    env = StreamExecutionEnvironment(parallelism=1)
    env.set_device_provider(lambda task, index: "cpu")
    records = [TensorValue({"image": p}, {"i": i}) for i, p in enumerate(pixels)]
    out = (env.from_collection(records).count_window(window, timeout_s=timeout_s)
           .apply(fn, name="infer").sink_to_list())
    result = env.execute(timeout=120)
    ids = [r.meta["i"] for r in out]
    assert sorted(ids) == list(range(len(pixels))), ids  # every id exactly once
    return {r.meta["i"]: int(r["label"]) for r in out}, result, out


def test_windowed_microbatch_inference(model, pixels, jax_labels):
    got, result, _ = run_job(model, pixels, 4, ModelWindowFunction(model))
    assert got == jax_labels
    assert result.metrics["infer.0.records"]["count"] == N
    assert result.metrics["infer.0.batches"] == 3


def test_pipelined_dispatch_completeness(model, pixels, jax_labels):
    got, _, _ = run_job(model, pixels, 2, ModelWindowFunction(model, pipeline_depth=3))
    assert got == jax_labels


def test_oversized_window_chunks(model, pixels, jax_labels):
    got, result, _ = run_job(model, pixels, 10, ModelWindowFunction(
        model, policy=BucketPolicy(fixed_batch=4)))
    assert got == jax_labels
    # 10 records in chunks of 4: 4 + 4 + 2 padded to 4.
    assert result.metrics["infer.0.batches"] == 3
    assert result.metrics["infer.0.padded_records"] == 2


def test_quick_start_form(model, pixels, jax_labels):
    """The README's Quick-start options: fixed batch, warmup, selected
    outputs, pipeline depth 6, count-or-timeout window."""
    fn = ModelWindowFunction(model, policy=BucketPolicy(fixed_batch=4), warmup_batches=(4,),
                             outputs=("label", "score"), pipeline_depth=6)
    got, result, out = run_job(model, pixels, 4, fn, timeout_s=5.0)
    assert got == jax_labels
    assert all(set(r.names) == {"label", "score"} for r in out)
    assert all(r["label"].dtype == np.int32 and 0.0 < float(r["score"]) <= 1.0 for r in out)
    m = result.metrics
    assert m["infer.0.batches"] == 3 and m["infer.0.padded_records"] == 2
    assert m["infer.0.h2d_bytes"] == 3 * 4 * SIZE * SIZE * 3   # uint8, padded batches
    for name in ("batch_latency_s", "record_latency_s", "assemble_s", "dispatch_s"):
        assert m[f"infer.0.{name}"]["count"] == 3     # warmup batches are not counted


@pytest.mark.parametrize("kwargs", [
    {"use_ring": True}, {"transfer_lanes": 2}, {"wire_dtype": "bf16"},
    {"device_resident": True}, {"stamp_stages": True},
], ids=lambda kw: next(iter(kw)))
def test_unported_options_raise(model, kwargs):
    """Every option of the reference is ported now: each is taken and
    does what it says on an opened function (the ring, the lanes, the
    wire dtype: tests/test_torch_{ring,wire}.py; residency:
    tests/test_torch_device_resident.py; stamps:
    tests/test_torch_open_loop.py)."""
    kw = dict(kwargs)
    if "use_ring" in kw:
        kw["policy"] = BucketPolicy(fixed_batch=4)
    f = ModelWindowFunction(model, **kw)
    f.open(type("Ctx", (), {"device": "cpu", "metrics": None})())
    try:
        r = f.runner
        if "use_ring" in kw:
            assert f._ring is not None and f._ring.capacity == 16
        if "transfer_lanes" in kw:
            assert r.dispatch_lanes == 2 and f._max_in_flight == 3
        if "wire_dtype" in kw:
            assert r.wire_dtype == "bf16"
        if "device_resident" in kw:
            assert r.emit_device_batches
        if "stamp_stages" in kw:
            assert r.stamp_stages
    finally:
        f.close()


def test_no_device_provider_means_the_gpu(model, pixels):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    env = StreamExecutionEnvironment(parallelism=1)
    env.from_collection([TensorValue({"image": pixels[0]})]).count_window(1) \
        .apply(ModelWindowFunction(model)).sink_to_list()
    with pytest.raises(JobFailure) as info:
        env.execute(timeout=60)
    assert "CUDA is not available" in str(info.value.__cause__)

