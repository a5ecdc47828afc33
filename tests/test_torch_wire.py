"""Wire dtypes in the port, held to the JAX package on the CPU.

- ``DeviceTransfer._narrow_arrays`` and a narrowed ``encode_record`` give
  the JAX package's bytes (bf16, f16, int8; f16, f64 and int fields, NaN,
  inf and subnormal values), and each package decodes the other's frames
  to the same values (exact).
- LeNet (f32 compute, weights from the JAX initialiser carried across by
  ``models/convert.py:lenet_from_flax``) through
  ``count_window -> ModelWindowFunction(wire_dtype=...)`` in both
  packages: the same labels, logits within 1e-5 of the largest (both sum
  f32 products in another order; observed about 1e-7), and each arm
  equal to the f32 arm fed inputs rounded host-side as the wire rounds
  them.  ``h2d_bytes`` counts the narrow bytes (+4 per int8 scale) and
  ``wire_bytes_saved`` the gain.
- ``JobConfig.wire_dtype`` is validated, ``FLINK_TPU_WIRE_DTYPE`` applies
  when it is unset, and ``FLINK_TPU_DEVICE_RESIDENT`` turns residency on.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("flax")
ml_dtypes = pytest.importorskip("ml_dtypes")

import jax
import jax.numpy as jnp

from flink_tensorflow_tpu import StreamExecutionEnvironment as JaxEnv
from flink_tensorflow_tpu.functions import ModelWindowFunction as JaxModelWindowFunction
from flink_tensorflow_tpu.models import get_model_def as jax_model_def
from flink_tensorflow_tpu.models.base import Model as JaxModel
from flink_tensorflow_tpu.models.base import ModelMethod as JaxModelMethod
from flink_tensorflow_tpu.models.zoo.lenet import LeNet as JaxLeNet
from flink_tensorflow_tpu.tensors import BucketPolicy as JaxBucketPolicy
from flink_tensorflow_tpu.tensors import serde as jax_serde
from flink_tensorflow_tpu.tensors.transfer import DeviceTransfer as JaxDeviceTransfer
from flink_tensorflow_tpu.tensors.value import TensorValue as JaxTensorValue
from flink_tensorflow_tpu_torch import JobConfig, StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.functions.model_function import ModelWindowFunction
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.tensors import serde
from flink_tensorflow_tpu_torch.tensors.batching import BucketPolicy
from flink_tensorflow_tpu_torch.tensors.transfer import DeviceTransfer, narrow_field, scale_key
from flink_tensorflow_tpu_torch.tensors.value import TensorValue

WIRES = ("bf16", "f16", "int8")
F32_TOL = 1e-5
RECORDS = 24
BATCH = 8


def fields(seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal((6, 7)) * np.exp(rng.uniform(-30, 30, (6, 7)))).astype(np.float32)
    x[0, :5] = [np.nan, -np.inf, 1e-45, -3e38, 65504.5]
    return {"x": x, "d": rng.standard_normal(9), "h": rng.standard_normal(4).astype(np.float16),
            "i": np.arange(5, dtype=np.int32), "s": np.float32(2.5)}


@pytest.mark.parametrize("wire", WIRES)
def test_narrow_arrays_equal_the_jax_bytes(wire):
    arrays = {k: np.asarray(v) for k, v in fields().items() if k != "x" or wire != "int8"}
    got, got_saved = DeviceTransfer(torch.device("cpu"), wire_dtype=wire)._narrow_arrays(arrays)
    want, want_saved = JaxDeviceTransfer(None, wire)._narrow_arrays(arrays)
    assert got_saved == want_saved > 0
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.asarray(got[k]).tobytes() == np.asarray(want[k]).tobytes(), k
    if wire == "int8":
        assert scale_key("d") in got and got[scale_key("d")].dtype == np.float32


def test_bf16_rounds_as_ml_dtypes_nan_and_all():
    rng = np.random.RandomState(1)
    a = rng.standard_normal(4096).astype(np.float32) * np.float32(3e38)
    a[:4] = [np.nan, -np.nan, np.inf, -np.inf]
    a[4] = np.frombuffer(np.uint32(0xFFC12345).tobytes(), np.float32)[0]
    want = a.astype(ml_dtypes.bfloat16).view(np.uint16)
    assert np.array_equal(serde.to_bf16(a).view(torch.int16).numpy().view(np.uint16), want)
    assert np.array_equal(serde.bf16_to_f32(want), want.view(ml_dtypes.bfloat16).astype(np.float32),
                          equal_nan=True)
    t, _ = narrow_field(a, "bf16")
    assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16), want)


@pytest.mark.parametrize("wire", (None, "f32") + WIRES)
def test_encoded_frames_equal_the_jax_bytes_and_cross_decode(wire):
    f = fields()
    meta = {"id": 7, "tag": ("a", 1)}
    frame = serde.encode_record(TensorValue(f, meta), wire_dtype=wire)
    jax_frame = jax_serde.encode_record(JaxTensorValue(f, meta), wire_dtype=wire)
    assert frame == jax_frame
    assert serde.wire_bytes_saved(TensorValue(f), wire) == \
        jax_serde.wire_bytes_saved(JaxTensorValue(f), wire)
    mine, theirs = serde.decode_record(jax_frame), jax_serde.decode_record(frame)
    assert mine.meta == theirs.meta == meta
    for k in f:
        assert mine[k].dtype == theirs[k].dtype == np.asarray(f[k]).dtype
        assert mine[k].shape == theirs[k].shape
        np.testing.assert_array_equal(mine[k], theirs[k])
        assert not mine[k].flags.writeable


def test_an_unknown_wire_dtype_is_refused():
    with pytest.raises(ValueError, match="unknown wire dtype"):
        serde.encode_record(TensorValue({"x": np.ones(2, np.float32)}), wire_dtype="fp8")
    with pytest.raises(ValueError, match="wire_dtype must be one of"):
        JobConfig(wire_dtype="fp8").validate()
    with pytest.raises(ValueError, match="unknown wire dtype"):
        ModelWindowFunction(object(), wire_dtype="fp8")


# -- LeNet through both packages --------------------------------------------

@pytest.fixture(scope="module")
def lenet():
    """``(the JAX package's LeNet in f32, its variables, images)``."""
    jdef = jax_model_def("lenet")
    variables = jax.tree.map(np.asarray, jax.jit(jdef.init_fn)(jax.random.key(0)))
    module = JaxLeNet(compute_dtype=jnp.float32)

    def serve(params, inputs):
        logits = module.apply(params, inputs["image"])
        return {"logits": logits, "label": jnp.argmax(logits, axis=-1).astype(jnp.int32)}

    method = JaxModelMethod(name="serve", input_schema=jdef.input_schema,
                            output_names=("logits", "label"), fn=serve)
    jax_model = JaxModel("lenet", variables, {"serve": method})
    images = np.random.RandomState(0).rand(RECORDS, 28, 28, 1).astype(np.float32) * 4 - 1
    return jax_model, variables, images


def port_job(model, images, wire=None, env_config=None, **kw):
    env = StreamExecutionEnvironment(parallelism=1)
    env.set_device_provider(lambda task, index: "cpu")
    if env_config:
        env.configure(**env_config)
    out = (env.from_collection([TensorValue({"image": im}, {"id": i})
                                for i, im in enumerate(images)])
           .count_window(BATCH)
           .apply(ModelWindowFunction(model, policy=BucketPolicy(fixed_batch=BATCH),
                                      outputs=("label", "logits"), wire_dtype=wire, **kw),
                  name="lenet")
           .sink_to_list())
    result = env.execute(timeout=120)
    out.sort(key=lambda r: r.meta["id"])
    return out, result.metrics


def rounded(images, wire):
    """The inputs as the wire delivers them, rounded host-side."""
    if wire is None:
        return images
    if wire == "int8":
        out = []
        for lo in range(0, len(images), BATCH):
            t, scale = narrow_field(images[lo:lo + BATCH], "int8")
            out.append((t.float() * torch.tensor(scale)).numpy())
        return np.concatenate(out)
    dt = torch.bfloat16 if wire == "bf16" else torch.float16
    return torch.from_numpy(images).to(dt).float().numpy()


@pytest.mark.parametrize("wire", (None,) + WIRES)
def test_lenet_with_a_wire_dtype_matches_the_jax_package(lenet, wire):
    jax_model, variables, images = lenet
    env = JaxEnv(parallelism=1)
    want = (env.from_collection([JaxTensorValue({"image": im}, {"id": i})
                                 for i, im in enumerate(images)], parallelism=1)
            .count_window(BATCH)
            .apply(JaxModelWindowFunction(jax_model,
                                          policy=JaxBucketPolicy(fixed_batch=BATCH),
                                          outputs=("label", "logits"), wire_dtype=wire),
                   name="lenet")
            .sink_to_list())
    env.execute("lenet-wire", timeout=600)
    want.sort(key=lambda r: r.meta["id"])
    model = get_model_def("lenet", compute_dtype="float32").to_model(variables)
    got, metrics = port_job(model, images, wire)
    assert [r.meta["id"] for r in got] == list(range(RECORDS))
    g = np.stack([r["logits"] for r in got])
    w = np.stack([np.asarray(r["logits"]) for r in want])
    assert float(np.abs(g - w).max() / np.abs(w).max()) <= F32_TOL
    assert [int(r["label"]) for r in got] == [int(r["label"]) for r in want]
    # Each arm equals the f32 wire on the inputs rounded as its wire rounds.
    ref, _ = port_job(model, rounded(images, wire))
    assert all(np.array_equal(a["logits"], b["logits"]) for a, b in zip(got, ref))
    batches = RECORDS // BATCH
    per_batch = {None: 4, "bf16": 2, "f16": 2, "int8": 1}[wire] * BATCH * 784
    assert metrics["lenet.0.h2d_bytes"] == batches * (per_batch + (4 if wire == "int8" else 0))
    saved = metrics.get("lenet.0.wire_bytes_saved", 0)
    assert saved == batches * (4 * BATCH * 784 - per_batch)


def test_the_job_wire_dtype_and_its_environment_variable(lenet, monkeypatch):
    _, variables, images = lenet
    model = get_model_def("lenet", compute_dtype="float32").to_model(variables)
    bf16 = 2 * BATCH * 784 * (RECORDS // BATCH)
    _, m = port_job(model, images, env_config={"wire_dtype": "bf16"})
    assert m["lenet.0.h2d_bytes"] == bf16
    monkeypatch.setenv("FLINK_TPU_WIRE_DTYPE", "bf16")
    _, m = port_job(model, images)
    assert m["lenet.0.h2d_bytes"] == bf16
    _, m = port_job(model, images, env_config={"wire_dtype": "f32"})   # the config wins
    assert m["lenet.0.h2d_bytes"] == 2 * bf16
    _, m = port_job(model, images, wire="f32")                          # and the function
    assert m["lenet.0.h2d_bytes"] == 2 * bf16


def test_device_resident_environment_variable(monkeypatch):
    from flink_tensorflow_tpu_torch.core.runtime import LocalExecutor
    from flink_tensorflow_tpu_torch.core.graph import DataflowGraph

    assert not LocalExecutor(DataflowGraph()).device_resident
    monkeypatch.setenv("FLINK_TPU_DEVICE_RESIDENT", "1")
    assert LocalExecutor(DataflowGraph()).device_resident
