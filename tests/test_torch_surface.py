"""The port's public surface held to the JAX package's.

The walk imports every module of both packages and compares public names
(every name a package's ``__init__`` exports, every function and class a
module defines) and the public attributes of each class.  A name of the
reference with no same-named counterpart in the port must have a row in
``SURFACE``: the port's counterpart, or the reason none exists.  A row
whose name now exists in the port, or no longer in the reference, fails
too, so the table stays true.  Flax modules are held by their fields:
the ``flax.linen.Module`` API (``bind``, ``init``, ``scope``, ...) has no
counterpart in a ``torch.nn.Module``, and each dataclass field must be a
constructor argument of the port's module or have a row.

The record API and the rest of the surface are held to the reference on
the same numpy inputs: ``TensorValue`` equality in every case (the port
compared records by identity before), ``replace``, ``select``,
``schema``, ``conforms_to``, the device round trip, ``register_converter``
and ``image_to_float`` exactly; the small additions each by its
behaviour.
"""

import dataclasses
import importlib
import inspect
import pkgutil
import threading
import time

import numpy as np
import pytest
import torch

pytest.importorskip("flax")

import flax.linen as nn

import flink_tensorflow_tpu
import flink_tensorflow_tpu_torch
from flink_tensorflow_tpu.tensors import TensorValue as J
from flink_tensorflow_tpu_torch.tensors import TensorValue as T

_JAX_MESH = "a jax sharding object; torch has no sharding annotations"
_NO_CALLER = "no caller in either package"
_FLAX_BLOCK_DTYPE = ("the port's blocks run in the dtype of their input (the net casts once "
                     "to its compute_dtype); they take the input width cin instead")

#: Every public name of the reference without a same-named counterpart in
#: the port: ``module`` (a whole module), ``module:Name`` or
#: ``module:Class.attr``, each with the port's counterpart or the reason.
SURFACE = {
    # whole modules
    "models.tf_loader": "needs TensorFlow and jax2tf.call_tf; the port imports TF weights by "
                        "name with models/import_tf.py",
    "utils.jaxcompat": "probes jax features; the port imports no jax",
    "utils.platform": "pins jax to the CPU; the port's counterpart is "
                      "utils/device.py:resolve_device (device='cpu')",
    "version": "the port's __init__.py carries __version__",
    # analysis
    "analysis.chaining:ChainPlan.format_topology": "ChainPlan.describe, the same lines",
    "analysis.costmodel:cost_of_closed": "walks a closed jaxpr; torch has none: the port prices "
                                         "a unit on meta tensors (costmodel.cost_of_call)",
    "analysis.costmodel:flops_of_closed": "walks a closed jaxpr; the port counts FLOPs in "
                                          "costmodel.cost_of_call",
    "analysis.shardcheck:count_collectives": "counts a jaxpr's collective primitives; the port "
                                             "counts its collectives' calls under "
                                             "parallel/collectives.py:census()",
    "analysis.shardcheck:peak_activation_bytes": "a jaxpr liveness walk; the port tracks live "
                                                 "output bytes in costmodel.cost_of_call",
    # core
    "core.channels:InputGate.try_put": "InputGate.try_put_batch (its one caller, the reactor, "
                                       "puts a frame's elements at once)",
    "core.channels:InputGate.any_blocked": "no caller in the reference; the blocked channels "
                                           "stay private to barrier alignment",
    "core.channels:InputGate.channel_puts": "InputGate.puts_per_channel[idx], read by the "
                                            "edge<i>_<up>_queue_puts gauges",
    "core.event_time:EventTimeWindowOperator.GLOBAL_KEY": "core/event_time.py:GLOBAL_KEY",
    "core.event_time:SessionWindowOperator.GLOBAL_KEY": "core/event_time.py:GLOBAL_KEY",
    "core.operators:SubtaskStats.busy_s": "the head's process_latency_s timer total, which the "
                                          "runtime's busy_s gauge reads",
    "core.operators:Output.has_downstream": _NO_CALLER,
    "core.runtime:ChainedOutput.has_downstream": _NO_CALLER,
    # functions
    "functions.model_function:ModelMapFunction.on_finish": "ModelMapFunction.flush(out), which "
                                                           "MapOperator.finish calls",
    "functions.model_function:GraphMapFunction.on_finish": "GraphMapFunction.flush(out), which "
                                                           "MapOperator.finish calls",
    "functions.runner:DecodeStepRunner.pool_built": _NO_CALLER,
    "functions.runner:PagedDecodeStepRunner.pool_built": _NO_CALLER,
    # models
    "models:TFGraphDefLoader": "models/tf_loader.py (see its row)",
    "models:TFSavedModelLoader": "models/tf_loader.py (see its row)",
    "models.base:ModelMethod.compute_dtype": "the module's compute_dtype (the def's config) "
                                             "sets a method's precision; the reference's field "
                                             "has no reader",
    "models.zoo.inception:ConvBN.compute_dtype": _FLAX_BLOCK_DTYPE,
    "models.zoo.inception:InceptionA.dtype": _FLAX_BLOCK_DTYPE,
    "models.zoo.inception:InceptionB.dtype": _FLAX_BLOCK_DTYPE,
    "models.zoo.inception:InceptionC.dtype": _FLAX_BLOCK_DTYPE,
    "models.zoo.inception:ReductionA.dtype": _FLAX_BLOCK_DTYPE,
    "models.zoo.inception:ReductionB.dtype": _FLAX_BLOCK_DTYPE,
    "models.zoo.resnet:BottleneckBlock.compute_dtype": _FLAX_BLOCK_DTYPE,
    "models.zoo.resnet:BottleneckBlock.strides": "the argument stride (one int: flax's tuple is "
                                                 "always square here)",
    # parallel
    "parallel:MeshSpec": "a jax mesh's axis spec; parallel.mesh.Mesh carries its axes itself",
    "parallel.mesh:MeshSpec": "a jax mesh's axis spec; parallel.mesh.Mesh carries its axes "
                              "itself",
    "parallel:named_sharding": _JAX_MESH + ": a batch is split with shard_batch",
    "parallel.mesh:named_sharding": _JAX_MESH + ": a batch is split with shard_batch",
    "parallel:replicated": _JAX_MESH + ": parallel.mesh.replicate copies a tree to the "
                                       "mesh's device",
    "parallel.mesh:replicated": _JAX_MESH + ": parallel.mesh.replicate copies a tree to the "
                                            "mesh's device",
    "parallel.multihost:hybrid_device_array": "lays a global jax.Array over slices; torch has "
                                              "no global array: each rank holds its own rows "
                                              "(parallel.mesh.shard_batch)",
    # tensors
    "tensors.batching:Batch.bucket_key": "the jit compile-cache key; eager torch compiles "
                                         "nothing per shape (the runners mint their own "
                                         "signature strings)",
    "tensors.transfer:DeviceBatch.arrays": "DeviceBatch.tensors",
    "tensors.transfer:DeviceBatch.device_nbytes": _NO_CALLER,
    "tensors.transfer:DeviceBatch.lengths": "a device hop is taken only for a method without "
                                            "lengths (CompiledMethodRunner.can_accept_device)",
    "tensors.transfer:DeviceTransfer.ship": "DeviceTransfer.assemble_and_ship and ship_batch "
                                            "(assembly straight into a staging slot)",
    "tensors.transfer:DeviceTransfer.fetch": "DeviceTransfer.start_fetch on a lane, then "
                                             "finish_fetch on the fetch thread",
    "tensors.transfer:DeviceTransfer.to_device": "DeviceTransfer.ship_batch moves a batch; "
                                                 "TensorValue.to_device one record",
    "tensors.transfer:DeviceTransfer.lengths_to_device": "the lengths ride the fields' staging "
                                                         "slot and copy stream "
                                                         "(assemble_and_ship)",
}


#: A reference export the port keeps as a submodule of the same name.
SUBMODULE_EXPORTS = {
    "ops:flash_attention": "the submodule ops.flash_attention (its callers import it); the "
                           "reference's exported function is ops.flash_attention.flash_attention",
}


def _walk(pkg):
    """``{module path: (module, {name: object})}`` over ``pkg``: a package
    module's public non-module names, a plain module's functions and
    classes defined there."""
    out = {"": (pkg, {n: v for n, v in vars(pkg).items()
                      if not n.startswith("_") and not inspect.ismodule(v)})}
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        if ".examples" in info.name:
            continue
        mod = importlib.import_module(info.name)
        rel = info.name[len(pkg.__name__) + 1:]
        names = {}
        for n, v in vars(mod).items():
            if n.startswith("_") or inspect.ismodule(v):
                continue
            if info.ispkg or getattr(v, "__module__", None) == mod.__name__:
                names[n] = v
        out[rel] = (mod, names)
    return out


def _gaps():
    """Each reference name the port lacks, as a ``SURFACE`` key."""
    ref, port = _walk(flink_tensorflow_tpu), _walk(flink_tensorflow_tpu_torch)
    flax_api = set(dir(nn.Module))
    gaps = []
    for rel, (_, names) in sorted(ref.items()):
        if rel not in port:
            gaps.append(rel)
            continue
        pmod = port[rel][0]
        for name, obj in sorted(names.items()):
            if not hasattr(pmod, name):
                gaps.append(f"{rel}:{name}")
                continue
            pobj = getattr(pmod, name)
            if not (inspect.isclass(obj) and obj.__module__ == ref[rel][0].__name__
                    and inspect.isclass(pobj)):
                continue
            if issubclass(obj, nn.Module):
                params = inspect.signature(pobj.__init__).parameters
                for field in dataclasses.fields(obj):
                    if field.name not in ("name", "parent") and field.name not in params:
                        gaps.append(f"{rel}:{name}.{field.name}")
                continue
            for attr in sorted(a for a in dir(obj) if not a.startswith("_")):
                if not hasattr(pobj, attr):
                    gaps.append(f"{rel}:{name}.{attr}")
    return gaps, flax_api


def test_every_reference_name_has_a_counterpart_or_a_row():
    gaps, _ = _gaps()
    missing = [g for g in gaps if g not in SURFACE]
    assert missing == [], "names with neither a counterpart nor a row: " + ", ".join(missing)
    stale = sorted(set(SURFACE) - set(gaps))
    assert stale == [], "rows of names the port has, or the reference lacks: " + ", ".join(stale)
    assert all(reason.strip() for reason in SURFACE.values())


@pytest.mark.parametrize("package", ["tensors", "models", "models.zoo", "functions", "core",
                                     "checkpoint", "native", "ops", "parallel", "metrics",
                                     "serving", "sources", "io", "tracing", "analysis"])
def test_package_exports_import_by_name(package):
    ref = importlib.import_module(f"flink_tensorflow_tpu.{package}")
    port = importlib.import_module(f"flink_tensorflow_tpu_torch.{package}")
    for name in getattr(ref, "__all__", []):
        if f"{package}:{name}" in SURFACE:
            continue
        if f"{package}:{name}" in SUBMODULE_EXPORTS:
            assert inspect.ismodule(getattr(port, name)) and callable(
                getattr(getattr(port, name), name))
            continue
        exec(f"from flink_tensorflow_tpu_torch.{package} import {name}", {})
        assert name in getattr(port, "__all__", [name]), (package, name)


# -- the record API ------------------------------------------------------------

def _pair(fields, meta=None):
    return J(fields, meta), T({k: np.array(v) for k, v in fields.items()}, meta)


@pytest.mark.parametrize("case", ["equal", "copied", "unequal-values", "other-field",
                                  "meta-only", "not-a-record", "other-shape"])
def test_equality_agrees_with_the_reference(case):
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    left = {"x": a, "id": np.int32(1)}
    right, right_meta = {
        "equal": (left, {"k": 1}),
        "copied": ({"x": a.copy(), "id": np.int32(1)}, {"k": 1}),
        "unequal-values": ({"x": a + 1, "id": np.int32(1)}, {"k": 1}),
        "other-field": ({"x": a, "y": np.int32(1)}, {"k": 1}),
        "meta-only": (left, {"k": 2}),
        "not-a-record": (None, None),
        "other-shape": ({"x": a.reshape(3, 2), "id": np.int32(1)}, {"k": 1}),
    }[case]
    jl, tl = _pair(left, {"k": 1})
    if right is None:
        assert (jl == 3) is False and (tl == 3) is False
        assert (jl != "x") is True and (tl != "x") is True
        return
    jr, tr = _pair(right, right_meta)
    assert (tl == tr) == (jl == jr)
    assert (tl != tr) == (jl != jr)


def test_equal_records_were_unequal_by_identity_and_now_compare_by_value():
    a = np.arange(4.0)
    assert T({"x": a}, {"id": 1}) == T({"x": a.copy()}, {"id": 1})
    assert J({"x": a}, {"id": 1}) == J({"x": a.copy()}, {"id": 1})


def test_replace_select_schema_and_conforms_to_match_the_reference():
    rng = np.random.RandomState(0)
    fields = {"a": rng.rand(3, 2).astype(np.float32), "b": rng.randint(0, 9, (4,)).astype(np.int32)}
    j, t = _pair(fields, {"id": 7})
    new = rng.rand(5).astype(np.float64)
    jr, tr = j.replace(a=new, c=np.int64(3)), t.replace(a=new, c=np.int64(3))
    assert tr.names == jr.names and dict(tr.meta) == dict(jr.meta)
    for n in jr.names:
        np.testing.assert_array_equal(tr[n], jr[n])
        assert tr[n].dtype == jr[n].dtype and not tr[n].flags.writeable
    assert t.select("b").names == j.select("b").names == ["b"]
    assert dict(t.select("b").meta) == {"id": 7}
    assert repr(t.schema()) == repr(j.schema())
    from flink_tensorflow_tpu.tensors import RecordSchema as JS
    from flink_tensorflow_tpu.tensors import spec as jspec
    from flink_tensorflow_tpu_torch.tensors import RecordSchema as TS
    from flink_tensorflow_tpu_torch.tensors import spec as tspec

    for shape, dtype in (((3, 2), np.float32), ((None, 2), np.float32), ((3, 2), np.int32),
                         ((2, 3), np.float32)):
        js = JS({"a": jspec(shape, dtype), "b": jspec((4,), np.int32)})
        ts = TS({"a": tspec(shape, dtype), "b": tspec((4,), np.int32)})
        assert t.conforms_to(ts) == j.conforms_to(js), (shape, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint8, np.float64])
def test_device_round_trip_keeps_values_and_meta(dtype):
    fields = {"x": (np.arange(12) % 7).astype(dtype).reshape(3, 4), "y": np.array(dtype(2))}
    t = T(fields, {"id": 3})
    on = t.to_device("cpu")
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu" for v in on.values())
    back = T.from_device(on, t.meta)
    want = J(fields, {"id": 3})
    assert back == t and back.names == want.names and dict(back.meta) == dict(want.meta)
    for n in want.names:
        np.testing.assert_array_equal(back[n], want[n])
        assert back[n].dtype == want[n].dtype
    assert all(not back[n].flags.writeable for n in back.names)


def test_to_device_without_a_device_means_the_card():
    t = T({"x": np.zeros(2, np.float32)})
    if torch.cuda.is_available():
        assert t.to_device()["x"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t.to_device()


def test_from_device_widens_bf16_to_f32():
    back = T.from_device({"x": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)})
    assert back["x"].dtype == np.float32
    np.testing.assert_array_equal(back["x"], [1.5, -2.25])


# -- coercion ----------------------------------------------------------------------

class _Celsius:
    def __init__(self, v):
        self.v = v


def test_register_converter_matches_the_reference_and_later_wins():
    from flink_tensorflow_tpu.tensors import coercion as jc
    from flink_tensorflow_tpu.tensors import RecordSchema as JS
    from flink_tensorflow_tpu.tensors import spec as jspec
    from flink_tensorflow_tpu_torch.tensors import coercion as tc
    from flink_tensorflow_tpu_torch.tensors import RecordSchema as TS
    from flink_tensorflow_tpu_torch.tensors import spec as tspec

    saved = (list(jc._CONVERTERS), list(tc._CONVERTERS))
    try:
        for mod in (jc, tc):
            mod.register_converter(lambda v: isinstance(v, _Celsius),
                                   lambda v, s: np.asarray([v.v], s.dtype))
            mod.register_converter(lambda v: isinstance(v, _Celsius),
                                   lambda v, s: np.asarray([v.v + 273.15], s.dtype))
        js, ts = JS({"t": jspec((1,), np.float32)}), TS({"t": tspec((1,), np.float32)})
        want, got = jc.coerce({"t": _Celsius(20.0)}, js), tc.coerce({"t": _Celsius(20.0)}, ts)
        np.testing.assert_array_equal(got["t"], want["t"])
        np.testing.assert_array_equal(got["t"], np.float32([293.15]))
        # A plain array still takes the array-like path in both.
        np.testing.assert_array_equal(tc.coerce([1.0], ts)["t"], jc.coerce([1.0], js)["t"])
    finally:
        jc._CONVERTERS[:], tc._CONVERTERS[:] = saved


@pytest.mark.parametrize("scale,offset,dtype", [(1 / 255.0, 0.0, np.float32),
                                                (1 / 127.5, -1.0, np.float32),
                                                (0.5, 0.25, np.float64)])
def test_image_to_float_matches_the_reference(scale, offset, dtype):
    from flink_tensorflow_tpu.tensors import image_to_float as jfn
    from flink_tensorflow_tpu_torch.tensors import image_to_float as tfn

    img = np.random.RandomState(1).randint(0, 256, (5, 4, 3)).astype(np.uint8)
    for x in (img, img.astype(np.float32)):
        want = jfn(x, scale=scale, offset=offset, dtype=dtype)
        got = tfn(x, scale=scale, offset=offset, dtype=dtype)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# -- models ------------------------------------------------------------------------

def test_model_methods_and_with_params_leave_the_model_as_it_was(tmp_path):
    from flink_tensorflow_tpu_torch.models import SavedModelLoader, get_model_def, save_bundle

    mdef = get_model_def("lenet")
    model = mdef.to_model(mdef.init_fn(0))
    other = mdef.init_fn(1)
    swapped = model.with_params(other)
    assert swapped is not model and swapped.params is other and model.params is not other
    assert swapped.methods == model.methods and set(model.methods) == {"serve"}
    assert swapped.name == model.name and swapped.metadata == model.metadata
    save_bundle(mdef, model.params, str(tmp_path / "b"))
    loaded = SavedModelLoader(str(tmp_path / "b")).model_def()
    assert (loaded.architecture, loaded.config) == (mdef.architecture, mdef.config)


# -- the runtime's smaller names -----------------------------------------------------

def test_environment_legacy_attributes():
    from flink_tensorflow_tpu_torch.core import StreamExecutionEnvironment

    env = StreamExecutionEnvironment()
    assert env.set_parallelism(3) is env and env.config.parallelism == 3
    env.channel_capacity = 64
    env.checkpoint_interval_s = 2.5
    provider = lambda task, index: "cpu"   # noqa: E731
    env.device_provider = provider
    assert (env.channel_capacity, env.checkpoint_interval_s) == (64, 2.5)
    assert env.config.channel_capacity == 64 and env.config.checkpoint.interval_s == 2.5
    assert env.device_provider is provider is env.config.device_provider
    with pytest.deprecated_call():
        env.job_config["model_path"] = "/m"
    assert env.config.user_params == {"model_path": "/m"}
    with pytest.deprecated_call():
        env.job_config = {"a": 1}
    assert env.config.user_params == {"a": 1}


def test_kv_cache_names():
    from flink_tensorflow_tpu_torch.core.state import KeyedStateStore
    from flink_tensorflow_tpu_torch.serving import KVBlock, KVCacheState, SessionState

    k = np.zeros((2, 8, 4, 16), np.float32)
    block = KVBlock(k, k.copy(), 5)
    assert block.nbytes() == 2 * k.nbytes
    fresh = SessionState(seq=0, prompt=np.arange(3, dtype=np.int32), max_new=4, eos=None)
    assert fresh.cache_length() == 0
    assert dataclasses.replace(fresh, kv=block).cache_length() == 5
    cache = KVCacheState(KeyedStateStore())
    cache.put("s1", fresh)
    cache.put("s2", fresh)
    cache.remove("s1")
    assert cache.keys() == ["s2"] and cache.get("s1") is None


def test_partitioners_sinks_and_window_assigner():
    from flink_tensorflow_tpu_torch.core import partitioning as p
    from flink_tensorflow_tpu_torch.core.functions import SinkFunction
    from flink_tensorflow_tpu_torch.core.windows import WindowAssigner
    from flink_tensorflow_tpu_torch.io.files import ExactlyOnceRecordFileSink
    from flink_tensorflow_tpu_torch.io.remote import RemoteSink

    assert p.BroadcastPartitioner().is_broadcast()
    assert not any(c().is_broadcast() for c in (p.ForwardPartitioner, p.RebalancePartitioner))
    assert not p.HashPartitioner(lambda x: x).is_broadcast()
    assert SinkFunction.idempotent is None
    assert ExactlyOnceRecordFileSink.idempotent is True and RemoteSink.idempotent is False
    with pytest.raises(NotImplementedError):
        WindowAssigner().assign(1, None)


def test_chain_of_names_the_chain_a_transformation_runs_in():
    from flink_tensorflow_tpu_torch.analysis.chaining import compute_chains
    from flink_tensorflow_tpu_torch.core import StreamExecutionEnvironment

    env = StreamExecutionEnvironment()
    env.from_collection([1, 2]).map(lambda x: x, name="a").rebalance() \
        .map(lambda x: x, name="b").sink_to_list()
    plan = compute_chains(env.graph)
    for chain in plan.chains:
        for t in chain:
            assert plan.chain_of(t) is chain
    last = plan.chains[-1][-1]
    assert [t.name for t in plan.chain_of(last)] == plan.names()[-1]
    assert [t.name for t in plan.chain_of(plan.chains[0][0])] == ["collection", "a"]


def test_matches_scope_is_fnmatch():
    from flink_tensorflow_tpu.metrics.roofline import matches_scope as jm
    from flink_tensorflow_tpu_torch.metrics.roofline import matches_scope as tm

    for pattern, scope in (("*.0", "map.0"), ("map.*", "map.12"), ("win?.1", "win2.1"),
                           ("a.*", "b.0"), ("[ab].0", "c.0")):
        assert tm(pattern, scope) == jm(pattern, scope)


def test_local_executor_run_and_native_available():
    from flink_tensorflow_tpu_torch.core import StreamExecutionEnvironment
    from flink_tensorflow_tpu_torch.core.runtime import LocalExecutor
    from flink_tensorflow_tpu_torch.native import native_available

    env = StreamExecutionEnvironment()
    out = env.from_collection([1, 2, 3]).map(lambda x: 2 * x).sink_to_list()
    LocalExecutor(env.graph).run(timeout=30)
    assert sorted(out) == [2, 4, 6]
    assert isinstance(native_available(), bool)


def test_runner_run_batch_and_oldest_pending_age():
    from flink_tensorflow_tpu_torch.functions import CompiledMethodRunner
    from flink_tensorflow_tpu_torch.models import get_model_def

    mdef = get_model_def("lenet")
    model = mdef.to_model(mdef.init_fn(0))
    runner = CompiledMethodRunner(model, "serve")

    class Ctx:
        device = "cpu"
        metrics = None
        subtask_index = 0
        task_name = "t"

    runner.open(Ctx())
    try:
        assert runner.oldest_pending_age_s() is None
        images = np.random.RandomState(0).rand(4, 28, 28, 1).astype(np.float32)
        records = [T({"image": im}, {"id": i}) for i, im in enumerate(images)]
        out = runner.run_batch(records)
        assert [r.meta["id"] for r in out] == [0, 1, 2, 3]
        with torch.inference_mode():
            want = mdef.methods["serve"].fn(model.params, {"image": torch.from_numpy(images)})
        np.testing.assert_array_equal([int(r["label"]) for r in out], want["label"].numpy())
        assert runner.oldest_pending_age_s() is None
        gate = threading.Event()
        real = runner._process_item

        def held(item):
            gate.wait(10)
            return real(item)

        runner._process_item = held
        runner.dispatch(records[:2])
        time.sleep(0.05)
        age = runner.oldest_pending_age_s()
        assert age is not None and age >= 0.04
        assert runner.oldest_pending_age_s(now=time.monotonic() + 10) > 10
        gate.set()
        assert len(runner.flush()) == 2
    finally:
        runner.close()
