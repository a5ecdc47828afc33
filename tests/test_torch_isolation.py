"""The port stands alone: every module of it imports with ``import jax``,
``import flax`` and ``import optax`` broken, the serving slice (dense, and
a paged, tiered keyed job that spills to disk), the
Quick-start job, the training path (a keyed Wide&Deep job and a ResNet
gang), a LeNet and a BiLSTM window job, a ``ModelMapFunction`` job
from a port bundle, an event-time job (LeNet on keyed time windows
into the two-phase-commit file sink, checkpointed) and the transfer
plane (the ring, lanes, a wire dtype, stage stamps, a paced source into
a latency-budget window) run that way, no module of the JAX package is
loaded, and nothing falls back to the CPU silently.  No source of the
port (its C++ included) names the JAX package, ``jax`` or the
reference's ``native/`` directory."""

import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SLICE = textwrap.dedent("""
    import importlib, pkgutil, sys
    sys.modules["jax"] = None          # any "import jax" now raises ImportError
    sys.modules["flax"] = None
    sys.modules["optax"] = None
    import numpy as np
    import flink_tensorflow_tpu_torch as port
    modules = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
    for name in modules:
        importlib.import_module(name)
    print("IMPORTED", len(modules))
    from flink_tensorflow_tpu_torch.core.runtime import KeyedSubtask
    from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
    from flink_tensorflow_tpu_torch.serving import (
        ContinuousBatchingOperator, GenerateRequest, ServingConfig)

    mdef = get_model_def("char_transformer", vocab_size=32, embed_dim=32,
                         num_heads=2, num_layers=2, capacity=32)
    model = mdef.to_model(mdef.init_params(0))
    rng = np.random.RandomState(0)
    reqs = [GenerateRequest(session_id=i, prompt=rng.randint(1, 32, (5,)),
                            max_new_tokens=6) for i in range(4)]
    op = ContinuousBatchingOperator("cb", model, ServingConfig(
        max_active_seqs=2, token_budget=64, capacity=32, warmup_compile=True),
        device="cpu")
    events = KeyedSubtask(op).run(reqs)
    assert len([e for e in events if e.finished]) == 4

    import tempfile
    from flink_tensorflow_tpu_torch import RestartStrategy
    from flink_tensorflow_tpu_torch import StreamExecutionEnvironment as Env
    from flink_tensorflow_tpu_torch.serving import continuous_batching

    keyed_env = Env(parallelism=2)
    keyed_env.set_device_provider(lambda task, index: "cpu")
    keyed_env.enable_checkpointing(tempfile.mkdtemp(), every_n_records=2)
    tokens = continuous_batching(
        keyed_env.from_collection(reqs).key_by(lambda r: r.session_id), model,
        config=ServingConfig(max_active_seqs=2, token_budget=64, capacity=32)).sink_to_list()
    result = keyed_env.execute(timeout=60, restart_strategy=RestartStrategy(max_restarts=1))
    assert result.restarts == 0
    assert sorted(e.session_id for e in tokens if e.finished) == [0, 1, 2, 3]
    paged_env = Env(parallelism=2)
    paged_env.set_device_provider(lambda task, index: "cpu")
    paged_env.enable_checkpointing(tempfile.mkdtemp(), every_n_records=2)
    paged = continuous_batching(
        paged_env.from_collection(reqs).key_by(lambda r: r.session_id), model,
        config=ServingConfig(max_active_seqs=2, token_budget=12, capacity=32, paged_kv=True,
                             page_tokens=8, hbm_pages=4, tier_high_watermark=0.4,
                             tier_low_watermark=0.2, host_cache_sessions=0,
                             spill_dir=tempfile.mkdtemp())).sink_to_list()
    result = paged_env.execute(timeout=60, restart_strategy=RestartStrategy(max_restarts=1))
    assert result.restarts == 0
    assert sorted((e.session_id, e.index, e.token) for e in paged) == \
        sorted((e.session_id, e.index, e.token) for e in tokens)
    report = paged_env.metric_registry.report()
    assert sum(v for k, v in report.items() if k.endswith("kv_spilled_sessions")) >= 1

    from flink_tensorflow_tpu_torch.core.environment import StreamExecutionEnvironment
    from flink_tensorflow_tpu_torch.functions.model_function import ModelWindowFunction
    from flink_tensorflow_tpu_torch.tensors.batching import BucketPolicy
    from flink_tensorflow_tpu_torch.tensors.value import TensorValue

    inception = get_model_def("inception_v3", num_classes=4, image_size=75, uint8_input=True)
    images = rng.randint(0, 256, (3, 75, 75, 3)).astype(np.uint8)
    env = StreamExecutionEnvironment(parallelism=1)
    env.set_device_provider(lambda task, index: "cpu")
    out = (env.from_collection([TensorValue({"image": im}, {"id": i})
                                for i, im in enumerate(images)])
           .count_window(2, timeout_s=5.0)
           .apply(ModelWindowFunction(inception.to_model(inception.init_params(0)),
                                      policy=BucketPolicy(fixed_batch=2), warmup_batches=(2,),
                                      outputs=("label", "score"), pipeline_depth=6))
           .sink_to_list())
    env.execute(timeout=60)
    assert sorted(r.meta["id"] for r in out) == [0, 1, 2]
    from flink_tensorflow_tpu_torch.functions.training_function import (
        DPTrainWindowFunction, OnlineTrainFunction)
    from flink_tensorflow_tpu_torch.parallel.mesh import make_mesh
    from flink_tensorflow_tpu_torch.parallel.optim import adam
    from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, spec

    widedeep = get_model_def("widedeep", hash_buckets=20, embed_dim=4, num_cat_slots=2,
                             num_dense=3, num_wide=4, hidden=(8,))
    wd_schema = RecordSchema({"wide": spec((4,)), "dense": spec((3,)),
                              "cat": spec((2,), np.int32), "label": spec((), np.int32)})
    events = [TensorValue({"wide": rng.rand(4).astype(np.float32),
                           "dense": rng.rand(3).astype(np.float32),
                           "cat": rng.randint(0, 20, (2,)).astype(np.int32),
                           "label": np.int32(i % 2)}, {"user": i % 2}) for i in range(12)]
    env = StreamExecutionEnvironment(parallelism=1)
    env.set_device_provider(lambda task, index: "cpu")
    steps = (env.from_collection(events).key_by(lambda r: r.meta["user"])
             .process(OnlineTrainFunction(widedeep, adam(1e-2), train_schema=wd_schema,
                                          scope="key", mini_batch=4, steps_per_dispatch=2))
             .sink_to_list())
    env.execute(timeout=60)
    assert sorted(int(r["step"]) for r in steps) == [1, 1, 2, 2]
    resnet = get_model_def("resnet50", num_classes=3, image_size=16, width=4,
                           stage_sizes=(1, 1), uint8_input=True)
    im_schema = RecordSchema({"image": spec((16, 16, 3), np.uint8), "label": spec((), np.int32)})
    env = StreamExecutionEnvironment(parallelism=1)
    env.set_mesh(make_mesh({"data": 1}, devices=["cpu"]))
    gang = (env.from_collection([TensorValue({
                "image": rng.randint(0, 256, (16, 16, 3)).astype(np.uint8),
                "label": np.int32(i % 3)}) for i in range(8)])
            .count_window(4)
            .apply(DPTrainWindowFunction(resnet, adam(1e-3), train_schema=im_schema,
                                         global_batch=4))
            .sink_to_list())
    env.execute(timeout=60)
    assert [int(r["step"]) for r in gang] == [1, 2]
    assert all(np.isfinite(float(r["loss"])) for r in gang)

    from flink_tensorflow_tpu_torch.functions.model_function import ModelMapFunction
    from flink_tensorflow_tpu_torch.models import bilstm_cell, lenet_cell
    from flink_tensorflow_tpu_torch.models.loaders import save_bundle

    cpu = lambda task, index: "cpu"
    lenet_def, lenet, _, digits = lenet_cell.lenet_cell(0, records=12)
    run = lenet_cell.run_cell(lenet, digits, batch=4, device_provider=cpu, timeout=60)
    assert sorted(r.meta["id"] for r in run.results) == list(range(12))
    _, bilstm, texts = bilstm_cell.bilstm_cell(0, records=6)
    run = bilstm_cell.run_cell(bilstm, texts, batch=4, device_provider=cpu, timeout=60)
    assert sorted(r.meta["id"] for r in run.results) == list(range(6))
    bundle = tempfile.mkdtemp() + "/lenet"
    save_bundle(lenet_def, lenet.params, bundle)
    env = StreamExecutionEnvironment(parallelism=2)
    env.set_device_provider(cpu)
    mapped = (env.from_collection(digits, parallelism=1).rebalance()
              .map(ModelMapFunction(bundle, micro_batch=4), parallelism=2).sink_to_list())
    env.execute(timeout=60)
    assert sorted(r.meta["id"] for r in mapped) == list(range(12))

    from flink_tensorflow_tpu_torch.functions.model_function import ModelWindowFunction
    from flink_tensorflow_tpu_torch.io.files import ExactlyOnceRecordFileSink, read_committed

    out_dir = tempfile.mkdtemp()
    env = StreamExecutionEnvironment(parallelism=1)
    env.set_device_provider(cpu)
    env.enable_checkpointing(tempfile.mkdtemp(), every_n_records=4)
    windows = (env.from_collection(digits)
               .assign_timestamps(lambda r: r.meta["id"] * 0.25, watermark_every=2)
               .key_by(lambda r: r.meta["id"] % 2).time_window(1.0)
               .apply(ModelWindowFunction(lenet, pipeline_depth=3), late_tag="late"))
    windows.add_sink(ExactlyOnceRecordFileSink(out_dir))
    late = windows.side_output("late").sink_to_list()
    env.execute(timeout=60)
    assert sorted(r.meta["id"] for r in read_committed(out_dir)) == list(range(12))
    assert late == []

    # The transfer plane: the ring (C++ counters built here), three
    # lanes, a bf16 wire, stage stamps, and the open loop's paced source
    # into a latency-budget window.
    from flink_tensorflow_tpu_torch.io.sources import PacedSource

    env = StreamExecutionEnvironment(parallelism=1)
    env.set_device_provider(cpu)
    env.configure(wire_dtype="bf16")
    paced = (env.from_source(PacedSource(digits, 200.0, seed=1))
             .count_window(4, latency_budget_s=0.05)
             .apply(ModelWindowFunction(lenet, transfer_lanes=3, stamp_stages=True,
                                        ring_capacity=16), name="ol")
             .sink_to_list())
    result = env.execute(timeout=60)
    assert sorted(r.meta["id"] for r in paced) == list(range(12))
    assert all("__stages__" in r.meta and "sched_ts" in r.meta for r in paced)
    assert result.metrics["ol.0.ring_batches"] == result.metrics["ol.0.batches"]
    assert result.metrics["ol.0.wire_bytes_saved"] > 0
    leaked = sorted(m for m in sys.modules
                    if m == "flink_tensorflow_tpu" or m.startswith("flink_tensorflow_tpu."))
    print("LEAKED", leaked)
    assert not leaked, leaked
    print("OK")
""")


def test_cpu_slice_runs_without_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _SLICE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "OK" in proc.stdout


def test_no_port_source_names_jax_the_jax_package_or_native():
    port = os.path.join(REPO, "flink_tensorflow_tpu_torch")
    sources = []
    for root, _, files in os.walk(port):
        if "_build" in root or "__pycache__" in root:
            continue
        sources += [os.path.join(root, f) for f in files if f.endswith((".py", ".cpp", ".cu"))]
    assert any(p.endswith("spsc_ring.cpp") for p in sources)
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|flink_tensorflow_tpu)\b"
                         r"(?!_torch)|native/lib|libftt_native|#include\s+[\"<].*native/",
                         re.MULTILINE)
    for path in sources:
        with open(path) as f:
            hits = pattern.findall(f.read())
        assert not hits, (path, hits)


def test_no_device_means_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    from flink_tensorflow_tpu_torch.functions.runner import CompiledMethodRunner, DecodeStepRunner
    from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
    from flink_tensorflow_tpu_torch.serving import ContinuousBatchingOperator

    mdef = get_model_def("char_transformer", vocab_size=16, embed_dim=16,
                         num_heads=1, num_layers=1, capacity=16)
    model = mdef.to_model(mdef.init_params(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecodeStepRunner(model, pool_slots=2, capacity=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousBatchingOperator("cb", model)
    # In a job, the serving subtask without a device provider takes cuda
    # at open() and fails the job.
    from flink_tensorflow_tpu_torch import StreamExecutionEnvironment
    from flink_tensorflow_tpu_torch.core.runtime import JobFailure
    from flink_tensorflow_tpu_torch.serving import GenerateRequest, continuous_batching

    env = StreamExecutionEnvironment(parallelism=1)
    continuous_batching(env.from_collection([GenerateRequest("s", [1, 2], 2)])
                        .key_by(lambda r: r.session_id), model).sink_to_list()
    with pytest.raises(JobFailure) as info:
        env.execute(timeout=60)
    assert "CUDA is not available" in str(info.value.__cause__)
    inception = get_model_def("inception_v3", num_classes=4, image_size=75)
    runner = CompiledMethodRunner(inception.to_model(inception.init_params(0)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.open()
