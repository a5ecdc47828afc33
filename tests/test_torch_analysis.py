"""The port's plan analyzer held to the JAX package's.

Every plan of the reference's lint tests (``tests/test_analysis.py``:
``TestLintRules``, ``TestSchemaPropagation``, ``TestServingLints``,
``TestKvPoolUndersizedLint``, ``TestWatermarkLints``,
``TestShardingAxisLint``, ``TestDeviceResidencyLint``,
``TestFlowControlLint``, ``TestSloUnmonitoredLint``;
``tests/test_split_sources.py::TestSplitLint``;
``tests/test_cohort_telemetry.py::TestCohortTelemetryLint``;
``tests/test_sanitizer.py::{TestReplayPurityLint,
TestLegacySourceTimerChainLint}``) is built once per package by the same
function, and ``analyze`` must give the same ``(rule, severity, node,
edge)`` list in both, in the same order, and ``propagate`` the same
output schema at every node.  The reference's analyzer also runs its
shardcheck and statecheck rule families, which the port does not have
yet: their findings are left out of the comparison.  Each case also
checks the reference test's own expectation on the port's result.

Then the ``validate=True`` gate (``TestValidateGate``) and the CLI's exit
codes and ``--json`` keys on pipeline files written here.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

pytest.importorskip("flax")

import jax
import jax.numpy as jnp

import flink_tensorflow_tpu as jpkg
import flink_tensorflow_tpu_torch as ppkg
from flink_tensorflow_tpu.analysis import __main__ as jcli
from flink_tensorflow_tpu.analysis import analyzer as janalyzer
from flink_tensorflow_tpu.analysis.schema_prop import propagate as jpropagate
from flink_tensorflow_tpu_torch.analysis import RULES, PlanValidationError
from flink_tensorflow_tpu_torch.analysis import __main__ as pcli
from flink_tensorflow_tpu_torch.analysis.analyzer import _instantiate as p_instantiate
from flink_tensorflow_tpu_torch.analysis.schema_prop import propagate as ppropagate

#: Rule ids of the analyzer core (beside the registry's 33).
CORE_RULES = {"cycle", "factory-error", "schema-mismatch", "schema-hook-error",
              "source-schema-unknown"}

#: The reference's 33 lint rules, in its registration order, with its
#: severities (JAX ``analysis/rules.py:129-1016``: the 21 it defines, then
#: the shardcheck and statecheck families it registers at its bottom).
REFERENCE_RULES = [
    ("dangling-root", "ERROR"), ("keyed-partitioning", "ERROR"),
    ("forward-parallelism", "ERROR"), ("keyed-parallelism-bound", "ERROR"),
    ("mesh-divisibility", "ERROR"), ("dynamic-jit-boundary", "ERROR"),
    ("watermark-missing-assigner", "ERROR"), ("watermark-async-flush", "WARN"),
    ("sharding-axis", "ERROR"), ("source-split-parallelism", "WARN"),
    ("replay-purity", "WARN"), ("legacy-source-timer-chain", "WARN"),
    ("device-residency", "WARN"), ("remote-edge-buffer-timeout", "WARN"),
    ("flow-control", "WARN"), ("cohort-telemetry", "WARN"), ("slo-unmonitored", "WARN"),
    ("serving-unkeyed-input", "ERROR"), ("serving-recompile-churn", "WARN"),
    ("kv-pool-undersized", "WARN"), ("recompile-churn", "WARN"),
    ("shardcheck-collectives", "INFO"), ("shardcheck-reshard", "WARN"),
    ("shardcheck-donation", "WARN"), ("shardcheck-partition", "ERROR"),
    ("shardcheck-hbm-budget", "ERROR"), ("shardcheck-signatures", "WARN"),
    ("statecheck-hidden-state", "ERROR"), ("statecheck-train-state", "WARN"),
    ("statecheck-rescale", "WARN"), ("statecheck-rng-stream", "WARN"),
    ("statecheck-page-keygroup", "WARN"), ("exactly-once-boundary", "WARN"),
]


def _namespace(root: str) -> types.SimpleNamespace:
    """The names the plan functions use, from one package."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    graph, part, ops = mod("core.graph"), mod("core.partitioning"), mod("core.operators")
    schema, batching = mod("tensors.schema"), mod("tensors.batching")
    serving, sources = mod("serving"), mod("sources")
    jax_side = root == "flink_tensorflow_tpu"
    functions = mod("functions") if jax_side else None
    return types.SimpleNamespace(
        jax=jax_side, Env=mod("core.environment").StreamExecutionEnvironment,
        fn=mod("core.functions"), Edge=graph.Edge,
        Forward=part.ForwardPartitioner, Rebalance=part.RebalancePartitioner,
        MapOperator=ops.MapOperator, ProcessOperator=ops.ProcessOperator,
        RecordSchema=schema.RecordSchema, spec=schema.spec,
        BucketLadder=batching.BucketLadder, BucketPolicy=batching.BucketPolicy,
        ModelWindowFunction=(functions.ModelWindowFunction if jax_side
                             else mod("functions.model_function").ModelWindowFunction),
        ModelMapFunction=(functions.ModelMapFunction if jax_side
                          else mod("functions.model_function").ModelMapFunction),
        OnlineTrainFunction=(functions.OnlineTrainFunction if jax_side
                             else mod("functions.training_function").OnlineTrainFunction),
        serving=serving, PacedSplitSource=sources.PacedSplitSource,
        ReplaySplitSource=sources.ReplaySplitSource,
        DistributedConfig=mod("core.distributed").DistributedConfig,
        HealthConfig=mod("metrics.health").HealthConfig,
        AutoscaleConfig=mod("core.autoscale").AutoscaleConfig,
        TensorValue=mod("tensors.value").TensorValue,
        get_model_def=(mod("models").get_model_def if jax_side
                       else mod("models.zoo.registry").get_model_def),
        models=None)


J = _namespace("flink_tensorflow_tpu")
P = _namespace("flink_tensorflow_tpu_torch")


# ---------------------------------------------------------------------------
# models, built once per package
# ---------------------------------------------------------------------------

CHAR_CFG = dict(vocab_size=32, embed_dim=32, num_heads=2, num_layers=1, capacity=32)
WIDEDEEP_CFG = dict(hash_buckets=16, embed_dim=2, num_cat_slots=2, num_dense=2, num_wide=4,
                    hidden=(4,))


class _ScaleModule(torch.nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(dim))


def _res_model(N, dim=4):
    """The reference's tiny model whose output schema equals its input
    schema, so model -> model chains are device-batch compatible."""
    schema = N.RecordSchema({"x": N.spec((dim,))})
    if N.jax:
        from flink_tensorflow_tpu.models.base import Model, ModelMethod

        return Model("resmlp", {"w": jnp.ones((dim,), jnp.float32)},
                     {"serve": ModelMethod("serve", schema, ("x",),
                                           lambda params, inputs: {"x": inputs["x"] * params["w"]})})
    from flink_tensorflow_tpu_torch.models.base import Model, ModelMethod

    return Model("resmlp", _ScaleModule(dim),
                 {"serve": ModelMethod("serve", schema, ("x",),
                                       lambda module, inputs: {"x": inputs["x"] * module.w})})


def _models(N):
    if N.models is None:
        lenet = N.get_model_def("lenet")
        char = N.get_model_def("char_transformer", **CHAR_CFG)
        if N.jax:
            lenet_model = lenet.to_model(jax.jit(lenet.init_fn)(jax.random.key(0)))
            char_model = char.to_model(char.init_params(jax.random.PRNGKey(0)))
        else:
            lenet_model = lenet.to_model(lenet.init_fn(0))
            char_model = char.to_model(char.init_params(0))
        N.models = types.SimpleNamespace(lenet=lenet_model, char=char_model, res=_res_model(N))
    return N.models


# ---------------------------------------------------------------------------
# the plans: make(N) -> env, whether analyze gets the config, and an optional check on the
# port's diagnostics (the reference test's expectation)
# ---------------------------------------------------------------------------

def _id_map(N):
    class IdMap(N.fn.MapFunction):
        def map(self, value):
            return value
    return IdMap()


def _proc(N):
    class Proc(N.fn.ProcessFunction):
        def process_element(self, value, ctx, out):
            out.collect(value)
    return Proc()


def _jit_window(N, policy=None, gang_batch=None):
    class StubJitWindowFn(N.fn.WindowFunction):
        is_jit_boundary = True

        def __init__(self):
            self._policy = policy
            if gang_batch is not None:
                self.is_gang = True
                self.global_batch = gang_batch

        def process_window(self, key, window, elements, out):
            for e in elements:
                out.collect(e)
    return StubJitWindowFn()


def _count_window_fn(N):
    class CountWindowFn(N.fn.WindowFunction):
        def process_window(self, key, window, elements, out):
            out.collect(len(elements))
    return CountWindowFn()


def _async_map(N):
    class StubAsyncMap(N.fn.AsyncMapFunction):
        _micro_batch = 8

        def map_async(self, value, out):
            out.collect(value)

        def flush(self, out=None):
            pass
    return StubAsyncMap()


def _annotated_map(N, axes, batch=None):
    class AnnotatedMap(N.fn.MapFunction):
        def __init__(self):
            self.sharding_axes = axes
            self._policy = N.BucketPolicy(fixed_batch=batch) if batch else None

        def map(self, value):
            return value
    return AnnotatedMap()


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def f32(N):
    return N.RecordSchema({"x": N.spec((4,), np.float32)})


def i32(N):
    return N.RecordSchema({"x": N.spec((4,), np.int32)})


def clean_env(N, parallelism=1):
    env = N.Env(parallelism=parallelism)
    (env.from_collection([1, 2, 3], schema=f32(N))
        .map(_id_map(N), output_schema=lambda s: s)
        .filter(lambda v: True)
        .sink_to_list())
    return env


PLANS = {}


def plan(name, *, config=True, check=None):
    def register(make):
        PLANS[name] = (make, config, check)
        return make
    return register


def by_rule(diags, rule_id):
    return [d for d in diags if d.rule == rule_id]


def errors(diags):
    return [d for d in diags if d.severity.name == "ERROR"]


# -- TestLintRules ----------------------------------------------------------

@plan("clean", check=lambda d: d == [])
def _(N):
    return clean_env(N)


@plan("dangling-root", config=False,
      check=lambda d: [(x.node, x.severity.name) for x in by_rule(d, "dangling-root")]
      == [("orphan", "ERROR")])
def _(N):
    env = clean_env(N)
    env.graph.add("orphan", lambda: N.MapOperator("orphan", _id_map(N)), 1)
    return env


@plan("keyed-partitioning", config=False,
      check=lambda d: [x.edge for x in by_rule(d, "keyed-partitioning")]
      == ["collection -> keyed"])
def _(N):
    env = N.Env()
    src = env.from_collection([1, 2, 3], schema=f32(N))
    env.graph.add("keyed", lambda: N.ProcessOperator("keyed", _proc(N), key_selector=lambda v: v),
                  1, inputs=[N.Edge(src.transformation, N.Rebalance())])
    return env


@plan("keyed-partitioning-clean", config=False,
      check=lambda d: by_rule(d, "keyed-partitioning") == [])
def _(N):
    env = N.Env()
    env.from_collection([1, 2, 3]).key_by(lambda v: v).process(_proc(N))
    return env


@plan("forward-parallelism", config=False,
      check=lambda d: [x.edge for x in by_rule(d, "forward-parallelism")]
      == ["collection -> fwd"])
def _(N):
    env = N.Env()
    src = env.from_collection([1, 2, 3])
    env.graph.add("fwd", lambda: N.MapOperator("fwd", _id_map(N)), 4,
                  inputs=[N.Edge(src.transformation, N.Forward())])
    return env


@plan("keyed-parallelism-bound",
      check=lambda d: ["max_parallelism 2" in x.message
                       for x in by_rule(d, "keyed-parallelism-bound")] == [True])
def _(N):
    env = N.Env()
    env.configure(max_parallelism=2)
    env.from_collection([1, 2, 3]).key_by(lambda v: v).process(_proc(N), parallelism=3)
    return env


@plan("keyed-parallelism-bound-bare", config=False,
      check=lambda d: by_rule(d, "keyed-parallelism-bound") == [])
def _(N):
    return PLANS["keyed-parallelism-bound"][0](N)


@plan("gang-parallelism-and-missing-mesh",
      check=lambda d: any("parallelism 2" in x.message for x in by_rule(d, "mesh-divisibility"))
      and any("set_mesh" in x.message for x in by_rule(d, "mesh-divisibility")))
def _(N):
    env = N.Env(parallelism=2)
    (env.from_collection([1, 2, 3], schema=f32(N)).count_window(4)
        .apply(_jit_window(N, gang_batch=4), name="gang", parallelism=2))
    return env


@plan("mesh-divisibility",
      check=lambda d: ["does not divide" in x.message
                       for x in by_rule(d, "mesh-divisibility")] == [True])
def _(N):
    env = N.Env()
    env.set_mesh(_FakeMesh({"data": 3}))
    (env.from_collection([1, 2, 3], schema=f32(N)).count_window(4)
        .apply(_jit_window(N, gang_batch=4), name="gang"))
    return env


@plan("mesh-divisibility-clean", check=lambda d: by_rule(d, "mesh-divisibility") == [])
def _(N):
    env = N.Env()
    env.set_mesh(_FakeMesh({"data": 4}))
    (env.from_collection([1, 2, 3], schema=f32(N)).count_window(4)
        .apply(_jit_window(N, gang_batch=4), name="gang"))
    return env


@plan("dynamic-jit-boundary-unbucketed", config=False,
      check=lambda d: [x.severity.name for x in by_rule(d, "dynamic-jit-boundary")] == ["ERROR"]
      and "tokens" in by_rule(d, "dynamic-jit-boundary")[0].message)
def _(N):
    env = N.Env()
    dyn = N.RecordSchema({"tokens": N.spec((None,), np.int32)})
    env.from_collection([1], schema=dyn).count_window(4).apply(_jit_window(N), name="jit")
    return env


@plan("dynamic-jit-boundary-bucketed", config=False,
      check=lambda d: [x.severity.name for x in by_rule(d, "dynamic-jit-boundary")] == ["INFO"])
def _(N):
    env = N.Env()
    dyn = N.RecordSchema({"tokens": N.spec((None,), np.int32)})
    policy = N.BucketPolicy(lengths=N.BucketLadder([64, 128]))
    env.from_collection([1], schema=dyn).count_window(4).apply(_jit_window(N, policy), name="jit")
    return env


@plan("recompile-churn-mixed-signatures", config=False,
      check=lambda d: ["2 distinct schema signatures" in x.message
                       for x in by_rule(d, "recompile-churn")] == [True])
def _(N):
    env = N.Env()
    a = env.from_collection([1], schema=f32(N), name="a")
    b = env.from_collection([2], schema=i32(N), name="b")
    (a.union(b).count_window(4)
        .apply(_jit_window(N, N.BucketPolicy(fixed_batch=4)), name="jit"))
    return env


@plan("recompile-churn-window-without-policy", config=False,
      check=lambda d: ["no batch-bucket policy" in x.message
                       for x in by_rule(d, "recompile-churn")] == [True])
def _(N):
    env = N.Env()
    (env.from_collection([1], schema=f32(N)).count_window(4, timeout_s=0.1)
        .apply(_jit_window(N), name="jit"))
    return env


@plan("source-schema-unknown", config=False,
      check=lambda d: [x.severity.name for x in by_rule(d, "source-schema-unknown")] == ["INFO"])
def _(N):
    env = N.Env()
    env.from_collection([1, 2, 3]).map(_id_map(N)).sink_to_list()
    return env


# -- TestSchemaPropagation --------------------------------------------------

def _lenet_pipeline(N, source_dtype=np.float32, map_hook=None):
    env = N.Env()
    schema = N.RecordSchema({"image": N.spec((28, 28, 1), source_dtype)})
    (env.from_collection([], schema=schema)
        .map(_id_map(N), name="preprocess", output_schema=map_hook or (lambda s: s))
        .count_window(8, timeout_s=0.02)
        .apply(N.ModelWindowFunction(_models(N).lenet), name="lenet")
        .sink_to_list())
    return env


@plan("lenet-clean-chain", check=lambda d: errors(d) == [])
def _(N):
    return _lenet_pipeline(N)


@plan("lenet-dtype-mismatch",
      check=lambda d: [(x.rule, x.edge) for x in errors(d)]
      == [("schema-mismatch", "preprocess -> lenet")]
      and "dtype" in errors(d)[0].message and "image" in errors(d)[0].message)
def _(N):
    return _lenet_pipeline(N, source_dtype=np.uint8)


@plan("lenet-map-hook-converts", config=False, check=lambda d: errors(d) == [])
def _(N):
    def to_f32(s):
        return N.RecordSchema({n: N.spec(s[n].shape, np.float32) for n in s.names})
    return _lenet_pipeline(N, source_dtype=np.uint8, map_hook=to_f32)


@plan("lenet-rank-mismatch", config=False,
      check=lambda d: len(errors(d)) == 1 and "rank" in errors(d)[0].message)
def _(N):
    env = N.Env()
    schema = N.RecordSchema({"image": N.spec((28, 28), np.float32)})
    (env.from_collection([], schema=schema).count_window(8)
        .apply(N.ModelWindowFunction(_models(N).lenet), name="lenet"))
    return env


@plan("lenet-missing-field", config=False,
      check=lambda d: len(errors(d)) == 1 and "missing field" in errors(d)[0].message)
def _(N):
    env = N.Env()
    schema = N.RecordSchema({"pixels": N.spec((28, 28, 1), np.float32)})
    (env.from_collection([], schema=schema).count_window(8)
        .apply(N.ModelWindowFunction(_models(N).lenet), name="lenet"))
    return env


@plan("train-schema-mismatch", config=False,
      check=lambda d: [x.edge for x in errors(d)] == ["collection -> train"]
      and "cat" in errors(d)[0].message)
def _(N):
    mdef = N.get_model_def("widedeep", **WIDEDEEP_CFG)
    train_schema = N.RecordSchema({"wide": N.spec((4,)), "dense": N.spec((2,)),
                                   "cat": N.spec((2,), np.int32),
                                   "label": N.spec((), np.int32)})
    bad_source = N.RecordSchema({"wide": N.spec((4,)), "dense": N.spec((2,)),
                                 "cat": N.spec((2,), np.float32),
                                 "label": N.spec((), np.int32)})
    env = N.Env()
    (env.from_collection([], schema=bad_source).key_by(lambda r: 0)
        .process(N.OnlineTrainFunction(mdef, train_schema=train_schema), name="train"))
    return env


# -- TestServingLints ---------------------------------------------------------

def _requests(N):
    return [N.serving.GenerateRequest(session_id="a", prompt=np.ones((4,), np.int32))]


@plan("serving-clean-keyed",
      check=lambda d: not by_rule(d, "serving-unkeyed-input")
      and not by_rule(d, "serving-recompile-churn"))
def _(N):
    env = N.Env(parallelism=1)
    N.serving.continuous_batching(
        env.from_collection(_requests(N)).key_by(lambda r: r.session_id),
        _models(N).char, config=N.serving.ServingConfig(capacity=32)).sink_to_list()
    return env


@plan("serving-unkeyed-edge",
      check=lambda d: len(by_rule(d, "serving-unkeyed-input")) == 2
      and all(x.severity.name == "ERROR" for x in by_rule(d, "serving-unkeyed-input"))
      and any("Rebalance" in x.message for x in by_rule(d, "serving-unkeyed-input"))
      and any("key selector" in x.message for x in by_rule(d, "serving-unkeyed-input")))
def _(N):
    env = N.Env(parallelism=1)
    src = env.from_collection(_requests(N))
    model = _models(N).char
    # A hand-built plan bypassing continuous_batching: a rebalance edge and
    # no key selector.  The port's operator picks its device at open().
    kw = {} if N.jax else {"device_from_context": True}
    env.graph.add("serve", lambda: N.serving.ContinuousBatchingOperator(
        "serve", model, N.serving.ServingConfig(capacity=32), **kw), 1,
        inputs=[N.Edge(src.transformation, N.Rebalance())])
    return env


@plan("serving-padding-buckets-off",
      check=lambda d: [(x.severity.name, "padding_buckets" in x.message)
                       for x in by_rule(d, "serving-recompile-churn")] == [("WARN", True)])
def _(N):
    env = N.Env(parallelism=1)
    N.serving.continuous_batching(
        env.from_collection(_requests(N)).key_by(lambda r: r.session_id), _models(N).char,
        config=N.serving.ServingConfig(capacity=32, padding_buckets=False)).sink_to_list()
    return env


@plan("serving-fixed-window-baseline",
      check=lambda d: [x.node for x in by_rule(d, "serving-recompile-churn")] == ["fixed"])
def _(N):
    env = N.Env(parallelism=1)
    (env.from_collection(_requests(N)).count_window(4)
        .apply(N.serving.FixedWindowGenerateFunction(
            _models(N).char, N.serving.ServingConfig(capacity=32, padding_buckets=False)),
            name="fixed")
        .sink_to_list())
    return env


# -- TestKvPoolUndersizedLint -------------------------------------------------

def _kv_env(N, *, rate_hz=100.0, paced=True, **config):
    env = N.Env(parallelism=1)
    reqs = _requests(N)
    stream = (env.from_source(N.PacedSplitSource(reqs, rate_hz), name="paced") if paced
              else env.from_collection(reqs))
    N.serving.continuous_batching(stream.key_by(lambda r: r.session_id), _models(N).char,
                                  config=N.serving.ServingConfig(capacity=32, max_active_seqs=4,
                                                                 **config)).sink_to_list()
    return env


@plan("kv-open-loop-overrate-dense",
      check=lambda d: [(x.severity.name, "paged_kv" in x.message,
                        "4 admission slots" in x.message)
                       for x in by_rule(d, "kv-pool-undersized")] == [("WARN", True, True)])
def _(N):
    return _kv_env(N)


@plan("kv-paged-tiering-off",
      check=lambda d: ["tiering" in x.message for x in by_rule(d, "kv-pool-undersized")] == [True])
def _(N):
    return _kv_env(N, paged_kv=True, page_tokens=8, tiering=False)


@plan("kv-paged-tiered", check=lambda d: by_rule(d, "kv-pool-undersized") == [])
def _(N):
    return _kv_env(N, paged_kv=True, page_tokens=8)


@plan("kv-rate-within-bound", check=lambda d: by_rule(d, "kv-pool-undersized") == [])
def _(N):
    return _kv_env(N, rate_hz=2.0)


@plan("kv-closed-loop", check=lambda d: by_rule(d, "kv-pool-undersized") == [])
def _(N):
    return _kv_env(N, paced=False)


# -- TestWatermarkLints -------------------------------------------------------

@plan("event-time-window-without-assigner", config=False,
      check=lambda d: [(x.severity.name, x.node)
                       for x in by_rule(d, "watermark-missing-assigner")]
      == [("ERROR", "time_window")])
def _(N):
    env = N.Env()
    (env.from_collection([("k", 1.0)]).key_by(lambda e: e[0]).time_window(1.0)
        .apply(_count_window_fn(N)).sink_to_list())
    return env


@plan("session-window-without-assigner", config=False,
      check=lambda d: len(by_rule(d, "watermark-missing-assigner")) == 1)
def _(N):
    env = N.Env()
    (env.from_collection([("k", 1.0)]).key_by(lambda e: e[0]).session_window(1.0)
        .apply(_count_window_fn(N)).sink_to_list())
    return env


@plan("assigner-upstream", config=False,
      check=lambda d: by_rule(d, "watermark-missing-assigner") == [])
def _(N):
    env = N.Env()
    (env.from_collection([("k", 1.0)]).assign_timestamps(lambda e: e[1])
        .map(_id_map(N), name="hop").key_by(lambda e: e[0]).time_window(1.0)
        .apply(_count_window_fn(N)).sink_to_list())
    return env


@plan("fine-watermarks-into-async-map", config=False,
      check=lambda d: [(x.severity.name, x.node, "watermark_every >= 8" in x.message)
                       for x in by_rule(d, "watermark-async-flush")]
      == [("WARN", "asyncmap", True)])
def _(N):
    env = N.Env()
    (env.from_collection([1.0, 2.0]).assign_timestamps(lambda e: e, watermark_every=1)
        .map(_async_map(N), name="asyncmap").sink_to_list())
    return env


@plan("coarse-watermarks", config=False,
      check=lambda d: by_rule(d, "watermark-async-flush") == [])
def _(N):
    env = N.Env()
    (env.from_collection([1.0, 2.0]).assign_timestamps(lambda e: e, watermark_every=8)
        .map(_async_map(N), name="asyncmap").sink_to_list())
    return env


@plan("second-assigner-retimes", config=False,
      check=lambda d: by_rule(d, "watermark-async-flush") == [])
def _(N):
    env = N.Env()
    (env.from_collection([1.0, 2.0])
        .assign_timestamps(lambda e: e, watermark_every=1, name="fine")
        .assign_timestamps(lambda e: e, watermark_every=8, name="coarse")
        .map(_async_map(N), name="asyncmap").sink_to_list())
    return env


# -- TestShardingAxisLint -----------------------------------------------------

@plan("sharding-unknown-axis",
      check=lambda d: [(x.node, "model" in x.message) for x in errors(by_rule(d, "sharding-axis"))]
      == [("tp", True)])
def _(N):
    env = N.Env()
    env.set_mesh(_FakeMesh({"data": 4}))
    env.from_collection([1, 2, 3]).map(_annotated_map(N, ("model",)), name="tp").sink_to_list()
    return env


@plan("sharding-annotation-without-mesh",
      check=lambda d: any("no mesh" in x.message for x in by_rule(d, "sharding-axis")))
def _(N):
    env = N.Env()
    env.from_collection([1, 2, 3]).map(_annotated_map(N, ("data",)), name="dp").sink_to_list()
    return env


@plan("sharding-annotation-without-mesh-bare", config=False,
      check=lambda d: by_rule(d, "sharding-axis") == [])
def _(N):
    return PLANS["sharding-annotation-without-mesh"][0](N)


@plan("sharding-ragged-batch",
      check=lambda d: ["does not divide" in x.message
                       for x in errors(by_rule(d, "sharding-axis"))] == [True])
def _(N):
    env = N.Env()
    env.set_mesh(_FakeMesh({"data": 4}))
    (env.from_collection([1, 2, 3]).map(_annotated_map(N, ("data",), batch=6), name="ragged")
        .sink_to_list())
    return env


@plan("sharding-valid-annotation", check=lambda d: errors(by_rule(d, "sharding-axis")) == [])
def _(N):
    env = N.Env()
    env.set_mesh(_FakeMesh({"data": 4}))
    (env.from_collection([1, 2, 3]).map(_annotated_map(N, ("data",), batch=8), name="ok")
        .sink_to_list())
    return env


@plan("sharding-gang-errors-not-duplicated",
      check=lambda d: by_rule(d, "sharding-axis") == [] and by_rule(d, "mesh-divisibility"))
def _(N):
    env = N.Env()
    (env.from_collection([1, 2, 3], schema=f32(N)).count_window(4)
        .apply(_jit_window(N, gang_batch=4), name="gang"))
    return env


@plan("sharding-mismatched-forward-edge",
      check=lambda d: any(x.severity.name == "WARN" and "will not chain" in x.message
                          and x.edge == "up -> down" for x in by_rule(d, "sharding-axis")))
def _(N):
    env = N.Env()
    env.set_mesh(_FakeMesh({"data": 2, "model": 2}))
    (env.from_collection([1, 2, 3]).map(_annotated_map(N, ("data",)), name="up")
        .map(_annotated_map(N, ("model",)), name="down").sink_to_list())
    return env


# -- TestDeviceResidencyLint --------------------------------------------------

def _res_records(N, dim=4):
    return [N.TensorValue({"x": np.zeros(dim, np.float32)}, {"k": 0})]


@plan("residency-model-model-fused", config=False,
      check=lambda d: by_rule(d, "device-residency") == [])
def _(N):
    env = N.Env()
    model = _models(N).res
    (env.from_collection(_res_records(N))
        .map(N.ModelMapFunction(model, micro_batch=2), name="m1")
        .map(N.ModelMapFunction(model, micro_batch=2), name="m2").sink_to_list())
    return env


@plan("residency-host-map-sandwich", config=False,
      check=lambda d: any(x.severity.name == "WARN" and x.node == "hostmap"
                          and "mid-segment fetch" in x.message
                          for x in by_rule(d, "device-residency")))
def _(N):
    env = N.Env()
    model = _models(N).res
    (env.from_collection(_res_records(N))
        .map(N.ModelMapFunction(model, micro_batch=2), name="m1")
        .map(_id_map(N), name="hostmap")
        .map(N.ModelMapFunction(model, micro_batch=2), name="m2").sink_to_list())
    return env


@plan("residency-keyed-edge-cut", config=False,
      check=lambda d: by_rule(d, "device-residency")
      and all(x.severity.name == "INFO" for x in by_rule(d, "device-residency")))
def _(N):
    env = N.Env()
    model = _models(N).res
    (env.from_collection(_res_records(N))
        .map(N.ModelMapFunction(model, micro_batch=2), name="m1")
        .key_by(lambda r: r.meta.get("k", 0)).count_window(2)
        .apply(N.ModelWindowFunction(model, policy=N.BucketPolicy(fixed_batch=2)), name="m2")
        .sink_to_list())
    return env


@plan("residency-unfused-forward-edge", config=False,
      check=lambda d: any(x.severity.name == "WARN" and x.edge == "m1 -> m2"
                          for x in by_rule(d, "device-residency")))
def _(N):
    env = N.Env()
    model = _models(N).res
    (env.from_collection(_res_records(N))
        .map(N.ModelMapFunction(model, micro_batch=2), name="m1")
        .map(N.ModelMapFunction(model, micro_batch=2), name="m2").start_new_chain()
        .sink_to_list())
    return env


@plan("residency-off-in-config", check=lambda d: by_rule(d, "device-residency") == [])
def _(N):
    return PLANS["residency-host-map-sandwich"][0](N)


@plan("residency-on-in-config", check=lambda d: by_rule(d, "device-residency") != [])
def _(N):
    return PLANS["residency-host-map-sandwich"][0](N).configure(device_resident=True)


# -- TestFlowControlLint ------------------------------------------------------

def _dist(N, telemetry_interval_s=None):
    kw = {} if telemetry_interval_s is None else {"telemetry_interval_s": telemetry_interval_s}
    return N.DistributedConfig(0, 2, ("127.0.0.1:9001", "127.0.0.1:9002"), **kw)


def _fc_env(N, *, fc=False, dist=True, checkpoint=True, paced=True):
    env = N.Env(parallelism=1)
    env.configure(flow_control=fc)
    if dist:
        env.set_distributed(_dist(N))
    if checkpoint:
        env.enable_checkpointing("/tmp/fc-lint")
    stream = (env.from_source(N.PacedSplitSource([1, 2, 3], 100.0), name="paced") if paced
              else env.from_collection([1, 2, 3]))
    stream.map(lambda x: x, name="m").sink_to_callable(lambda v: None)
    return env


@plan("flow-control-off-open-loop-cohort",
      check=lambda d: [(x.severity.name, x.node, "credit window" in x.message)
                       for x in by_rule(d, "flow-control")] == [("WARN", "paced", True)])
def _(N):
    return _fc_env(N)


@plan("flow-control-on", check=lambda d: by_rule(d, "flow-control") == [])
def _(N):
    return _fc_env(N, fc=True)


@plan("flow-control-single-process", check=lambda d: by_rule(d, "flow-control") == [])
def _(N):
    return _fc_env(N, dist=False)


@plan("flow-control-uncheckpointed", check=lambda d: by_rule(d, "flow-control") == [])
def _(N):
    return _fc_env(N, checkpoint=False)


@plan("flow-control-closed-loop", check=lambda d: by_rule(d, "flow-control") == [])
def _(N):
    return _fc_env(N, paced=False)


@plan("flow-control-bare", config=False, check=lambda d: by_rule(d, "flow-control") == [])
def _(N):
    return _fc_env(N)


# -- TestSloUnmonitoredLint ---------------------------------------------------

def _slo_env(N, *, health=False, autoscale=False, telemetry=None):
    env = clean_env(N)
    if health:
        env.configure(health=N.HealthConfig(
            autoscale=N.AutoscaleConfig() if autoscale else None))
    if telemetry is not None:
        env.set_distributed(_dist(N, telemetry))
    return env


@plan("slo-health-on-dead-feed",
      check=lambda d: [("health evaluation" in x.message, "telemetry_interval_s" in x.message)
                       for x in by_rule(d, "slo-unmonitored")] == [(True, True)])
def _(N):
    return _slo_env(N, health=True, telemetry=0.0)


@plan("slo-autoscale-on-dead-feed",
      check=lambda d: ["autoscale actuator" in x.message
                       for x in by_rule(d, "slo-unmonitored")] == [True])
def _(N):
    return _slo_env(N, health=True, autoscale=True, telemetry=0.0)


@plan("slo-telemetry-on", check=lambda d: by_rule(d, "slo-unmonitored") == [])
def _(N):
    return _slo_env(N, health=True, autoscale=True, telemetry=2.0)


@plan("slo-single-process", check=lambda d: by_rule(d, "slo-unmonitored") == [])
def _(N):
    return _slo_env(N, health=True)


@plan("slo-without-health", check=lambda d: by_rule(d, "slo-unmonitored") == [])
def _(N):
    return _slo_env(N, telemetry=0.0)


@plan("slo-bare", config=False, check=lambda d: by_rule(d, "slo-unmonitored") == [])
def _(N):
    return _slo_env(N, health=True, telemetry=0.0)


# -- test_split_sources.py::TestSplitLint -------------------------------------

@plan("split-fewer-splits",
      check=lambda d: [(x.node, "2 split(s)" in x.message)
                       for x in by_rule(d, "source-split-parallelism")] == [("starved", True)])
def _(N):
    env = N.Env(parallelism=1)
    env.from_source(N.ReplaySplitSource(list(range(10)), num_splits=2), name="starved",
                    parallelism=4).sink_to_list()
    return env


@plan("split-covered", check=lambda d: by_rule(d, "source-split-parallelism") == [])
def _(N):
    env = N.Env(parallelism=1)
    env.from_source(N.ReplaySplitSource(list(range(10)), num_splits=4), name="ok",
                    parallelism=4).sink_to_list()
    env.from_collection([1, 2, 3], name="legacy").sink_to_list()
    return env


@plan("split-unbounded", check=lambda d: by_rule(d, "source-split-parallelism") == [])
def _(N):
    env = N.Env(parallelism=1)
    env.from_source(N.PacedSplitSource(list(range(4)), 100.0, num_splits=1, cycles=None),
                    name="open", parallelism=4).sink_to_list()
    return env


# -- test_cohort_telemetry.py::TestCohortTelemetryLint ------------------------

def _telemetry_env(N, *, telemetry=None, rate_hz=None, **config):
    env = N.Env().configure(trace=True, **config)
    if telemetry is not None:
        env.set_distributed(_dist(N, telemetry))
    stream = (env.from_collection([1, 2, 3]) if rate_hz is None
              else env.from_source(N.PacedSplitSource([1, 2, 3], rate_hz), name="paced"))
    stream.map(lambda x: x, name="m").sink_to_callable(lambda v: None)
    return env


@plan("telemetry-off-under-tracing",
      check=lambda d: ["telemetry_interval_s" in x.message
                       for x in by_rule(d, "cohort-telemetry")] == [True])
def _(N):
    return _telemetry_env(N, telemetry=0.0)


@plan("telemetry-on", check=lambda d: by_rule(d, "cohort-telemetry") == [])
def _(N):
    return _telemetry_env(N, telemetry=2.0)


@plan("telemetry-single-process", check=lambda d: by_rule(d, "cohort-telemetry") == [])
def _(N):
    return _telemetry_env(N)


@plan("telemetry-full-rate-high-rate-open-loop",
      check=lambda d: ["trace_sample_rate" in x.message
                       for x in by_rule(d, "cohort-telemetry")] == [True])
def _(N):
    return _telemetry_env(N, telemetry=2.0, rate_hz=2000.0, trace_sample_rate=1.0)


@plan("telemetry-sampled", check=lambda d: by_rule(d, "cohort-telemetry") == [])
def _(N):
    return _telemetry_env(N, telemetry=2.0, rate_hz=2000.0, trace_sample_rate=0.01)


# -- test_sanitizer.py::TestReplayPurityLint ----------------------------------

_SCAN_GLOBAL = 0


def _impure_keyed(N):
    class ImpureKeyedFn(N.fn.ProcessFunction):
        def process_element(self, value, ctx, out):
            out.collect((value, time.time(), random.random()))
    return ImpureKeyedFn()


def _io_keyed(N):
    class IOKeyedFn(N.fn.ProcessFunction):
        def process_element(self, value, ctx, out):
            with open("/tmp/never-written", "a") as f:  # noqa: F841
                pass
            out.collect(value)
    return IOKeyedFn()


def _global_mut(N):
    class GlobalMutFn(N.fn.MapFunction):
        def map(self, value):
            global _SCAN_GLOBAL
            _SCAN_GLOBAL += 1
            return value
    return GlobalMutFn()


@plan("purity-keyed-impurity",
      check=lambda d: errors(by_rule(d, "replay-purity"))
      and all(x.node == "keyed_impure" for x in errors(by_rule(d, "replay-purity")))
      and "time.time" in " | ".join(x.message for x in errors(by_rule(d, "replay-purity")))
      and "random.random" in " | ".join(x.message for x in errors(by_rule(d, "replay-purity"))))
def _(N):
    env = N.Env()
    env.from_collection([1, 2, 3]).key_by(lambda v: v).process(_impure_keyed(N),
                                                              name="keyed_impure")
    return env


@plan("purity-keyed-io",
      check=lambda d: errors(by_rule(d, "replay-purity"))
      and "open" in errors(by_rule(d, "replay-purity"))[0].message)
def _(N):
    env = N.Env()
    env.from_collection([1, 2, 3]).key_by(lambda v: v).process(_io_keyed(N), name="keyed_io")
    return env


@plan("purity-nonkeyed-is-warn",
      check=lambda d: by_rule(d, "replay-purity")
      and all(x.severity.name == "WARN" for x in by_rule(d, "replay-purity"))
      and by_rule(d, "replay-purity")[0].node == "wallclock_map")
def _(N):
    env = N.Env()
    env.from_collection([1, 2, 3]).map(lambda v: (v, time.time()), name="wallclock_map")
    return env


@plan("purity-global-mutation",
      check=lambda d: any("global _SCAN_GLOBAL" in x.message for x in by_rule(d, "replay-purity")))
def _(N):
    env = N.Env()
    env.from_collection([1, 2, 3]).map(_global_mut(N), name="gmut")
    return env


@plan("purity-mutable-closure",
      check=lambda d: any("closure 'acc'" in x.message for x in by_rule(d, "replay-purity"))
      and all(x.severity.name == "WARN" for x in by_rule(d, "replay-purity")))
def _(N):
    env = N.Env()
    acc = []
    env.from_collection([1, 2, 3]).map(lambda v: acc.append(v) or v, name="closure_map")
    return env


@plan("purity-pure", check=lambda d: by_rule(d, "replay-purity") == [])
def _(N):
    env = N.Env()
    (env.from_collection([1, 2, 3]).map(lambda v: v * 2, name="pure")
        .filter(lambda v: v > 2, name="flt"))
    return env


@plan("purity-seeded-rng", check=lambda d: by_rule(d, "replay-purity") == [])
def _(N):
    env = N.Env()

    def seeded(v):
        rng = np.random.RandomState(0)
        return v + float(rng.rand())

    env.from_collection([1, 2, 3]).map(seeded, name="seeded")
    return env


# -- test_sanitizer.py::TestLegacySourceTimerChainLint ------------------------

def _sum_window(N):
    class SumWindow(N.fn.WindowFunction):
        def process_window(self, key, window, elements, out):
            out.collect(sum(elements))
    return SumWindow()


@plan("legacy-source-before-timer-op",
      check=lambda d: [(x.severity.name, "SplitSource" in x.message, x.edge)
                       for x in by_rule(d, "legacy-source-timer-chain")]
      == [("WARN", True, "pre -> timed")])
def _(N):
    env = N.Env(parallelism=1)
    (env.from_collection(list(range(32)), parallelism=1)
        .map(lambda x: x, name="pre", parallelism=1)
        .count_window(4, timeout_s=1.0).apply(_sum_window(N), name="timed", parallelism=1))
    return env


@plan("split-source-head-quiet", check=lambda d: by_rule(d, "legacy-source-timer-chain") == [])
def _(N):
    env = N.Env(parallelism=1)
    (env.from_source(N.ReplaySplitSource(list(range(32)), num_splits=4), name="split",
                     parallelism=1)
        .count_window(4, timeout_s=1.0).apply(_sum_window(N), name="timed", parallelism=1))
    return env


@plan("pure-count-window-quiet",
      check=lambda d: by_rule(d, "legacy-source-timer-chain") == [])
def _(N):
    env = N.Env(parallelism=1)
    (env.from_collection(list(range(32)), parallelism=1).count_window(4)
        .apply(_sum_window(N), name="counted", parallelism=1))
    return env


# ---------------------------------------------------------------------------
# the comparisons
# ---------------------------------------------------------------------------

def _key(diags, *, reference: bool):
    """``(rule, severity, node, edge)`` per diagnostic; of the reference's,
    those of rules the port registers (all of them, shardcheck's and
    statecheck's included) and of the analyzer core."""
    return [(d.rule, d.severity.name, d.node, d.edge) for d in diags
            if not reference or d.rule in RULES or d.rule in CORE_RULES]


def _schemas(propagate, instantiate, env):
    order = env.graph.topological_order()
    operators, _ = instantiate(env.graph)
    flow = propagate(env.graph, order, operators)
    names = {t.id: t.name for t in order}

    def spelled(s):
        return None if s is None else {n: (tuple(s[n].shape), str(s[n].dtype)) for n in s.names}

    return {names[tid]: [spelled(s) for s in sets] for tid, sets in flow.out_sets.items()}


def test_the_registry_holds_the_reference_rules_in_order():
    from flink_tensorflow_tpu.analysis.rules import RULES as JRULES

    assert [(r.id, r.severity.name) for r in RULES.values()] == REFERENCE_RULES
    assert [(r.id, r.severity.name) for r in JRULES.values()] == REFERENCE_RULES


@pytest.mark.parametrize("name", sorted(PLANS))
def test_both_packages_give_the_same_diagnostics_and_schemas(name):
    make, use_config, check = PLANS[name]
    jenv, penv = make(J), make(P)
    jdiags = janalyzer.analyze(jenv.graph, config=jenv.config if use_config else None)
    pdiags = ppkg.analysis.analyze(penv.graph, config=penv.config if use_config else None)
    assert _key(pdiags, reference=False) == _key(jdiags, reference=True)
    assert (_schemas(ppropagate, p_instantiate, penv)
            == _schemas(jpropagate, janalyzer._instantiate, jenv))
    if check is not None:
        assert check(pdiags), ppkg.analysis.format_diagnostics(pdiags)


def test_the_model_function_derives_its_output_schema_on_meta_tensors():
    """The derived schema (a LeNet method run on meta tensors) equals the
    reference's ``jax.eval_shape`` one, field for field."""
    jfn = J.ModelWindowFunction(_models(J).lenet)
    pfn = P.ModelWindowFunction(_models(P).lenet)
    want = jfn.output_schema(None)
    got = pfn.output_schema(None)
    assert got is not None and got.names == want.names
    assert all(got[n].shape == want[n].shape and got[n].dtype == want[n].dtype
               for n in want.names)
    assert pfn.plan_policy().fixed_batch == jfn.plan_policy().fixed_batch
    assert pfn.is_jit_boundary and pfn.plan_input_schema() == P.RecordSchema(
        {"image": P.spec((28, 28, 1), np.float32)})


def test_a_cycle_is_the_sole_diagnostic():
    from flink_tensorflow_tpu_torch.core.graph import DataflowGraph

    for N, analyze, graph_cls in ((J, janalyzer.analyze, jpkg.core.graph.DataflowGraph),
                                  (P, ppkg.analysis.analyze, DataflowGraph)):
        g = graph_cls()
        b = g.add("b", lambda: None, 1)
        c = g.add("c", lambda: None, 1)
        b.inputs.append(N.Edge(c, N.Rebalance()))
        c.inputs.append(N.Edge(b, N.Rebalance()))
        diags = analyze(g)
        assert [(d.rule, d.severity.name) for d in diags] == [("cycle", "ERROR")]


# -- TestValidateGate -----------------------------------------------------------

def test_execute_validate_true_raises_before_running():
    env = P.Env()
    env.graph.add("orphan", lambda: P.MapOperator("orphan", _id_map(P)), 1)
    with pytest.raises(PlanValidationError) as exc:
        env.execute("bad", validate=True)
    assert any(d.rule == "dangling-root" for d in exc.value.diagnostics)
    with pytest.raises(PlanValidationError):
        env.execute_async("bad", validate=True)


def test_execute_validate_true_clean_job_runs():
    env = P.Env()
    out = (env.from_collection([1, 2, 3], schema=f32(P))
           .map(_id_map(P), output_schema=lambda s: s).sink_to_list())
    env.execute("good", validate=True, timeout=60)
    assert sorted(out) == [1, 2, 3]


def test_validate_plan_returns_diagnostics_without_raising():
    env = P.Env()
    env.from_collection([1]).sink_to_list()
    diags = env.validate_plan(raise_on_error=False)
    assert all(d.severity.name != "ERROR" for d in diags)
    assert [d.rule for d in diags] == ["source-schema-unknown"]


# -- the CLI ----------------------------------------------------------------------

PIPELINE = '''
import numpy as np
from {pkg} import StreamExecutionEnvironment
from {pkg}.tensors.schema import RecordSchema, spec


def main(argv):
    env = StreamExecutionEnvironment()
    schema = RecordSchema({{"x": spec((4,), np.float32)}})
    env.from_collection([1, 2, 3], schema=schema).map(lambda v: v, name="m").sink_to_list()
    {extra}
    env.execute("cli")
'''
ORPHAN = 'env.graph.add("orphan", lambda: None, 1)'


def _write(tmp_path, pkg, tag, extra=""):
    path = tmp_path / f"{tag}_{pkg}.py"
    path.write_text(PIPELINE.format(pkg=pkg, extra=extra))
    return str(path)


def _cli_json(cli, paths, capsys):
    code = cli.main([*paths, "--json"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    return code, lines


def test_the_cli_gives_the_reference_exit_codes_and_json(tmp_path, capsys):
    runs = {}
    for pkg, cli in (("flink_tensorflow_tpu", jcli), ("flink_tensorflow_tpu_torch", pcli)):
        clean = _write(tmp_path, pkg, "clean")
        bad = _write(tmp_path, pkg, "bad", ORPHAN)
        runs[pkg] = (_cli_json(cli, [clean], capsys), _cli_json(cli, [clean, bad], capsys),
                     cli.main([str(tmp_path / "does_not_exist.py")]))
    (jclean, jbad, jmissing), (pclean, pbad, pmissing) = runs.values()
    assert (pclean[0], pbad[0], pmissing) == (jclean[0], jbad[0], jmissing) == (0, 1, 2)
    for (_, jl), (_, pl) in ((jclean, pclean), (jbad, pbad)):
        assert [sorted(x) for x in pl] == [sorted(x) for x in jl]
        for jx, px in zip(jl, pl):
            assert (px["operators"], px["chains"], px["chained_edges"]) == (
                jx["operators"], jx["chains"], jx["chained_edges"])
            key = [(d["rule"], d["severity"], d["node"], d["edge"]) for d in px["diagnostics"]]
            assert key == [(d["rule"], d["severity"], d["node"], d["edge"])
                           for d in jx["diagnostics"]
                           if d["rule"] in RULES or d["rule"] in CORE_RULES]


def test_the_cli_runs_as_a_module(tmp_path):
    path = _write(tmp_path, "flink_tensorflow_tpu_torch", "bad", ORPHAN)
    proc = subprocess.run([sys.executable, "-m", "flink_tensorflow_tpu_torch.analysis", path],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "ERROR [dangling-root] orphan" in proc.stdout
    assert "chain [x1" in proc.stdout
