"""The port's statecheck held to ``flink_tensorflow_tpu.analysis.statecheck``.

Every test of ``tests/test_statecheck.py`` has a twin here.  A static twin
builds the same plan in both packages (the user functions are the same
code on each package's base classes; where the reference's draws from
``jax.random``, the port's from ``parallel.dp.fold_in`` and a
``torch.Generator``) and holds the statecheck findings equal by ``(rule,
severity, node, edge)`` and by the facts in their messages (symbol names,
paths, dtypes, MiB), then runs the reference test's assertions on the
port's.  An optimizer moment's path in optax's state carries the chain's
index (``0/mu/wo``), the port's adam state does not (``mu/wo``); the
facts are compared with that prefix dropped.  Where the reference test
declares ``parallel.abstract_mesh`` (which raises under the installed
jax), the reference runs on a concrete ``make_mesh`` over conftest's
virtual CPU devices and the port on its shape-only ``abstract_mesh``.

The runtime halves (closure state applied twice on replay, a global RNG
diverging after a restore, a momentum reset, records lost behind a
non-replayable source) run the port's runtime on the CPU.

Port-only cases: a torch sampler on the process-global generator (and
the same call given ``generator=``), ``torch.manual_seed`` and
``<generator>.manual_seed(<a constant>)`` on the record path, a closure
over a ``torch.Tensor``, ``adam(mu_dtype=...)`` against optax, and the
delivery attributes of the file source and sinks.  The closure over a
``cuda:0`` tensor is ``tests/test_torch_statecheck_cuda.py``.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import re
import sys
import time
import types

import numpy as np
import pytest
import torch

pytest.importorskip("flax")

import jax
import jax.numpy as jnp
import optax

import flink_tensorflow_tpu as jpkg
import flink_tensorflow_tpu.serving as jserving
from flink_tensorflow_tpu.analysis import analyze as janalyze
from flink_tensorflow_tpu.analysis import statecheck as jstate
from flink_tensorflow_tpu.analysis.sanitizer import scan_code as jscan_code
from flink_tensorflow_tpu.core import functions as jfn
from flink_tensorflow_tpu.core.autoscale import AutoscaleConfig as JAutoscale
from flink_tensorflow_tpu.core.state import StateDescriptor as JSD
from flink_tensorflow_tpu.functions import DPTrainWindowFunction as JDP
from flink_tensorflow_tpu.functions import OnlineTrainFunction as JOnline
from flink_tensorflow_tpu.io import files as jfiles
from flink_tensorflow_tpu.metrics.health import HealthConfig as JHealth
from flink_tensorflow_tpu.models import ModelDef as JModelDef
from flink_tensorflow_tpu.models import get_model_def as jget
from flink_tensorflow_tpu.parallel import make_mesh as jmake_mesh
from flink_tensorflow_tpu.sources import FileSplitSource as JFileSplit
from flink_tensorflow_tpu.tensors import RecordSchema as JSchema
from flink_tensorflow_tpu.tensors import TensorValue as JTV
from flink_tensorflow_tpu.tensors import spec as jspec
import flink_tensorflow_tpu_torch as ppkg
import flink_tensorflow_tpu_torch.serving as pserving
from flink_tensorflow_tpu_torch import RestartStrategy
from flink_tensorflow_tpu_torch.analysis import SpecLayout, analyze, statecheck
from flink_tensorflow_tpu_torch.analysis.sanitizer import scan_code
from flink_tensorflow_tpu_torch.core import functions as pfn
from flink_tensorflow_tpu_torch.core.autoscale import AutoscaleConfig
from flink_tensorflow_tpu_torch.core.state import StateDescriptor
from flink_tensorflow_tpu_torch.functions.training_function import (
    DPTrainWindowFunction,
    OnlineTrainFunction,
)
from flink_tensorflow_tpu_torch.io import files as pfiles
from flink_tensorflow_tpu_torch.metrics.health import HealthConfig
from flink_tensorflow_tpu_torch.models.zoo.registry import ModelDef, get_model_def
from flink_tensorflow_tpu_torch.parallel import dp, optim
from flink_tensorflow_tpu_torch.parallel.mesh import abstract_mesh
from flink_tensorflow_tpu_torch.sources import FileSplitSource
from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, spec
from flink_tensorflow_tpu_torch.tensors.value import TensorValue

J = types.SimpleNamespace(
    jax=True, Env=jpkg.StreamExecutionEnvironment, analyze=janalyze, fn=jfn, SD=JSD,
    Online=JOnline, DP=JDP, files=jfiles, FileSplit=JFileSplit, serving=jserving,
    Health=JHealth, Autoscale=JAutoscale, SpecLayout=jstate.SpecLayout, TV=JTV,
    scan_code=jscan_code, sgd=optax.sgd, adam=optax.adam)
P = types.SimpleNamespace(
    jax=False, Env=ppkg.StreamExecutionEnvironment, analyze=analyze, fn=pfn,
    SD=StateDescriptor, Online=OnlineTrainFunction, DP=DPTrainWindowFunction, files=pfiles,
    FileSplit=FileSplitSource, serving=pserving, Health=HealthConfig,
    Autoscale=AutoscaleConfig, SpecLayout=SpecLayout, TV=TensorValue, scan_code=scan_code,
    sgd=optim.sgd, adam=optim.adam)

STATE_RULES = ("statecheck", "exactly-once-boundary")


def by_rule(diags, rule):
    return [d for d in diags if d.rule == rule]


def errors(diags):
    return [d for d in diags if d.severity.name == "ERROR"]


def keys(diags):
    return sorted((d.rule, d.severity.name, d.node, d.edge) for d in diags)


#: Facts a message carries: quoted names and paths, axis tuples, sizes,
#: MiB figures, dtypes, key-group counts; an optax moment path loses its
#: chain index.
_FACTS = re.compile(r"\((?:'[\w-]*',? ?|None,? ?)+\)|'[\w./-]*'|[0-9.]+ ?MiB"
                    r"|\b(?:b?float|u?int)[0-9]+\b|[0-9]+ (?:pages|key groups)|p′=[0-9]+"
                    r"|page_tokens=[0-9]+|global_batch [0-9]+")


def facts(message):
    return [f.replace("'0/", "'") for f in _FACTS.findall(message)]


def state_diags(env, N, config=True):
    return [d for d in N.analyze(env.graph, config=env.config if config else None)
            if d.rule.startswith(STATE_RULES)]


def twin(build, config=True):
    """``build(N) -> env`` in both packages; the statecheck findings of
    each, held equal by key and by the facts in their messages."""
    jd, pd = (state_diags(build(N), N, config) for N in (J, P))
    assert keys(pd) == keys(jd)
    jmsg = {}
    for d in jd:
        jmsg.setdefault((d.rule, d.severity.name, d.node, d.edge), []).append(facts(d.message))
    for d in pd:
        assert facts(d.message) in jmsg[(d.rule, d.severity.name, d.node, d.edge)], d.message
    return jd, pd


def run_with_restart(env, *, max_restarts=2):
    return env.execute(timeout=120, restart_strategy=RestartStrategy(max_restarts=max_restarts))


# ---------------------------------------------------------------------------
# defect 1 — a closure-captured TrainState (hidden state)
# ---------------------------------------------------------------------------


def make_closure_step(train_state, crash_at, crashed_box):
    """The seeded defect: a map whose closure captures a TrainState-shaped
    dict and mutates it per record — state the barriers never see."""

    def step(value):
        if (crash_at is not None and not crashed_box[0]
                and train_state["opt_state"]["count"] >= crash_at):
            crashed_box[0] = True
            raise RuntimeError("injected failure")
        train_state["opt_state"]["count"] += 1
        train_state["variables"]["w"] += float(value)
        return value

    return step


class TestClosureTrainStateDefect:
    N = 80

    def build(self, N, tmp_path, tag, crash):
        train_state = {"variables": {"w": 0.0}, "opt_state": {"count": 0}}
        crashed = [False] if crash else [True]
        env = N.Env(parallelism=1)
        env.enable_checkpointing(str(tmp_path / f"chk-{tag}-{N.jax}"), every_n_records=20)
        (env.from_collection(list(range(self.N)))
            .map(make_closure_step(train_state, 50 if crash else None, crashed),
                 name="closure_step")
            .sink_to_list())
        return env, train_state

    def test_runtime_replay_double_applies_closure_state(self, tmp_path):
        env, clean = self.build(P, tmp_path, "clean", crash=False)
        env.execute(timeout=120)
        assert clean["opt_state"]["count"] == self.N
        env, crashed = self.build(P, tmp_path, "crash", crash=True)
        assert run_with_restart(env).restarts == 1
        # The checkpoint rewound every DECLARED state; the closure dict
        # kept its count, so replayed records applied a second time.
        assert crashed["opt_state"]["count"] > self.N

    def test_static_hidden_state_error_with_provenance(self, tmp_path):
        for d in twin(lambda N: self.build(N, tmp_path, "static", crash=False)[0]):
            errs = errors(by_rule(d, "statecheck-hidden-state"))
            assert errs, "closure-captured TrainState must be an ERROR"
            assert errs[0].node == "closure_step"
            assert "train_state" in errs[0].message
            assert "TrainState" in errs[0].message


# ---------------------------------------------------------------------------
# defect 2 — constant seeds and process-global RNG streams
# ---------------------------------------------------------------------------


class _Crashing:
    """The crash-once bookkeeping the reference's functions share."""

    def __init__(self, crash_at=None, crashed_box=None):
        self.crash_at = crash_at
        self.crashed = crashed_box if crashed_box is not None else [True]
        self._seen = 0

    def clone(self):
        return type(self)(self.crash_at, self.crashed)

    def _tick(self):
        self._seen += 1
        if self.crash_at and not self.crashed[0] and self._seen >= self.crash_at:
            self.crashed[0] = True
            raise RuntimeError("injected failure")

    def snapshot_state(self):
        return {"seen": self._seen}

    def restore_state(self, state):
        self._seen = state["seen"]


def noisy_sum(N):
    """The seeded defect: a keyed running sum salted from the PROCESS-
    GLOBAL numpy RNG — replayed records draw different values."""

    class NoisySum(_Crashing, N.fn.ProcessFunction):
        def process_element(self, value, ctx, out):
            self._tick()
            total = ctx.state(self.SD("total", lambda: 0.0))
            total.update((total.value() or 0.0) + value + np.random.rand())
            out.collect((ctx.current_key, total.value()))

    NoisySum.SD = N.SD
    return NoisySum


def fold_sum(N):
    """The healthy twin: per-key randomness derives by folding keyed state
    (a per-key counter) into a seed, so replay re-samples the IDENTICAL
    continuation."""
    if N.jax:
        class FoldSum(_Crashing, jfn.ProcessFunction):
            def open(self, ctx):
                self._base = jax.random.PRNGKey(7)

            def process_element(self, value, ctx, out):
                self._tick()
                count = ctx.state(JSD("count", lambda: 0))
                total = ctx.state(JSD("total", lambda: 0.0))
                i = (count.value() or 0) + 1
                count.update(i)
                key = jax.random.fold_in(jax.random.fold_in(self._base, ctx.current_key), i)
                total.update((total.value() or 0.0) + value + float(jax.random.uniform(key)))
                out.collect((ctx.current_key, i, total.value()))
        return FoldSum

    class PortFoldSum(_Crashing, pfn.ProcessFunction):
        def open(self, ctx):
            self._base = 7

        def process_element(self, value, ctx, out):
            self._tick()
            count = ctx.state(StateDescriptor("count", lambda: 0))
            total = ctx.state(StateDescriptor("total", lambda: 0.0))
            i = (count.value() or 0) + 1
            count.update(i)
            seed = dp.fold_in(dp.fold_in(self._base, ctx.current_key), i)
            g = torch.Generator().manual_seed(seed)
            total.update((total.value() or 0.0) + value
                         + float(torch.rand((), generator=g)))
            out.collect((ctx.current_key, i, total.value()))
    return PortFoldSum


def final_by_key(out):
    final = {}
    for row in out:
        final[row[0]] = row[-1]
    return final


def keyed_plan(N, function, name="noisy_sum", n=8):
    env = N.Env(parallelism=1)
    (env.from_collection(list(range(n))).key_by(lambda x: x % 4)
        .process(function, name=name).sink_to_list())
    return env


class TestRngStreamDefect:
    N = 80

    def run(self, tmp_path, tag, make, crash):
        np.random.seed(1234)  # the same global stream for both runs
        crashed = [False] if crash else [True]
        f = make(P)(crash_at=50 if crash else None, crashed_box=crashed)
        env = P.Env(parallelism=1)
        env.enable_checkpointing(str(tmp_path / f"chk-{tag}"), every_n_records=20)
        out = (env.from_collection(list(range(self.N))).key_by(lambda x: x % 4)
               .process(f, name="noisy_sum").sink_to_list())
        result = run_with_restart(env) if crash else env.execute(timeout=120)
        return final_by_key(out), getattr(result, "restarts", 0)

    def test_runtime_global_rng_diverges_after_restore(self, tmp_path):
        clean, _ = self.run(tmp_path, "clean", noisy_sum, crash=False)
        crashed, restarts = self.run(tmp_path, "crash", noisy_sum, crash=True)
        assert restarts == 1
        # Replayed records drew from a further-advanced global stream.
        assert any(abs(clean[k] - crashed[k]) > 1e-9 for k in clean)

    def test_runtime_fold_in_resumes_identically(self, tmp_path):
        clean, _ = self.run(tmp_path, "fclean", fold_sum, crash=False)
        crashed, restarts = self.run(tmp_path, "fcrash", fold_sum, crash=True)
        assert restarts == 1
        assert clean == crashed

    def test_static_global_rng_is_error_on_keyed_path(self):
        for d in twin(lambda N: keyed_plan(N, noisy_sum(N)())):
            errs = errors(by_rule(d, "statecheck-rng-stream"))
            assert errs and errs[0].node == "noisy_sum"
            assert "np.random.rand" in errs[0].message
            assert "fold_in" in errs[0].message

    def test_static_fold_in_twin_is_clean(self):
        for d in twin(lambda N: keyed_plan(N, fold_sum(N)())):
            assert by_rule(d, "statecheck-rng-stream") == []

    def test_static_constant_reseed_in_record_path_flagged(self):
        class JReseed(jfn.MapFunction):
            def map(self, value):
                k = jax.random.PRNGKey(0)
                return float(jax.random.uniform(k)) + value

        class PReseed(pfn.MapFunction):
            def map(self, value):
                g = torch.Generator().manual_seed(0)
                return float(torch.rand((), generator=g)) + value

        def build(N):
            env = N.Env(parallelism=1)
            env.from_collection([1.0]).map((JReseed if N.jax else PReseed)(),
                                           name="reseed").sink_to_list()
            return env
        jd, pd = twin(build)
        for d, symbol in ((jd, "jax.random.PRNGKey"), (pd, "torch.Generator(...).manual_seed")):
            (d,) = by_rule(d, "statecheck-rng-stream")
            assert d.severity.name == "WARN"  # unkeyed: advisory
            assert symbol in d.message

    def test_static_seed_in_open_is_sanctioned(self):
        class JSeedInOpen(jfn.MapFunction):
            def open(self, ctx):
                self._key = jax.random.PRNGKey(3)

            def map(self, value):
                return value

        class PSeedInOpen(pfn.MapFunction):
            def open(self, ctx):
                self._gen = torch.Generator().manual_seed(3)
                torch.manual_seed(3)

            def map(self, value):
                return value

        def build(N):
            env = N.Env(parallelism=1)
            env.from_collection([1.0]).map((JSeedInOpen if N.jax else PSeedInOpen)()
                                           ).sink_to_list()
            return env
        for d in twin(build):
            assert by_rule(d, "statecheck-rng-stream") == []


# ---------------------------------------------------------------------------
# the port's torch RNG discipline (port-only cases)
# ---------------------------------------------------------------------------


class _Sampler(pfn.ProcessFunction):
    def process_element(self, value, ctx, out):
        out.collect(float(torch.randn(()) + value))


class _SamplerWithGenerator(pfn.ProcessFunction):
    def open(self, ctx):
        self.seed = 11

    def process_element(self, value, ctx, out):
        g = torch.Generator().manual_seed(dp.fold_in(self.seed, ctx.current_key))
        out.collect(float(torch.randn((), generator=g) + value))


class _ConstantGenerator(pfn.ProcessFunction):
    def process_element(self, value, ctx, out):
        g = torch.Generator().manual_seed(5)
        out.collect(float(torch.rand((), generator=g) + value))


class _GlobalReseed(pfn.ProcessFunction):
    def process_element(self, value, ctx, out):
        torch.manual_seed(0)
        out.collect(value)


class TestTorchRng:
    def rng(self, function):
        return by_rule(state_diags(keyed_plan(P, function), P), "statecheck-rng-stream")

    def test_torch_manual_seed_on_the_record_path_is_a_reseed(self):
        (d,) = self.rng(_GlobalReseed())
        assert d.severity.name == "ERROR"
        assert d.message.startswith("torch.manual_seed in _GlobalReseed.process_element:")

    def test_a_torch_sampler_on_the_global_generator_is_error_on_keyed_path(self):
        (d,) = self.rng(_Sampler())
        assert d.severity.name == "ERROR" and d.node == "noisy_sum"
        assert d.message.startswith("torch.randn in _Sampler.process_element:")

    def test_a_sampler_given_a_folded_generator_is_clean(self):
        assert self.rng(_SamplerWithGenerator()) == []

    def test_a_generator_seeded_with_a_constant_is_a_reseed(self):
        (d,) = self.rng(_ConstantGenerator())
        assert d.severity.name == "ERROR"
        assert d.message.startswith("torch.Generator(...).manual_seed in ")
        assert "re-seeds from a constant" in d.message

    def test_the_sanitizer_keeps_the_reference_s_classification(self):
        """The torch samplers are statecheck's alone: the purity scanner
        flags exactly what the reference's flags."""
        from flink_tensorflow_tpu.analysis.sanitizer import scan_callable as jscan
        from flink_tensorflow_tpu_torch.analysis.sanitizer import scan_callable as pscan

        def draws(x):
            return np.random.rand() + float(torch.rand(())) + x

        assert [(f.kind, f.symbol) for f in pscan(draws)] == \
            [(f.kind, f.symbol) for f in jscan(draws)] == [("unseeded-random", "np.random.rand")]


# ---------------------------------------------------------------------------
# defect 3 — a snapshot that omits the optimizer momentum
# ---------------------------------------------------------------------------


def mini_momentum(N):
    """The seeded defect: hand-rolled SGD with momentum whose snapshot
    covers the weights but NOT the momentum buffer."""
    if N.jax:
        class MiniMomentumTrain(_Crashing, jfn.ProcessFunction):
            def __init__(self, crash_at=None, crashed_box=None):
                super().__init__(crash_at, crashed_box)
                self._w = jnp.zeros((4,))
                self._m = jnp.zeros((4,))  # the hidden half of the train state

            def process_element(self, value, ctx, out):
                self._tick()
                grad = jnp.full((4,), float(value % 7) - 3.0)
                self._m = 0.9 * self._m + grad
                self._w = self._w - 0.1 * self._m
                out.collect(float(self._w[0]))

            def snapshot_state(self):
                return {"w": np.asarray(self._w), "seen": self._seen}

            def restore_state(self, state):
                self._w = jnp.asarray(state["w"])
                self._seen = state["seen"]
        return MiniMomentumTrain

    class MiniMomentumTrain(_Crashing, pfn.ProcessFunction):
        def __init__(self, crash_at=None, crashed_box=None):
            super().__init__(crash_at, crashed_box)
            self._w = torch.zeros((4,))
            self._m = torch.zeros((4,))  # the hidden half of the train state

        def process_element(self, value, ctx, out):
            self._tick()
            grad = torch.full((4,), float(value % 7) - 3.0)
            self._m = 0.9 * self._m + grad
            self._w = self._w - 0.1 * self._m
            out.collect(float(self._w[0]))

        def snapshot_state(self):
            return {"w": self._w.numpy().copy(), "seen": self._seen}

        def restore_state(self, state):
            self._w = torch.from_numpy(state["w"])
            self._seen = state["seen"]
    return MiniMomentumTrain


class TestTrainStateDefect:
    N = 80

    def run(self, tmp_path, tag, crash):
        crashed = [False] if crash else [True]
        f = mini_momentum(P)(crash_at=50 if crash else None, crashed_box=crashed)
        env = P.Env(parallelism=1)
        env.enable_checkpointing(str(tmp_path / f"chk-{tag}"), every_n_records=20)
        out = (env.from_collection(list(range(self.N))).key_by(lambda x: 0)
               .process(f, name="mini_train").sink_to_list())
        result = run_with_restart(env) if crash else env.execute(timeout=120)
        return [v for v in out if v is not None][-1], getattr(result, "restarts", 0)

    def test_runtime_momentum_reset_diverges(self, tmp_path):
        clean_w, _ = self.run(tmp_path, "clean", crash=False)
        crash_w, restarts = self.run(tmp_path, "crash", crash=True)
        assert restarts == 1
        assert abs(clean_w - crash_w) > 1e-9

    def test_static_snapshot_omitted_momentum_is_error(self):
        def build(N):
            env = N.Env(parallelism=1)
            (env.from_collection(list(range(8))).key_by(lambda x: 0)
                .process(mini_momentum(N)(), name="mini_train").sink_to_list())
            return env
        for d in twin(build):
            errs = errors(by_rule(d, "statecheck-hidden-state"))
            assert errs and errs[0].node == "mini_train"
            assert "self._m" in errs[0].message
            assert "snapshot-omitted" in errs[0].message
            assert not any("self._w" in x.message for x in errs)


# ---------------------------------------------------------------------------
# the train-state audit
# ---------------------------------------------------------------------------


class _Toy(torch.nn.Module):
    def __init__(self, shape):
        super().__init__()
        self.wo = torch.nn.Parameter(torch.zeros(shape))
        self.wi = torch.nn.Parameter(torch.zeros(shape[::-1]))


def toy_model_def(N, shape=(16, 8)):
    if N.jax:
        schema = JSchema({"x": jspec((shape[0],)), "label": jspec((), np.int32)})
        return JModelDef(
            architecture="toy", config={}, module=None, input_schema=schema, methods={},
            init_fn=lambda rng: {"params": {"wo": jnp.zeros(shape),
                                            "wi": jnp.zeros(shape[::-1])}},
            loss_fn=lambda params, batch: jnp.float32(0.0)), schema
    schema = RecordSchema({"x": spec((shape[0],)), "label": spec((), np.int32)})
    return ModelDef(
        architecture="toy", config={}, module=None, input_schema=schema, methods={},
        init_fn=lambda seed: _Toy(shape), make_module=lambda: _Toy(shape),
        loss_fn=lambda module, batch, gen: (torch.zeros(()), ({}, {}))), schema


@dataclasses.dataclass(frozen=True)
class _RenamedSlots:
    """An optimizer whose moment leaves lose their params' names."""

    def init(self, params):
        return {"slots": {"moment_a": torch.zeros((16, 8)), "moment_b": torch.zeros((8, 16))}}

    def update(self, grads, state, params=None):
        return grads, state


def train_plan(N, optimizer, *, model_shape=(16, 8), spec_layout=None, mesh_axes=None):
    mdef, schema = toy_model_def(N, model_shape)
    f = N.Online(mdef, optimizer, train_schema=schema)
    if spec_layout is not None:
        f.spec_layout = spec_layout
    env = N.Env(parallelism=1)
    if mesh_axes is not None:
        if N.jax:
            n = int(np.prod(list(mesh_axes.values())))
            env.set_mesh(jmake_mesh(mesh_axes, devices=jax.devices()[:n]))
        else:
            env.set_mesh(abstract_mesh(mesh_axes))
    recs = [N.TV({"x": np.zeros(model_shape[0], np.float32), "label": np.int32(0)},
                 meta={"k": 0})]
    (env.from_collection(recs, schema=schema).key_by(lambda r: r.meta["k"])
        .process(f, name="train").sink_to_list())
    return env


class TestTrainStateAudit:
    def train_state(self, build):
        return [by_rule(d, "statecheck-train-state") for d in twin(build)]

    def test_dtype_drift_between_params_and_moments_warns(self):
        for d in self.train_state(lambda N: train_plan(N, N.adam(
                1e-2, mu_dtype=jnp.bfloat16 if N.jax else torch.bfloat16))):
            drift = [x for x in d if "dtype drift" in x.message]
            assert drift and drift[0].severity.name == "WARN"
            assert "bfloat16" in drift[0].message

    def test_aligned_dtypes_stay_clean(self):
        for d in self.train_state(lambda N: train_plan(N, N.adam(1e-2))):
            assert [x for x in d if "dtype drift" in x.message] == []

    def test_moment_sharded_away_from_param_is_error(self):
        def build(N):
            if N.jax:
                opt = optax.GradientTransformation(
                    lambda params: {"slots": {"moment_a": jnp.zeros((16, 8)),
                                              "moment_b": jnp.zeros((8, 16))}},
                    lambda g, s, p=None: (g, s))
            else:
                opt = _RenamedSlots()
            return train_plan(N, opt, spec_layout=N.SpecLayout(fsdp_axis="fsdp", tp_axis="tp"),
                              mesh_axes={"fsdp": 2, "tp": 2})
        for d in self.train_state(build):
            errs = errors(d)
            assert errs and errs[0].node == "train"
            assert "slots/moment_a" in errs[0].message
            assert "params/wo" in errs[0].message

    def test_undonated_large_train_state_warns(self):
        for d in self.train_state(lambda N: train_plan(N, N.adam(1e-2),
                                                       model_shape=(1024, 512))):
            donate = [x for x in d if "not donated" in x.message]
            assert donate and donate[0].severity.name == "WARN"
            assert "12.0 MiB" in donate[0].message

    def test_small_train_state_donation_is_quiet(self):
        for d in self.train_state(lambda N: train_plan(N, N.adam(1e-2), model_shape=(8, 4))):
            assert [x for x in d if "not donated" in x.message] == []

    def test_the_trainers_declare_what_their_steps_do(self):
        """The online step returns a new state (the reference's undonated
        step); the gang updates its state in place (the reference donates
        it)."""
        assert OnlineTrainFunction.donates_train_state is JOnline.donates_train_state is False
        assert DPTrainWindowFunction.donates_train_state is JDP.donates_train_state is True

    @pytest.mark.parametrize("inplace", [False, True])
    def test_adam_mu_dtype_is_optax_s(self, inplace):
        """``adam(mu_dtype=bf16)`` stores the first moment in bf16, equal to
        optax's bit for bit, and steps as optax does (a moment computed
        otherwise, or b1 not rounded to bf16, moves the params by ~1e-5)."""
        rng = np.random.RandomState(0)
        params = {"w": rng.randn(5, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32)}
        grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
                 for _ in range(4)]
        jopt = optax.adam(1e-2, mu_dtype=jnp.bfloat16)
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        js = jopt.init(jp)
        popt = optim.adam(1e-2, mu_dtype=torch.bfloat16)
        pp = {k: torch.tensor(v) for k, v in params.items()}
        ps = popt.init(pp)
        for g in grads:
            updates, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
            jp = optax.apply_updates(jp, updates)
            tg = {k: torch.tensor(v) for k, v in g.items()}
            if inplace:
                popt.apply_(tg, ps, pp)
            else:
                updates, ps = popt.update(tg, ps, pp)
                pp = optim.apply_updates(pp, updates)
        for k in params:
            assert ps["mu"][k].dtype == torch.bfloat16
            np.testing.assert_array_equal(ps["mu"][k].float().numpy(),
                                          np.asarray(js[0].mu[k].astype(jnp.float32)))
            # f32 sums in another order (the port adds with alpha): an ulp.
            np.testing.assert_allclose(ps["nu"][k].numpy(), np.asarray(js[0].nu[k]), rtol=1e-6)
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]), rtol=1e-6)


# ---------------------------------------------------------------------------
# rescale safety
# ---------------------------------------------------------------------------


class TestRescaleSafety:
    def plan(self, N, tmp_path, *, scope="subtask", checkpoint=True, autoscale=False):
        mdef, schema = toy_model_def(N)
        env = N.Env(parallelism=1)
        if checkpoint:
            env.enable_checkpointing(str(tmp_path / "chk"), interval_s=10)
        if autoscale:
            env.config = dataclasses.replace(env.config,
                                             health=N.Health(autoscale=N.Autoscale()))
        recs = [N.TV({"x": np.zeros(16, np.float32), "label": np.int32(0)}, meta={"k": 0})]
        (env.from_collection(recs, schema=schema).key_by(lambda r: r.meta["k"])
            .process(N.Online(mdef, N.sgd(0.1), train_schema=schema, scope=scope),
                     name="train")
            .sink_to_list())
        return env

    def rescale(self, build):
        return [by_rule(d, "statecheck-rescale") for d in twin(build)]

    def test_subtask_scope_under_checkpoint_warns(self, tmp_path):
        for d in self.rescale(lambda N: self.plan(N, tmp_path)):
            assert d and d[0].severity.name == "WARN"
            assert "StateNotRescalable" in d[0].message

    def test_subtask_scope_under_autoscale_is_error(self, tmp_path):
        for d in self.rescale(lambda N: self.plan(N, tmp_path, autoscale=True)):
            errs = errors(d)
            assert errs and "health.autoscale" in errs[0].message

    def test_key_scope_redistributes_info_only(self, tmp_path):
        for d in self.rescale(lambda N: self.plan(N, tmp_path, scope="key")):
            assert d and all(x.severity.name == "INFO" for x in d)
            assert "key group" in d[0].message

    def gang_plan(self, N, global_batch):
        mdef, schema = toy_model_def(N)
        env = N.Env(parallelism=1)
        recs = [N.TV({"x": np.zeros(16, np.float32), "label": np.int32(0)}, meta={"k": 0})]
        (env.from_collection(recs, schema=schema).key_by(lambda r: 0)
            .count_window(global_batch)
            .apply(N.DP(mdef, N.sgd(0.1), train_schema=schema, global_batch=global_batch),
                   name="gang")
            .sink_to_list())
        return env

    def test_gang_ladder_indivisible_batch_warns(self):
        for d in self.rescale(lambda N: self.gang_plan(N, 24)):  # the p'=16 rung breaks
            bad = [x for x in d if "reshard ladder" in x.message
                   and x.severity.name == "WARN"]
            assert bad and "p′=16" in bad[0].message

    def test_gang_ladder_divisible_batch_is_info(self):
        for d in self.rescale(lambda N: self.gang_plan(N, 32)):
            assert d and all(x.severity.name == "INFO" for x in d)
            assert "divides cleanly" in d[0].message


# ---------------------------------------------------------------------------
# defect 4 — a non-replayable source into a non-idempotent sink
# ---------------------------------------------------------------------------


class _DestructiveSource:
    """The seeded defect: consumes a SHARED queue destructively (a live
    feed) — after a restore there is nothing left to rewind into."""

    replayable = False

    def __init__(self, queue):
        self.queue = queue

    def clone(self):
        return type(self)(self.queue)

    def run(self):
        while self.queue:
            yield self.queue.pop(0)


class _EffectSink:
    """A non-idempotent side-effect sink: every invoke APPENDS."""

    idempotent = False

    def __init__(self, box):
        self.box = box

    def clone(self):
        return type(self)(self.box)

    def invoke(self, value):
        self.box.append(value)


class _CrashMap:
    def __init__(self, crash_at, crashed_box):
        self.crash_at = crash_at
        self.crashed = crashed_box
        self._seen = 0

    def clone(self):
        return type(self)(self.crash_at, self.crashed)

    def map(self, value):
        self._seen += 1
        if not self.crashed[0] and self._seen >= self.crash_at:
            self.crashed[0] = True
            raise RuntimeError("injected failure")
        return value

    def snapshot_state(self):
        return {"seen": self._seen}

    def restore_state(self, state):
        self._seen = state["seen"]


def on(N, cls):
    """``cls`` on package ``N``'s base class (source, sink or map)."""
    base = {_DestructiveSource: N.fn.SourceFunction, _EffectSink: N.fn.SinkFunction,
            _CrashMap: N.fn.MapFunction}[cls]
    return type(cls.__name__.lstrip("_"), (cls, base), {})


class TestExactlyOncePath:
    N = 60

    def test_runtime_restore_loses_records(self, tmp_path):
        box, crashed = [], [False]
        env = P.Env(parallelism=1)
        env.enable_checkpointing(str(tmp_path / "chk"), every_n_records=20)
        (env.from_source(on(P, _DestructiveSource)(list(range(self.N))), name="live")
            .map(on(P, _CrashMap)(30, crashed), name="relay")
            .add_sink(on(P, _EffectSink)(box), name="effects"))
        assert run_with_restart(env).restarts == 1
        # The restored offset points into a stream that no longer exists.
        assert set(box) != set(range(self.N))
        assert len(set(box)) < self.N

    def plan(self, N, sink, tmp_path):
        env = N.Env(parallelism=1)
        env.enable_checkpointing(str(tmp_path / f"eob-{N.jax}"), interval_s=10)
        (env.from_source(on(N, _DestructiveSource)([1, 2, 3]), name="live")
            .map(lambda x: x + 1, name="relay")
            .add_sink(sink(N), name="effects"))
        return env

    def test_static_path_to_nonidempotent_sink_is_error(self, tmp_path):
        for d in twin(lambda N: self.plan(N, lambda N: on(N, _EffectSink)([]), tmp_path)):
            d = by_rule(d, "exactly-once-boundary")
            warns = [x for x in d if x.severity.name == "WARN"]
            errs = errors(d)
            assert warns and warns[0].node == "live"
            assert "FileSplitSource" in warns[0].message
            assert errs and errs[0].node == "effects"
            assert "live -> relay -> effects" in errs[0].message
            assert "idempotent=False" in errs[0].message

    def test_static_transactional_sink_absorbs_to_info(self, tmp_path):
        sink = lambda N: N.files.ExactlyOnceRecordFileSink(str(tmp_path / "out"))  # noqa: E731
        for d in twin(lambda N: self.plan(N, sink, tmp_path)):
            d = by_rule(d, "exactly-once-boundary")
            assert errors(d) == []
            infos = [x for x in d if x.severity.name == "INFO"]
            assert infos and "absorbed" in infos[0].message

    def test_static_wal_fronted_source_is_clean(self, tmp_path):
        def build(N):
            path = str(tmp_path / f"wal-{N.jax}.rec")
            N.files.write_record_file(path, [N.TV({"x": np.float32(1.0)})])
            env = N.Env(parallelism=1)
            env.enable_checkpointing(str(tmp_path / f"chk-{N.jax}"), interval_s=10)
            (env.from_source(N.FileSplit(path), name="wal")
                .add_sink(on(N, _EffectSink)([]), name="effects"))
            return env
        for d in twin(build):
            assert by_rule(d, "exactly-once-boundary") == []

    def test_the_file_sources_and_sink_declare_the_reference_s_delivery(self):
        for jcls, pcls, attr in ((jfiles.RecordFileSource, pfiles.RecordFileSource,
                                  "wal_fronted"),
                                 (JFileSplit, FileSplitSource, "wal_fronted"),
                                 (jfiles.ExactlyOnceRecordFileSink,
                                  pfiles.ExactlyOnceRecordFileSink, "idempotent")):
            assert getattr(pcls, attr) is getattr(jcls, attr) is True


# ---------------------------------------------------------------------------
# the paged pool against its key groups
# ---------------------------------------------------------------------------


def serving_plan(N, cfg, max_parallelism):
    if N.jax:
        mdef = jget("char_transformer", vocab_size=32, embed_dim=16, num_heads=2,
                    num_layers=1, capacity=32)
        model = mdef.to_model(mdef.init_params(jax.random.PRNGKey(0)))
    else:
        mdef = get_model_def("char_transformer", vocab_size=32, embed_dim=16, num_heads=2,
                             num_layers=1, capacity=32)
        model = mdef.to_model(mdef.init_params(0))
    requests = [N.serving.GenerateRequest(session_id="s0", prompt=[1, 2], max_new_tokens=2)]
    env = N.Env(parallelism=1)
    env.config = dataclasses.replace(env.config, max_parallelism=max_parallelism)
    (N.serving.continuous_batching(
        env.from_collection(requests).key_by(lambda r: r.session_id), model,
        config=N.serving.ServingConfig(**cfg), name="serve")
        .sink_to_list())
    return env


class TestPageKeygroupPartition:
    def keygroup(self, cfg):
        return [by_rule(d, "statecheck-page-keygroup")
                for d in twin(lambda N: serving_plan(N, cfg, 8))]

    def test_indivisible_page_pool_warns_with_pool_provenance(self):
        cfg = dict(max_active_seqs=2, token_budget=64, capacity=32, paged_kv=True,
                   page_tokens=16, hbm_pages=12)
        for d in self.keygroup(cfg):
            assert d and d[0].severity.name == "WARN"
            msg = d[0].message
            assert "PagedKVPool" in msg and "12 pages" in msg
            assert "page_tokens=16" in msg and "8 key groups" in msg

    def test_divisible_page_pool_is_info(self):
        cfg = dict(max_active_seqs=2, token_budget=64, capacity=32, paged_kv=True,
                   page_tokens=16, hbm_pages=16)
        for d in self.keygroup(cfg):
            assert d and d[0].severity.name == "INFO"
            assert "pages, not sessions" in d[0].message

    def test_dense_pool_stays_silent(self):
        for d in self.keygroup(dict(max_active_seqs=2, token_budget=64, capacity=32)):
            assert d == []


# ---------------------------------------------------------------------------
# the healthy plan
# ---------------------------------------------------------------------------


def keyed_counter(N):
    """Declared-state-only running count."""

    class KeyedCounter(_Crashing, N.fn.ProcessFunction):
        def process_element(self, value, ctx, out):
            self._tick()
            count = ctx.state(self.SD("count", lambda: 0))
            count.update((count.value() or 0) + 1)
            out.collect((ctx.current_key, count.value()))

    KeyedCounter.SD = N.SD
    return KeyedCounter


class TestHealthyPlan:
    N = 80

    def test_declared_state_is_byte_identical_across_crash(self, tmp_path):
        def run(tag, crash):
            crashed = [False] if crash else [True]
            env = P.Env(parallelism=1)
            env.enable_checkpointing(str(tmp_path / f"chk-{tag}"), every_n_records=20)
            out = (env.from_collection(list(range(self.N))).key_by(lambda x: x % 4)
                   .process(keyed_counter(P)(50 if crash else None, crashed), name="count")
                   .sink_to_list())
            result = run_with_restart(env) if crash else env.execute(timeout=120)
            return final_by_key(out), getattr(result, "restarts", 0)

        clean, _ = run("clean", False)
        crashed, restarts = run("crash", True)
        assert restarts == 1
        assert clean == crashed == {k: self.N // 4 for k in range(4)}

    def test_healthy_plan_audits_zero_statecheck_errors(self, tmp_path):
        def build(N):
            env = keyed_plan(N, keyed_counter(N)(), name="count")
            env.enable_checkpointing(str(tmp_path / f"chk-{N.jax}"), interval_s=10)
            return env
        for d in twin(build):
            assert errors(d) == []

    def test_a_numpy_constant_is_inert_and_a_tensor_is_state(self):
        table = np.arange(4.0)
        weights = torch.ones(4)

        def reads_constant(x):
            return x + float(table[x % 4])

        def accumulates(x):
            weights.add_(1.0)
            return x

        def hidden(fnc):
            env = P.Env(parallelism=1)
            env.from_collection([1, 2]).map(fnc, name="m").sink_to_list()
            return by_rule(state_diags(env, P), "statecheck-hidden-state")

        assert hidden(reads_constant) == []
        (d,) = hidden(accumulates)
        assert d.severity.name == "ERROR" and d.node == "m"
        assert "'weights'" in d.message and "a tensor float32[4] on cpu" in d.message


# ---------------------------------------------------------------------------
# the purity scanner's depth (the port's sanitizer against the reference's)
# ---------------------------------------------------------------------------


def _leaf_helper():
    return time.time()


def _mid_helper():
    return _leaf_helper() + 1.0


def _deep_helper():  # three calls below the outer function: past the default
    return _leaf_helper()


def _mid2_helper():
    return _deep_helper()


def _cycle_a(n):
    return _cycle_b(n - 1) if n else 0


def _cycle_b(n):
    return _cycle_a(n) + time.time()


def clocks(N, fnc, **kw):
    return [f.where for f in N.scan_code(fnc.__code__, fnc.__globals__, where=fnc.__name__, **kw)
            if f.kind == "wall-clock"]


class TestInterproceduralDepth:
    def test_two_level_provenance_chain(self):
        def outer(x):
            return x + _mid_helper()

        for N in (J, P):
            assert clocks(N, outer)[0] == "outer -> _mid_helper -> _leaf_helper"

    def test_depth_cap_is_configurable(self):
        def outer(x):
            return x + _mid2_helper()

        for N in (J, P):
            assert clocks(N, outer) == []
            assert clocks(N, outer, max_depth=3)[0] == (
                "outer -> _mid2_helper -> _deep_helper -> _leaf_helper")

    def test_cycle_guard_terminates_and_still_finds(self):
        def outer(x):
            return _cycle_a(x)

        for N in (J, P):
            assert clocks(N, outer, max_depth=10)

    def test_scan_cache_rehosts_provenance(self):
        from flink_tensorflow_tpu_torch.analysis.sanitizer import _SCAN_CACHE

        def first(x):
            return _mid_helper() + x

        def second(x):
            return _mid_helper() * x

        assert clocks(P, first) == ["first -> _mid_helper -> _leaf_helper"]
        assert id(_mid_helper.__code__) in _SCAN_CACHE
        for N in (J, P):
            assert clocks(N, second) == ["second -> _mid_helper -> _leaf_helper"]


# ---------------------------------------------------------------------------
# the report, the CLI, the doctor fold
# ---------------------------------------------------------------------------


CLEAN_PIPELINE = """
import sys
sys.path.insert(0, {repo!r})
from {pkg} import StreamExecutionEnvironment


def main(argv=None):
    env = StreamExecutionEnvironment(parallelism=1)
    env.from_collection([1, 2, 3]).map(lambda x: x + 1).sink_to_list()
    env.execute("clean", timeout=60)
"""

DEFECT_PIPELINE = """
import sys
sys.path.insert(0, {repo!r})
from {pkg} import StreamExecutionEnvironment

TRAIN_STATE = {{"variables": {{"w": 0.0}}, "opt_state": {{"count": 0}}}}


def main(argv=None):
    env = StreamExecutionEnvironment(parallelism=1)

    def step(v):
        TRAIN_STATE["opt_state"]["count"] += 1
        return v

    env.from_collection([1, 2, 3]).map(step, name="leaky").sink_to_list()
    env.execute("defect", timeout=60)
"""


def write_pipeline(tmp_path, name, template, pkg="flink_tensorflow_tpu_torch"):
    repo = str(pathlib.Path(__file__).resolve().parents[1])
    path = tmp_path / f"{pkg}_{name}"
    path.write_text(template.format(repo=repo, pkg=pkg))
    return str(path)


def defect_report(tmp_path, pkg="flink_tensorflow_tpu_torch"):
    if pkg == "flink_tensorflow_tpu":
        from flink_tensorflow_tpu.analysis import capture_pipeline_file, statecheck_report_for_env
    else:
        from flink_tensorflow_tpu_torch.analysis import (
            capture_pipeline_file,
            statecheck_report_for_env,
        )
    path = write_pipeline(tmp_path, "defect_pipeline.py", DEFECT_PIPELINE, pkg)
    return statecheck_report_for_env(capture_pipeline_file(path), pipeline=path)


class TestReportAndCli:
    def test_report_shape(self, tmp_path):
        jrep = defect_report(tmp_path, "flink_tensorflow_tpu")
        report = defect_report(tmp_path)
        assert set(report) == set(jrep) >= {"operators", "findings", "pipeline", "errors"}
        assert report["errors"] == jrep["errors"] >= 1
        hidden = [f for f in report["findings"] if f["rule"] == "statecheck-hidden-state"]
        assert hidden and hidden[0]["severity"] == "ERROR"
        assert hidden[0]["node"] == "leaky"
        leaky = [o for o in report["operators"] if o["node"] == "leaky"]
        assert leaky and leaky[0]["hidden_state"]
        assert [set(o) for o in report["operators"]] == [set(o) for o in jrep["operators"]]

    def test_cli_exit_codes(self, tmp_path, capsys):
        clean = write_pipeline(tmp_path, "clean_pipeline.py", CLEAN_PIPELINE)
        defect = write_pipeline(tmp_path, "defect_pipeline.py", DEFECT_PIPELINE)
        assert statecheck.main([clean]) == 0
        assert statecheck.main([defect]) == 1
        assert statecheck.main([str(tmp_path / "missing.py")]) == 2
        assert statecheck.main([defect, "--mesh", "data=2"]) == 1
        out = capsys.readouterr().out
        assert "[operator] leaky" in out and re.search(r"hidden: \S+: TRAIN_STATE", out)

    def test_cli_json_out(self, tmp_path, capsys):
        defect = write_pipeline(tmp_path, "defect_pipeline.py", DEFECT_PIPELINE)
        out = tmp_path / "report.json"
        assert statecheck.main([defect, "--json", "--out", str(out)]) == 1
        printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        saved = json.loads(out.read_text())
        assert printed["errors"] == saved["errors"] >= 1

    @pytest.mark.parametrize("pkg", ["flink_tensorflow_tpu", "flink_tensorflow_tpu_torch"])
    def test_doctor_folds_statecheck_report(self, tmp_path, capsys, pkg):
        from flink_tensorflow_tpu_torch.tracing import doctor

        path = tmp_path / "statecheck.json"
        path.write_text(json.dumps(defect_report(tmp_path, pkg)))
        assert doctor.main(["--statecheck", str(path), "--report-only"]) == 0
        out = capsys.readouterr().out
        assert "statecheck ERROR" in out
        assert "statecheck-hidden-state" in out

    def test_doctor_diagnose_keys_statecheck(self, tmp_path):
        from flink_tensorflow_tpu_torch.tracing.doctor import diagnose

        diag = diagnose(statecheck_report=defect_report(tmp_path))
        assert diag["statecheck"]
        assert any("statecheck-hidden-state" in line for line in diag["findings"])

    def test_bare_graph_without_config_skips_dataflow(self):
        def build(N):
            env = N.Env(parallelism=1)
            env.from_source(on(N, _DestructiveSource)([1]), name="live").sink_to_list()
            return env
        for d in twin(build, config=False):
            assert by_rule(d, "exactly-once-boundary") == []


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
