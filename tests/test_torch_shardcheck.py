"""The port's shardcheck held to ``flink_tensorflow_tpu.analysis.shardcheck``.

Every test of ``tests/test_shardcheck.py`` has a twin here: the same plan
is built in both packages and analyzed, and the twin compares the
shardcheck findings' ``(rule, severity, node, edge)`` and the facts in
their messages (buffer and axis names, MiB, paths), then runs the
reference test's own assertions on the port's findings.  Where the
reference test declares ``parallel.abstract_mesh`` (which raises under
the installed jax), the reference runs on a concrete ``make_mesh`` over
conftest's virtual CPU devices and the port on its shape-only
``abstract_mesh``: shardcheck reads only the mesh's shape.

Equal: params, KV pool, optimizer bytes, signature counts and
``predicted_step_h2d_bytes``, except that the port's paged pool holds one
page more than ``hbm_pages`` (the scratch page its runner allocates;
``test_the_paged_pool_counts_the_scratch_page``).  Peak activations agree
within ``ACTIVATION_FACTOR`` (the reference scans jaxpr liveness, the port
the lifetimes of the tensors of one meta run; the pricer's HBM bytes use
the same factor).

Also here: the repairs this audit needs (``ModelMapFunction``'s
``donate_inputs`` / ``sharding_axes`` / ``output_sharding_axes``, the
shape-only mesh, ``JobConfig.hbm_budget_bytes``), the collective census,
and the CLI and doctor fold of the report.
"""

from __future__ import annotations

import json
import re
import sys
import types

import numpy as np
import pytest
import torch

pytest.importorskip("flax")

import jax
import jax.numpy as jnp

import flink_tensorflow_tpu as jpkg
import flink_tensorflow_tpu.serving as jserving
from flink_tensorflow_tpu.analysis import analyze as janalyze
from flink_tensorflow_tpu.analysis import report_for_env as jreport
from flink_tensorflow_tpu.analysis import shardcheck as jshard
from flink_tensorflow_tpu.functions.model_function import ModelMapFunction as JMap
from flink_tensorflow_tpu.models import get_model_def as jget
from flink_tensorflow_tpu.models.base import Model as JModel
from flink_tensorflow_tpu.models.base import ModelMethod as JMethod
from flink_tensorflow_tpu.parallel import make_mesh as jmake_mesh
from flink_tensorflow_tpu.tensors.batching import BucketPolicy as JPolicy
from flink_tensorflow_tpu.tensors.schema import RecordSchema as JSchema
from flink_tensorflow_tpu.tensors.schema import spec as jspec
import flink_tensorflow_tpu_torch as ppkg
import flink_tensorflow_tpu_torch.serving as pserving
from flink_tensorflow_tpu_torch.analysis import SpecLayout, analyze, report_for_env
from flink_tensorflow_tpu_torch.analysis import shardcheck
from flink_tensorflow_tpu_torch.functions.model_function import (
    ModelMapFunction,
    ModelWindowFunction,
)
from flink_tensorflow_tpu_torch.models.base import Model, ModelMethod
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.parallel import collectives
from flink_tensorflow_tpu_torch.parallel.mesh import abstract_mesh, is_abstract_mesh
from flink_tensorflow_tpu_torch.tensors.batching import BucketPolicy
from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, spec

#: Port / reference peak activations must lie within this factor.
ACTIVATION_FACTOR = 2.0

# ---------------------------------------------------------------------------
# the fixtures, in both packages
# ---------------------------------------------------------------------------

J = types.SimpleNamespace(
    jax=True, Env=jpkg.StreamExecutionEnvironment, analyze=janalyze, report=jreport,
    Map=JMap, Policy=JPolicy, serving=jserving, SpecLayout=jshard.SpecLayout)
P = types.SimpleNamespace(
    jax=False, Env=ppkg.StreamExecutionEnvironment, analyze=analyze, report=report_for_env,
    Map=ModelMapFunction, Policy=BucketPolicy, serving=pserving, SpecLayout=SpecLayout)


def mesh(N, axes):
    """The declared mesh: shape-only in the port; a concrete mesh over the
    virtual CPU devices for the reference."""
    if N.jax:
        n = int(np.prod(list(axes.values())))
        return jmake_mesh(axes, devices=jax.devices()[:n])
    return abstract_mesh(axes)


class _Bias(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.bias = torch.nn.Parameter(torch.zeros(()))


class _Scale(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.ones(()))


class _WIn(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w_in = torch.nn.Parameter(torch.zeros(6, 10))


CACHE_SCHEMA = {"k_cache": ((768, 512), np.float32), "token": ((8,), np.int32)}


def cache_model(N, *, bf16_out=False, emit_cache=True):
    """A decode-like step: a 1.5 MiB per-record KV field rides through
    the method next to a small token field."""
    if N.jax:
        schema = JSchema({k: jspec(s, d) for k, (s, d) in CACHE_SCHEMA.items()})
        out_dtype = jnp.bfloat16 if bf16_out else np.float32

        def fn(params, batch):
            out = {"next": jnp.sum(batch["token"], axis=-1) + params["bias"]}
            if emit_cache:
                out["k_cache"] = (batch["k_cache"] + 1.0).astype(out_dtype)
            return out

        outputs = ("k_cache", "next") if emit_cache else ("next",)
        return JModel("cache_model", {"bias": jnp.zeros((), np.float32)},
                      {"decode": JMethod(name="decode", input_schema=schema,
                                         output_names=outputs, fn=fn)})
    schema = RecordSchema({k: spec(s, d) for k, (s, d) in CACHE_SCHEMA.items()})
    out_dtype = torch.bfloat16 if bf16_out else torch.float32

    def pfn(module, batch):
        out = {"next": batch["token"].sum(-1) + module.bias}
        if emit_cache:
            out["k_cache"] = (batch["k_cache"] + 1.0).to(out_dtype)
        return out

    outputs = ("k_cache", "next") if emit_cache else ("next",)
    return Model("cache_model", _Bias(), {"decode": ModelMethod(
        name="decode", input_schema=schema, output_names=outputs, fn=pfn)})


def tiny_model(N):
    """A small pure map model: {"x": [8]} -> {"x": [8]} (chainable)."""
    if N.jax:
        schema = JSchema({"x": jspec((8,), np.float32)})
        return JModel("tiny", {"scale": jnp.ones((), np.float32)}, {"serve": JMethod(
            name="serve", input_schema=schema, output_names=("x",),
            fn=lambda params, batch: {"x": batch["x"] * params["scale"]})})
    schema = RecordSchema({"x": spec((8,), np.float32)})
    return Model("tiny", _Scale(), {"serve": ModelMethod(
        name="serve", input_schema=schema, output_names=("x",),
        fn=lambda module, batch: {"x": batch["x"] * module.scale})})


DECODER = dict(vocab_size=32, embed_dim=16, num_heads=2, num_layers=1, capacity=16)


def zoo_decoder(N):
    if N.jax:
        mdef = jget("char_transformer", **DECODER)
        return mdef.to_model(mdef.init_params(jax.random.PRNGKey(0)))
    mdef = get_model_def("char_transformer", **DECODER)
    return mdef.to_model(mdef.init_params(0))


def shard_diags(env, N):
    return [d for d in N.analyze(env.graph, config=env.config)
            if d.rule.startswith("shardcheck")]


def by_rule(diags, rule):
    return [d for d in diags if d.rule == rule]


def keys(diags):
    return sorted((d.rule, d.severity.name, d.node, d.edge) for d in diags)


#: Facts a message carries: quoted names and paths, axis tuples, sizes in
#: parentheses, MiB figures, batch sizes, axis products, dtypes.
_FACTS = re.compile(r"\((?:'[\w-]*',? ?)+\)|'[\w./-]*'|\([0-9]+\)|[0-9.]+ ?MiB"
                    r"|batch [0-9]+|\w+x\w+ = [0-9]+|\b(?:b?float|u?int)[0-9]+\b")


def facts(message):
    return _FACTS.findall(message)


def twin(build):
    """``build(N, env)`` in both packages; the shardcheck findings of each,
    held equal by key and by the facts in their messages."""
    out = []
    for N in (J, P):
        env = N.Env(parallelism=1)
        build(N, env)
        out.append(shard_diags(env, N))
    jd, pd = out
    assert keys(pd) == keys(jd)
    jmsg = {(d.rule, d.severity.name, d.node, d.edge): facts(d.message) for d in jd}
    for d in pd:
        assert facts(d.message) == jmsg[(d.rule, d.severity.name, d.node, d.edge)], d.message
    return jd, pd


def map_plan(model, kw):
    """``model(N)`` mapped as "decode" with ``kw(N)``."""
    def build(N, env):
        env.from_collection([{}]).map(N.Map(model(N), "decode", **kw(N)), name="decode")
    return build


def fixed(b):
    return lambda N: {"policy": N.Policy(fixed_batch=b)}


# ---------------------------------------------------------------------------
# seeded defect 1: the non-donated KV field (the 2x-memory trap)
# ---------------------------------------------------------------------------


class TestDonation:
    def test_non_donated_kv_pool_is_named(self):
        for hits in map(lambda d: by_rule(d, "shardcheck-donation"),
                        twin(map_plan(cache_model, fixed(1)))):
            assert hits, "non-donated cache buffer not flagged"
            assert hits[0].severity.name == "WARN"
            assert hits[0].node == "decode"
            assert "'k_cache'" in hits[0].message
            assert "NOT donated" in hits[0].message
            assert "2x HBM" in hits[0].message

    def test_donated_matching_cache_is_clean(self):
        kw = lambda N: {"policy": N.Policy(fixed_batch=1), "donate_inputs": True}  # noqa: E731
        for d in twin(map_plan(cache_model, kw=kw)):
            assert by_rule(d, "shardcheck-donation") == []

    def test_dtype_defeated_donation_is_named(self):
        kw = lambda N: {"policy": N.Policy(fixed_batch=1), "donate_inputs": True}  # noqa: E731
        model = lambda N: cache_model(N, bf16_out=True)  # noqa: E731
        for d in twin(map_plan(model, kw=kw)):
            hits = by_rule(d, "shardcheck-donation")
            assert hits and "DEFEATED" in hits[0].message
            assert "'k_cache'" in hits[0].message
            assert "bfloat16" in hits[0].message

    def test_dead_donation_is_named(self):
        kw = lambda N: {"policy": N.Policy(fixed_batch=1), "donate_inputs": True}  # noqa: E731
        model = lambda N: cache_model(N, emit_cache=False)  # noqa: E731
        for d in twin(map_plan(model, kw=kw)):
            hits = by_rule(d, "shardcheck-donation")
            assert hits and "dead" in hits[0].message
            assert "'k_cache'" in hits[0].message


# ---------------------------------------------------------------------------
# seeded defect 2: a batch that does not divide the declared mesh
# ---------------------------------------------------------------------------


class TestPartition:
    def test_indivisible_batch_errors_and_names_axes(self):
        def build(N, env):
            env.set_mesh(mesh(N, {"data": 2, "fsdp": 2}))
            env.from_collection([{}]).map(
                N.Map(tiny_model(N), "serve", sharding_axes=("data", "fsdp"),
                      policy=N.Policy(fixed_batch=6)), name="serve")
        for d in twin(build):
            hits = by_rule(d, "shardcheck-partition")
            assert hits, "6 % (data x fsdp = 4) not flagged"
            assert hits[0].severity.name == "ERROR"
            assert hits[0].node == "serve"
            assert "batch 6" in hits[0].message
            assert "dataxfsdp" in hits[0].message

    def test_indivisible_param_dim_errors_and_names_buffer(self):
        def build(N, env):
            env.set_mesh(mesh(N, {"fsdp": 4}))
            if N.jax:
                schema = JSchema({"x": jspec((6,), np.float32)})
                model = JModel("m", {"w_in": jnp.zeros((6, 10), np.float32)}, {
                    "serve": JMethod(name="serve", input_schema=schema, output_names=("y",),
                                     fn=lambda p, b: {"y": b["x"] @ p["w_in"]})})
            else:
                schema = RecordSchema({"x": spec((6,), np.float32)})
                model = Model("m", _WIn(), {"serve": ModelMethod(
                    name="serve", input_schema=schema, output_names=("y",),
                    fn=lambda m, b: {"y": b["x"] @ m.w_in})})
            f = N.Map(model, "serve", policy=N.Policy(fixed_batch=4))
            f.spec_layout = N.SpecLayout(fsdp_axis="fsdp")
            env.from_collection([{}]).map(f, name="serve")
        for d in twin(build):
            hits = by_rule(d, "shardcheck-partition")
            assert hits and hits[0].severity.name == "ERROR"
            assert "'w_in'" in hits[0].message
            assert "'fsdp'" in hits[0].message

    def test_divisible_batch_is_clean(self):
        def build(N, env):
            env.set_mesh(mesh(N, {"data": 2, "fsdp": 2}))
            env.from_collection([{}]).map(
                N.Map(tiny_model(N), "serve", sharding_axes=("data", "fsdp"),
                      policy=N.Policy(fixed_batch=8)), name="serve")
        for d in twin(build):
            assert by_rule(d, "shardcheck-partition") == []


# ---------------------------------------------------------------------------
# seeded defect 3: a reshard across a device-resident chain
# ---------------------------------------------------------------------------


def chained(up_out_axes):
    def build(N, env):
        # Device residency on: the chained edge keeps batches on the
        # device, which a layout mismatch would defeat.
        env.configure(device_resident=True)
        env.from_collection([{}]).map(
            N.Map(tiny_model(N), "serve", sharding_axes=("data",),
                  output_sharding_axes=up_out_axes), name="up", parallelism=1,
        ).map(
            N.Map(tiny_model(N), "serve", sharding_axes=("data",)),
            name="down", parallelism=1)
    return build


class TestReshard:
    def test_layout_mismatch_on_device_resident_chain_is_error(self):
        from flink_tensorflow_tpu.analysis import compute_chains as jchains
        from flink_tensorflow_tpu_torch.analysis import compute_chains

        for N, chains in ((J, jchains), (P, compute_chains)):
            env = N.Env(parallelism=1)
            chained(("model",))(N, env)
            ops = {t.id: t.operator_factory() for t in env.graph.transformations}
            assert chains(env.graph, operators=ops).device_resident_edges, "did not chain"
        for d in twin(chained(("model",))):
            hits = by_rule(d, "shardcheck-reshard")
            assert hits, "layout mismatch across the chain not flagged"
            assert hits[0].severity.name == "ERROR"
            assert hits[0].edge == "up -> down"
            assert "('model',)" in hits[0].message
            assert "('data',)" in hits[0].message
            assert "h2d elision" in hits[0].message

    def test_matching_layouts_are_clean(self):
        for d in twin(chained(("data",))):
            assert by_rule(d, "shardcheck-reshard") == []


# ---------------------------------------------------------------------------
# seeded defect 4: a plan over its declared budget
# ---------------------------------------------------------------------------


def budget_plan(budget, batch=1):
    def build(N, env):
        env.set_hbm_budget(budget)
        env.from_collection([{}]).map(
            N.Map(cache_model(N), "decode", donate_inputs=True,
                  policy=N.Policy(fixed_batch=batch)), name="decode")
    return build


class TestHbmBudget:
    def test_over_budget_plan_errors_with_breakdown(self):
        for d in twin(budget_plan(64 * 1024)):  # 64 KiB: nothing real fits
            errors = [x for x in by_rule(d, "shardcheck-hbm-budget")
                      if x.severity.name == "ERROR"]
            assert errors, "over-budget plan not flagged"
            assert errors[0].node == "decode"
            assert "exceeds hbm_budget_bytes" in errors[0].message
            assert "activations=" in errors[0].message

    def test_generous_budget_is_info_only(self):
        for d in twin(budget_plan(16 * 1024**3)):
            hits = by_rule(d, "shardcheck-hbm-budget")
            assert hits, "budget declared but no summary emitted"
            assert all(x.severity.name == "INFO" for x in hits)

    def test_no_budget_no_mesh_stays_silent(self):
        kw = lambda N: {"policy": N.Policy(fixed_batch=1), "donate_inputs": True}  # noqa: E731
        for d in twin(map_plan(cache_model, kw=kw)):
            assert by_rule(d, "shardcheck-hbm-budget") == []


# ---------------------------------------------------------------------------
# seeded defect 5: an unbounded launch-signature set
# ---------------------------------------------------------------------------


def serving_plan(**cfg):
    def build(N, env):
        N.serving.continuous_batching(
            env.from_collection([{}]).key_by(lambda r: 0), zoo_decoder(N),
            config=N.serving.ServingConfig(max_active_seqs=2, capacity=16,
                                           token_budget=32, **cfg),
            name="serve_llm", parallelism=1)
    return build


class TestSignatures:
    def test_padding_buckets_off_warns_unbounded(self):
        for d in twin(serving_plan(padding_buckets=False)):
            warns = [x for x in by_rule(d, "shardcheck-signatures")
                     if x.severity.name == "WARN"]
            assert warns, "unbounded signature set not flagged"
            assert warns[0].node == "serve_llm"
            assert "unbounded" in warns[0].message

    def test_bucketed_serving_is_bounded_info(self):
        for d in twin(serving_plan()):
            hits = by_rule(d, "shardcheck-signatures")
            assert hits and all(x.severity.name == "INFO" for x in hits)
            cfg = pserving.ServingConfig(max_active_seqs=2, capacity=16, token_budget=32)
            assert f"{len(cfg.compile_signatures())} signature(s)" in hits[0].message

    def test_compile_signatures_enumeration(self):
        kw = dict(max_active_seqs=4, capacity=16, token_budget=32)
        cfg, jcfg = pserving.ServingConfig(**kw), jserving.ServingConfig(**kw)
        sigs = cfg.compile_signatures()
        assert sigs == jcfg.compile_signatures()
        assert len(sigs) == (len(cfg.resolved_admit_buckets())
                             * len(cfg.resolved_prompt_buckets()) + 1)
        assert ("decode", 4, 1) in sigs
        assert pserving.ServingConfig(padding_buckets=False).compile_signatures() is None


# ---------------------------------------------------------------------------
# healthy plans, the report, the collective census
# ---------------------------------------------------------------------------


def healthy(sharding=True):
    def build(N, env):
        env.set_mesh(mesh(N, {"data": 4, "tp": 2}))
        env.set_hbm_budget(16 * 1024**3)
        extra = {"sharding_axes": ("data",)} if sharding else {}
        env.from_collection([{}]).map(
            N.Map(cache_model(N), "decode", donate_inputs=True,
                  policy=N.Policy(fixed_batch=8), **extra), name="decode")
    return build


def reports(build):
    out = []
    for N in (J, P):
        env = N.Env(parallelism=1)
        build(N, env)
        out.append(N.report(env, pipeline="fixture"))
    return out


def hold_ops(jop, pop):
    """One operator of the two reports: equal but for the activations,
    which agree within ACTIVATION_FACTOR."""
    jb, pb = dict(jop["hbm_per_device_bytes"]), dict(pop["hbm_per_device_bytes"])
    ja, pa = jb.pop("activations", None), pb.pop("activations", None)
    assert pb == jb
    assert (ja is None) == (pa is None)
    if ja is not None:
        assert ja / ACTIVATION_FACTOR <= pa <= ja * ACTIVATION_FACTOR, (ja, pa)
    for k in ("node", "kind", "collectives", "signatures", "predicted_step_h2d_bytes"):
        assert pop[k] == jop[k], k


class TestHealthy:
    def test_healthy_sharded_plan_has_no_actionable_findings(self):
        for d in twin(healthy()):
            assert [x for x in d if x.severity.name in ("WARN", "ERROR")] == [], \
                "\n".join(x.format() for x in d)

    def test_audit_json_report_shape(self):
        jrep, prep = reports(healthy(sharding=False))
        assert set(prep) == set(jrep)
        for rep in (jrep, prep):
            assert rep["mesh_axes"] == {"data": 4, "tp": 2}
            assert rep["hbm_budget_bytes"] == 16 * 1024**3
            assert rep["errors"] == 0
            (op,) = rep["operators"]
            assert op["node"] == "decode" and op["kind"] == "model"
            assert op["hbm_per_device_bytes"]["params"] >= 0
            assert op["hbm_per_device_bytes"]["activations"] > 0
            assert all({"rule", "severity", "message"} <= set(f) for f in rep["findings"])
        (jop,), (pop,) = jrep["operators"], prep["operators"]
        assert set(pop) == set(jop)
        hold_ops(jop, pop)

    @staticmethod
    def census_plan(check_vma=False):
        """A method with one explicit all-reduce: ``lax.psum`` under
        ``shard_map`` over a concrete one-device mesh in the reference,
        ``collectives.all_reduce_`` in the port."""
        from functools import partial

        from jax.sharding import Mesh as JaxMesh
        from jax.sharding import PartitionSpec

        jmesh = JaxMesh(np.asarray(jax.devices()[:1]), ("data",))

        def jfn(params, batch):
            @partial(jax.shard_map, mesh=jmesh, in_specs=PartitionSpec("data"),
                     out_specs=PartitionSpec(), check_vma=check_vma)
            def _mean(x):
                return jax.lax.psum(jnp.sum(x), "data")
            return {"y": jnp.broadcast_to(_mean(batch["x"]), (1,))}

        def pfn(module, batch):
            return {"y": collectives.all_reduce_(batch["x"].sum()).reshape(1)}

        def build(N, env):
            if N.jax:
                model = JModel("coll", {}, {"serve": JMethod(
                    name="serve", input_schema=JSchema({"x": jspec((8,), np.float32)}),
                    output_names=("y",), fn=jfn)})
            else:
                model = Model("coll", torch.nn.Module(), {"serve": ModelMethod(
                    name="serve", input_schema=RecordSchema({"x": spec((8,), np.float32)}),
                    output_names=("y",), fn=pfn)})
            env.from_collection([{}]).map(
                N.Map(model, "serve", policy=N.Policy(fixed_batch=1)), name="coll")
        return build

    def test_collective_census_counts_psum(self):
        """The port's all-reduce is counted under the reference's ``psum``
        (the reference with ``check_vma=False``, whose jaxpr names the
        primitive ``psum``; see the next test for the default)."""
        before = dict(collectives.calls)
        for d in twin(self.census_plan()):
            hits = by_rule(d, "shardcheck-collectives")
            assert hits and hits[0].severity.name == "INFO"
            assert "psumx1" in hits[0].message
        # The census counts in its own counter: the run-time one is
        # untouched by the plan-time walk.
        assert dict(collectives.calls) == before

    def test_the_reference_census_misses_psum_invariant(self):
        """A reference fault: under jax 0.9's default ``shard_map``
        (``check_vma=True``) the jaxpr names the all-reduce
        ``psum_invariant``, which ``COLLECTIVE_PRIMS`` lacks, so the
        reference counts no collective where the port counts one."""
        out = []
        for N in (J, P):
            env = N.Env(parallelism=1)
            self.census_plan(check_vma=True)(N, env)
            out.append(by_rule(shard_diags(env, N), "shardcheck-collectives"))
        jd, pd = out
        assert jd == [] and len(pd) == 1 and "psumx1" in pd[0].message


# ---------------------------------------------------------------------------
# the paged KV pool: the page pool and the block-table H2D
# ---------------------------------------------------------------------------


def serving_op(N, **kw):
    env = N.Env(parallelism=1)
    serving_plan(**kw)(N, env)
    report = N.report(env)
    (op,) = [o for o in report["operators"] if o["kind"] == "serving"]
    return op


class TestPagedKvAudit:
    # 2 (K+V) * L * page_tokens * H * Dh * itemsize at the decoder's
    # geometry: 1 layer, 2 heads, Dh 8, f32.
    PAGE = 2 * 1 * 8 * 2 * 8 * 4

    def test_paged_pool_budget_is_page_count_not_seats(self):
        for N, extra in ((J, 0), (P, 1)):
            dense = serving_op(N)
            paged = serving_op(N, paged_kv=True, page_tokens=8, hbm_pages=3)
            assert paged["hbm_per_device_bytes"]["kv_pool"] == (3 + extra) * self.PAGE
            # Dense prices seats x capacity (4 pages' worth): an
            # undersized paged pool audits SMALLER than the dense one.
            assert dense["hbm_per_device_bytes"]["kv_pool"] == 2 * 2 * self.PAGE
            assert not paged["notes"], paged["notes"]

    def test_paged_step_h2d_rides_block_tables(self):
        for N in (J, P):
            dense = serving_op(N)
            paged = serving_op(N, paged_kv=True, page_tokens=8, hbm_pages=4)
            assert paged["predicted_step_h2d_bytes"] == 2 * 4 + 2 * 4 + 2 * 2 * 4
            assert dense["predicted_step_h2d_bytes"] == 2 * 4 + 2 * 4 + 2 * 1

    @pytest.mark.parametrize("paged", [False, True])
    def test_the_serving_audits_are_equal(self, paged):
        kw = dict(paged_kv=True, page_tokens=8, hbm_pages=4) if paged else {}
        jop, pop = serving_op(J, **kw), serving_op(P, **kw)
        if paged:  # the scratch page (test below)
            pop["hbm_per_device_bytes"]["kv_pool"] -= TestPagedKvAudit.PAGE
        hold_ops(jop, pop)

    def test_the_paged_pool_counts_the_scratch_page(self):
        """The port's pool is what its runner allocates: ``hbm_pages`` + 1
        pages (sentinel table entries write to the last)."""
        from flink_tensorflow_tpu_torch.functions.runner import PagedDecodeStepRunner

        op = serving_op(P, paged_kv=True, page_tokens=8, hbm_pages=3)
        runner = PagedDecodeStepRunner(zoo_decoder(P), pool_slots=2, capacity=16,
                                       page_tokens=8, num_pages=3, device="cpu")
        runner.open()
        try:
            live = runner._kc.nbytes + runner._vc.nbytes
        finally:
            runner.close()
        assert op["hbm_per_device_bytes"]["kv_pool"] == live


# ---------------------------------------------------------------------------
# the repairs the audit needs
# ---------------------------------------------------------------------------


class TestRepairs:
    def test_model_map_sharding_axes_give_the_reference_sharding_axis_findings(self):
        def build(N, env):
            env.set_mesh(mesh(N, {"data": 2}))
            env.from_collection([{}]).map(
                N.Map(tiny_model(N), "serve", sharding_axes=("data", "model"),
                      policy=N.Policy(fixed_batch=3)), name="serve")
        out = []
        for N in (J, P):
            env = N.Env(parallelism=1)
            build(N, env)
            out.append([(d.severity.name, d.node, d.message)
                        for d in N.analyze(env.graph, config=env.config)
                        if d.rule == "sharding-axis"])
        assert out[1] == out[0] and out[0]

    def test_output_sharding_axes_default_to_the_input_axes(self):
        for N in (J, P):
            f = N.Map(tiny_model(N), "serve", sharding_axes=["data"])
            assert f.sharding_axes == ("data",) and f.output_sharding_axes == ("data",)
            g = N.Map(tiny_model(N), "serve")
            assert not hasattr(g, "sharding_axes") and g.output_sharding_axes is None

    def test_the_ring_refuses_donated_inputs(self):
        ctx = type("Ctx", (), {"device": "cpu", "metrics": None})()
        f = ModelWindowFunction(tiny_model(P), use_ring=True, donate_inputs=True,
                                policy=BucketPolicy(fixed_batch=2))
        with pytest.raises(ValueError, match="incompatible with donate_inputs"):
            f.open(ctx)
        f.close()
        # Eligible by default, but not with donation: the list path.
        f = ModelWindowFunction(tiny_model(P), donate_inputs=True,
                                policy=BucketPolicy(fixed_batch=2))
        f.open(ctx)
        try:
            assert f._ring is None
        finally:
            f.close()

    def test_donation_drops_the_shipped_batch_when_the_method_returns(self):
        from flink_tensorflow_tpu_torch.functions.runner import CompiledMethodRunner
        from flink_tensorflow_tpu_torch.tensors.value import TensorValue

        schema = RecordSchema({"x": spec((8,), np.float32)})
        model = Model("m", torch.nn.Module(), {"serve": ModelMethod(
            name="serve", input_schema=schema, output_names=("y",),
            fn=lambda module, batch: {"y": batch["x"] * 2})})
        held = {}
        for donate in (False, True):
            runner = CompiledMethodRunner(model, policy=BucketPolicy(fixed_batch=2),
                                          device="cpu", donate_inputs=donate)
            runner.open()
            ship = runner._transfer.assemble_and_ship

            def shipping(*args, _ship=ship, _donate=donate):
                shipped = _ship(*args)
                held[_donate] = shipped.inputs  # what the runner keeps of the batch
                return shipped

            runner._transfer.assemble_and_ship = shipping
            try:
                runner.dispatch([TensorValue({"x": np.full(8, i, np.float32)})
                                 for i in range(2)])
                out = runner.flush()
            finally:
                runner.close()
            assert [float(r["y"][0]) for r in out] == [0.0, 2.0]
        assert list(held[False]) == ["x"] and held[True] == {}

    def test_abstract_mesh_is_shape_only_and_validated(self):
        m = abstract_mesh({"tp": 2, "data": 4})
        assert dict(m.shape) == {"data": 4, "tp": 2} and is_abstract_mesh(m)
        assert m.size == 8 and not m.distributed
        for bad, match in (({"bogus": 2}, "unknown mesh axes"), ({"data": 0}, ">=1")):
            with pytest.raises(ValueError, match=match):
                abstract_mesh(bad)
        env = ppkg.StreamExecutionEnvironment(parallelism=1)
        env.set_mesh(m)  # JobConfig.mesh accepts it
        assert env.mesh is m
        with pytest.raises(RuntimeError, match="shape-only"):
            m.device

    def test_a_gang_on_a_shape_only_mesh_fails_at_open(self):
        from flink_tensorflow_tpu_torch.functions.training_function import (
            DPTrainWindowFunction,
        )
        from flink_tensorflow_tpu_torch.tensors.value import TensorValue

        mdef = get_model_def("widedeep", hash_buckets=10, embed_dim=2, num_cat_slots=2,
                             num_dense=3, num_wide=8, hidden=(4,))
        schema = mdef.input_schema
        record = TensorValue({n: np.zeros(schema[n].shape, schema[n].dtype)
                              for n in schema.names})
        env = ppkg.StreamExecutionEnvironment(parallelism=1)
        env.set_mesh(abstract_mesh({"data": 1}))
        (env.from_collection([record] * 4, schema=schema).count_window(4)
            .apply(DPTrainWindowFunction(mdef, train_schema=schema, global_batch=4),
                   name="gang").sink_to_list())
        with pytest.raises(Exception, match="shape-only"):
            env.execute("gang", timeout=60)

    def test_hbm_budget_config(self):
        env = ppkg.StreamExecutionEnvironment(parallelism=1)
        assert env.config.hbm_budget_bytes is None
        env.set_hbm_budget(1 << 30)
        assert env.config.validate().hbm_budget_bytes == 1 << 30
        with pytest.raises(ValueError, match="hbm_budget_bytes must be >= 1"):
            env.set_hbm_budget(0).config.validate()

    def test_execute_validate_refuses_an_over_budget_plan(self):
        from flink_tensorflow_tpu_torch.analysis import PlanValidationError

        env = ppkg.StreamExecutionEnvironment(parallelism=1)
        budget_plan(64 * 1024)(P, env)
        with pytest.raises(PlanValidationError, match="shardcheck-hbm-budget"):
            env.execute("over-budget", validate=True, timeout=30)


# ---------------------------------------------------------------------------
# the report, the CLI, the doctor fold
# ---------------------------------------------------------------------------


PIPELINE = """
import sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
from flink_tensorflow_tpu_torch import StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.functions.model_function import ModelMapFunction
from flink_tensorflow_tpu_torch.models.base import Model, ModelMethod
from flink_tensorflow_tpu_torch.tensors.batching import BucketPolicy
from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, spec


def main(argv=None):
    schema = RecordSchema({{"x": spec((256, 1024), np.float32)}})
    model = Model("big", torch.nn.Module(), {{"serve": ModelMethod(
        name="serve", input_schema=schema, output_names=("x",),
        fn=lambda m, b: {{"x": b["x"] + 1.0}})}})
    env = StreamExecutionEnvironment(parallelism=1)
    env.from_collection([{{}}]).map(
        ModelMapFunction(model, "serve", sharding_axes=("data",),
                         policy=BucketPolicy(fixed_batch={batch})), name="serve")
    env.execute("fixture", timeout=60)
"""


def pipeline(tmp_path, batch):
    import pathlib

    repo = str(pathlib.Path(__file__).resolve().parents[1])
    path = tmp_path / f"pipeline_{batch}.py"
    path.write_text(PIPELINE.format(repo=repo, batch=batch))
    return str(path)


class TestReportAndCli:
    def test_cli_exit_codes_and_json(self, tmp_path, capsys):
        clean, ragged = pipeline(tmp_path, 4), pipeline(tmp_path, 6)
        assert shardcheck.main([clean, "--mesh", "data=2", "--json"]) == 0
        out = tmp_path / "report.json"
        assert shardcheck.main([ragged, "--mesh", "data=4", "--hbm-budget-bytes", "1024",
                                "--json", "--out", str(out)]) == 1
        assert shardcheck.main([str(tmp_path / "missing.py")]) == 2
        printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()
                   if x.startswith("{")]
        saved = json.loads(out.read_text())
        assert printed[-1] == saved and saved["errors"] == 2
        assert saved["mesh_axes"] == {"data": 4} and saved["hbm_budget_bytes"] == 1024
        rules = {f["rule"] for f in saved["findings"] if f["severity"] == "ERROR"}
        assert rules == {"shardcheck-partition", "shardcheck-hbm-budget"}

    def test_cli_text_and_cost_table(self, tmp_path, capsys):
        table = tmp_path / "table.json"
        assert shardcheck.main([pipeline(tmp_path, 4), "--cost-table", str(table)]) == 0
        text = capsys.readouterr().out
        assert "[model] serve" in text and "signatures=1" in text
        assert json.loads(table.read_text())["kind"] == "flink-tpu-cost-table"

    def test_the_report_keys_are_the_reference_s(self):
        jrep, prep = reports(healthy())
        assert set(prep) == set(jrep)
        assert [set(o) for o in prep["operators"]] == [set(o) for o in jrep["operators"]]
        assert [set(f) for f in prep["findings"]] == [set(f) for f in jrep["findings"]]

    @pytest.mark.parametrize("package", ["jax", "torch"])
    def test_the_doctor_folds_either_package_s_report(self, tmp_path, capsys, package):
        from flink_tensorflow_tpu_torch.tracing import doctor

        N = J if package == "jax" else P
        env = N.Env(parallelism=1)
        budget_plan(64 * 1024)(N, env)
        path = tmp_path / "shardcheck.json"
        path.write_text(json.dumps(N.report(env)))
        assert doctor.main(["--shardcheck", str(path), "--report-only"]) == 0
        out = capsys.readouterr().out
        assert "shardcheck ERROR" in out and "shardcheck-hbm-budget" in out


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
