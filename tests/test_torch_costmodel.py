"""The port's plan-time pricer held to ``flink_tensorflow_tpu.analysis.costmodel``.

The same plans go through ``cost_table_for_env`` in both packages: LeNet
and Inception (at 75 px) through ``ModelWindowFunction``, the
char-transformer serving plan dense and paged (``page_tokens=8``, as
``tests/test_roofline.py:672-700``), a narrow ResNet through
``DPTrainWindowFunction`` and Wide&Deep through ``OnlineTrainFunction``.

Equal: the predicted signature ladders, the unit and signature names,
every ``h2d_bytes`` and ``d2h_bytes``, and the matmul and convolution
FLOPs (the reference's are recounted here from the jaxprs it priced,
which ``_entry_of`` hands over).  Within a stated tolerance: the total
FLOPs outside K1, within ±25% (the frameworks split elementwise work
differently: a torch op is often several jaxpr equations), and the HBM
bytes, within 2x (both are un-fused per-op sums over different op sets).

Two places where the port does not copy the reference, each with its
named test: a Pallas call is priced by ONE grid step there (its kernel
jaxpr is walked without the grid), which under-prices every prefill's
attention, while the port charges K1 by ``k1_cost``; and a strided
convolution's input gradient is priced over the dilated input there
(``s**2`` times its multiply-adds), while the port counts the
multiply-adds ``torch.utils.flop_counter`` counts.
"""

from __future__ import annotations

import collections
import json
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("flax")

import jax
import jax.numpy as jnp
import optax

import flink_tensorflow_tpu as J
import flink_tensorflow_tpu.serving  # noqa: F401 - J.serving
from flink_tensorflow_tpu.analysis import costmodel as jcost
from flink_tensorflow_tpu.analysis.shardcheck import _as_jaxprs
from flink_tensorflow_tpu.functions import DPTrainWindowFunction as JaxDP
from flink_tensorflow_tpu.functions import ModelWindowFunction as JaxMWF
from flink_tensorflow_tpu.functions import OnlineTrainFunction as JaxOnline
from flink_tensorflow_tpu.models import get_model_def as jax_model_def
from flink_tensorflow_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from flink_tensorflow_tpu.tensors import RecordSchema as JaxSchema
from flink_tensorflow_tpu.tensors import spec as jax_spec
from flink_tensorflow_tpu.tensors.batching import BucketPolicy as JaxPolicy
import flink_tensorflow_tpu_torch as P
import flink_tensorflow_tpu_torch.serving  # noqa: F401 - P.serving
from flink_tensorflow_tpu_torch.analysis import costmodel
from flink_tensorflow_tpu_torch.functions.model_function import ModelWindowFunction
from flink_tensorflow_tpu_torch.functions.training_function import (
    DPTrainWindowFunction,
    OnlineTrainFunction,
)
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.ops.flash_attention import k1_cost, visible_pairs
from flink_tensorflow_tpu_torch.parallel import optim
from flink_tensorflow_tpu_torch.tensors.batching import BucketPolicy
from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, spec

sys.path.insert(0, "tests")
from test_torch_inception import flax_variables  # noqa: E402

FLOPS_TOL = 0.25
HBM_FACTOR = 2.0
CHAR_CFG = dict(vocab_size=48, embed_dim=32, num_heads=2, num_layers=2, capacity=40)
RESNET_CFG = dict(num_classes=4, image_size=32, width=8, stage_sizes=(1, 1))
WIDEDEEP_CFG = dict(hash_buckets=50, embed_dim=4, num_cat_slots=2, num_dense=3, num_wide=8,
                    hidden=(8,))
INCEPTION_CFG = dict(num_classes=10, image_size=75, uint8_input=True)


# ---------------------------------------------------------------------------
# the plans, built in both packages
# ---------------------------------------------------------------------------

def _window_plan(env, model, batch, name):
    (env.from_collection([], schema=model.method("serve").input_schema)
        .count_window(batch).apply(model_fn(env)(model, policy=policy(env)(fixed_batch=batch)),
                                   name=name)
        .sink_to_list())
    return env


def model_fn(env):
    return JaxMWF if isinstance(env, J.StreamExecutionEnvironment) else ModelWindowFunction


def policy(env):
    return JaxPolicy if isinstance(env, J.StreamExecutionEnvironment) else BucketPolicy


def lenet_plans():
    jdef, pdef = jax_model_def("lenet"), get_model_def("lenet")
    return (_window_plan(J.StreamExecutionEnvironment(),
                         jdef.to_model(jax.jit(jdef.init_fn)(jax.random.key(0))), 8, "lenet"),
            _window_plan(P.StreamExecutionEnvironment(), pdef.to_model(pdef.init_fn(0)), 8,
                         "lenet"))


def inception_plans():
    variables = flax_variables(jax_model_def("inception_v3", **INCEPTION_CFG), 0)
    return tuple(_window_plan(env, get("inception_v3", **INCEPTION_CFG).to_model(variables), 4,
                              "inception")
                 for env, get in ((J.StreamExecutionEnvironment(), jax_model_def),
                                  (P.StreamExecutionEnvironment(), get_model_def)))


def _requests(serving, n=6):
    rng = np.random.RandomState(3)
    return [serving.GenerateRequest(session_id=f"s{i}",
                                    prompt=rng.randint(1, 48, (int(rng.randint(4, 11)),)),
                                    max_new_tokens=int(rng.randint(4, 9)))
            for i in range(n)]


def serving_plans(paged: bool):
    jdef = jax_model_def("char_transformer", **CHAR_CFG)
    pdef = get_model_def("char_transformer", **CHAR_CFG)
    out = []
    for env, serving, model in (
            (J.StreamExecutionEnvironment(parallelism=1), J.serving,
             jdef.to_model(jdef.init_params(jax.random.PRNGKey(0)))),
            (P.StreamExecutionEnvironment(parallelism=1), P.serving,
             pdef.to_model(pdef.init_params(0)))):
        kw = dict(paged_kv=True, page_tokens=8) if paged else {}
        serving.continuous_batching(
            env.from_collection(_requests(serving)).key_by(lambda r: r.session_id), model,
            config=serving.ServingConfig(max_active_seqs=4, token_budget=256, capacity=40, **kw),
            parallelism=1).sink_to_list()
        out.append(env)
    return tuple(out)


def resnet_plans():
    out = []
    for env, get, dp, schema_cls, sp, opt in (
            (J.StreamExecutionEnvironment(), jax_model_def, JaxDP, JaxSchema, jax_spec,
             optax.adam(1e-3)),
            (P.StreamExecutionEnvironment(), get_model_def, DPTrainWindowFunction, RecordSchema,
             spec, optim.adam(1e-3))):
        schema = schema_cls({"image": sp((32, 32, 3)), "label": sp((), np.int32)})
        (env.from_collection([], schema=schema).count_window(8)
            .apply(dp(get("resnet50", **RESNET_CFG), opt, train_schema=schema, global_batch=8),
                   name="train").sink_to_list())
        out.append(env)
    return tuple(out)


def widedeep_plans():
    out = []
    for env, get, online, schema_cls, sp, opt in (
            (J.StreamExecutionEnvironment(), jax_model_def, JaxOnline, JaxSchema, jax_spec,
             optax.adam(1e-2)),
            (P.StreamExecutionEnvironment(), get_model_def, OnlineTrainFunction, RecordSchema,
             spec, optim.adam(1e-2))):
        schema = schema_cls({"wide": sp((8,)), "dense": sp((3,)), "cat": sp((2,), np.int32),
                             "label": sp((), np.int32)})
        (env.from_collection([], schema=schema).key_by(lambda r: 0)
            .process(online(get("widedeep", **WIDEDEEP_CFG), opt, train_schema=schema,
                            mini_batch=32), name="train").sink_to_list())
        out.append(env)
    return tuple(out)


PLANS = {
    "lenet": lenet_plans,
    "inception": inception_plans,
    "serving-dense": lambda: serving_plans(False),
    "serving-paged": lambda: serving_plans(True),
    "resnet-dp": resnet_plans,
    "widedeep-online": widedeep_plans,
}


# ---------------------------------------------------------------------------
# pricing both, with what each priced per entry
# ---------------------------------------------------------------------------

def ref_breakdown(jaxpr, in_pallas: bool = False) -> collections.Counter:
    """The reference's walk (``costmodel.py:_jaxpr_cost``) split by kind:
    ``matmul``, ``conv``, ``other`` (elementwise and reductions) and the
    same prefixed ``pallas_`` inside a ``pallas_call``; ``conv_work``
    divides each convolution by its lhs dilation (the multiply-adds a
    dilated input's zeros do not need)."""
    out = collections.Counter()
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name.rstrip("0123456789")
        subs = [s for val in eqn.params.values() for s in _as_jaxprs(val)]
        if subs:
            costs = [ref_breakdown(s, in_pallas or name == "pallas_call") for s in subs]
            if name == "cond":
                out.update(max(costs, key=lambda c: sum(c.values())))
                continue
            mult = int(eqn.params.get("length", 1)) if name == "scan" else 1
            for c in costs:
                for k, v in c.items():
                    out[k] += mult * v
            continue
        pre = "pallas_" if in_pallas else ""
        if name == "dot_general":
            out[pre + "matmul"] += jcost._dot_flops(eqn)
        elif name == "conv_general_dilated":
            flops = jcost._conv_flops(eqn)
            out[pre + "conv"] += flops
            out[pre + "conv_work"] += flops // int(np.prod(eqn.params["lhs_dilation"]))
        elif name in jcost.ELEMENTWISE_PRIMS:
            out[pre + "other"] += sum(jcost._aval_elems(v) for v in eqn.outvars)
        elif name in jcost.REDUCE_PRIMS:
            out[pre + "other"] += sum(jcost._aval_elems(v) for v in eqn.invars
                                      if hasattr(v, "aval"))
    return out


def _capture(monkeypatch, module):
    """What ``module._entry_of`` prices, per (unit, signature): the
    reference's closed jaxpr, the port's :class:`UnitCost`."""
    got = {}
    original = module._entry_of

    def entry_of(unit, signature, priced, **kw):
        got[(unit, signature)] = priced
        return original(unit, signature, priced, **kw)

    monkeypatch.setattr(module, "_entry_of", entry_of)
    return got


@pytest.fixture(scope="module")
def priced():
    cache = {}

    def price(name):
        if name not in cache:
            jenv, penv = PLANS[name]()
            with pytest.MonkeyPatch.context() as mp:
                jgot, pgot = _capture(mp, jcost), _capture(mp, costmodel)
                cache[name] = (jcost.cost_table_for_env(jenv), costmodel.cost_table_for_env(penv),
                               jgot, pgot, penv)
        return cache[name]

    return price


@pytest.mark.parametrize("name", sorted(PLANS))
def test_the_pricer_matches_the_reference(name, priced):
    jtable, ptable, jgot, pgot, _ = priced(name)
    assert [(o.node, o.kind) for o in ptable.ops] == [(o.node, o.kind) for o in jtable.ops]
    for jop, pop in zip(jtable.ops, ptable.ops):
        assert pop.notes == jop.notes == []
        assert pop.predicted_signatures == jop.predicted_signatures
        assert [(e.unit, e.signature) for e in pop.entries] == [
            (e.unit, e.signature) for e in jop.entries]
        for je, pe in zip(jop.entries, pop.entries):
            key = (pe.unit, pe.signature)
            assert (pe.h2d_bytes, pe.d2h_bytes) == (je.h2d_bytes, je.d2h_bytes), key
            if key not in pgot:
                continue  # a cache move: bytes only
            unit, ref = pgot[key], ref_breakdown(jgot[key].jaxpr)
            assert unit.matmul_flops == ref["matmul"], key
            assert unit.conv_flops == ref["conv_work"], key
            ours = unit.matmul_flops + unit.conv_flops + unit.other_flops
            theirs = ref["matmul"] + ref["conv"] + ref["other"]
            assert abs(ours - theirs) <= FLOPS_TOL * theirs, (key, ours, theirs)
            assert je.hbm_bytes / HBM_FACTOR <= pe.hbm_bytes <= je.hbm_bytes * HBM_FACTOR, key
            assert pe.flops == ours + unit.k1_flops and pe.flops > 0


@pytest.mark.parametrize("name", ["serving-dense", "serving-paged"])
def test_every_prefill_charges_k1_by_k1_cost(name, priced):
    """Each of the model's layers runs one causal K1 call over the
    prefill's ``[b, n]`` tokens; decode runs none."""
    _, ptable, _, pgot, _ = priced(name)
    (op,) = ptable.ops
    layers, heads = CHAR_CFG["num_layers"], CHAR_CFG["num_heads"]
    d = CHAR_CFG["embed_dim"] // heads
    for e in op.entries:
        if e.unit == "prefill":
            b, n = (int(x) for x in e.signature.split(":")[1].split("x"))
            flops, _ = k1_cost(b, heads, n, n, d, torch.float32, True, False)
            assert pgot[(e.unit, e.signature)].k1_flops == layers * flops
        elif e.unit == "decode_step":
            assert pgot[(e.unit, e.signature)].k1_flops == 0


class _ObservedTransfers:
    """A roofline probe that keeps each observed call's transfer bytes by
    (unit, signature)."""

    def __init__(self):
        self.seen = collections.defaultdict(set)

    def observe(self, unit, seconds, *, signature, h2d_bytes=0, d2h_bytes=0):
        self.seen[(unit, signature)].add((h2d_bytes, d2h_bytes))

    def begin_warmup(self):
        pass

    def end_warmup(self):
        pass


@pytest.mark.parametrize("name", ["serving-dense", "serving-paged"])
def test_the_serving_units_are_the_runners_own(name, priced):
    """The port's decode runner, run on the CPU through its warmup (every
    signature of the ladder once), observes at each signature exactly the
    transfers the table priced there: the pricer prices the runner's own
    device functions and H2D count, not a copy of them."""
    from flink_tensorflow_tpu_torch.functions.runner import (
        DecodeStepRunner,
        PagedDecodeStepRunner,
    )

    _, ptable, _, _, penv = priced(name)
    (op,) = ptable.ops
    (t,) = [t for t in penv.graph.transformations if t.name == "continuous_batching"]
    serving_op = t.operator_factory()
    cfg = serving_op.serving_config
    common = dict(pool_slots=cfg.max_active_seqs, capacity=cfg.capacity,
                  prompt_buckets=cfg.resolved_prompt_buckets(), device="cpu")
    runner = (PagedDecodeStepRunner(serving_op.model, page_tokens=cfg.page_tokens,
                                    num_pages=cfg.resolved_hbm_pages(), **common)
              if cfg.paged_kv else DecodeStepRunner(serving_op.model, **common))
    runner.open()
    runner._roofline = probe = _ObservedTransfers()
    runner.warmup(cfg.resolved_admit_buckets(), cfg.resolved_prompt_buckets())
    priced_units = {(e.unit, e.signature): {(e.h2d_bytes, e.d2h_bytes)}
                    for e in op.entries if e.unit != "cache_move"}
    assert dict(probe.seen) == priced_units
    assert {sig for _, sig in priced_units} == set(op.predicted_signatures)


@pytest.mark.parametrize("t, causal", [(256, True), (512, False), (1024, True)])
def test_the_reference_prices_a_pallas_call_by_one_grid_step(t, causal):
    """The reference's fault, held: ``_jaxpr_cost`` walks the kernel jaxpr
    of ``pallas_call`` without multiplying by the grid, so one call of its
    flash attention is priced at one block's work — under 10% of K1's at
    ``T >= 256``."""
    b, h, d = 2, 4, 16
    q = jnp.zeros((b, t, h, d), jnp.float32)
    closed = jax.make_jaxpr(lambda q, k, v: jax_flash_attention(q, k, v, causal=causal))(q, q, q)
    reference = jcost.cost_of_closed(closed)[0]
    flops, _ = k1_cost(b, h, t, t, d, torch.float32, causal, False)
    assert flops == 4 * b * h * d * (t * (t + 1) // 2 if causal else t * t)
    assert reference < 0.10 * flops


def test_the_reference_prices_a_strided_input_gradient_over_the_dilated_input(priced):
    """The other divergence: the reference's ResNet train step prices its
    stride-2 convolutions' input gradients as convolutions over the
    dilated gradient (``s**2`` times their multiply-adds); the port counts
    ``torch.utils.flop_counter``'s multiply-adds, which the reference's
    count divided by the dilation gives exactly."""
    _, _, jgot, pgot, _ = priced("resnet-dp")
    ref = ref_breakdown(jgot[("train_step", "train:b8")].jaxpr)
    assert ref["conv"] > ref["conv_work"] == pgot[("train_step", "train:b8")].conv_flops


@pytest.mark.parametrize("t, tk", [(1, 1), (7, 7), (16, 16), (33, 12), (12, 33), (100, 64)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("return_lse", [False, True])
def test_k1_cost_counts_the_visible_pairs_and_the_bytes_moved(t, tk, causal, return_lse):
    b, h, d = 3, 2, 16
    pairs = sum(min(i + 1, tk) for i in range(t)) if causal else t * tk
    assert visible_pairs(t, tk, causal) == pairs
    for dtype, es in ((torch.float32, 4), ("bfloat16", 2), (torch.float16, 2)):
        flops, nbytes = k1_cost(b, h, t, tk, d, dtype, causal, return_lse)
        assert flops == 4 * b * h * d * pairs
        assert nbytes == es * (2 * b * t * h * d + 2 * b * tk * h * d) + (
            4 * b * h * t if return_lse else 0)


def test_chip_smoke_bounds_k1_by_k1_cost():
    """``chip_smoke.py:k1_bound`` reads ``k1_cost``; phase 3's rows (lse
    returned) keep the bounds the script printed before."""
    import importlib.util

    spec_ = importlib.util.spec_from_file_location("chip_smoke_for_test", "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(smoke)
    for _, b, h, t, tk, d, dtype, causal, _ in smoke.K1_SHAPES:
        pairs = sum(min(i + 1, tk) for i in range(t)) if causal else t * tk
        flops = 4 * b * h * d * pairs
        es = 4 if dtype == "float32" else 2
        nbytes = es * (2 * b * t * h * d + 2 * b * tk * h * d) + 4 * b * h * t
        ops_ms = (3 * flops / smoke.PEAK_TF32_FLOPS if dtype == "float32"
                  else flops / smoke.PEAK_BF16_FLOPS) * 1e3
        bytes_ms = nbytes / smoke.PEAK_BYTES * 1e3
        want = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
        assert smoke.k1_bound(b, h, t, tk, d, dtype, causal)[:2] == want


def test_selected_outputs_are_what_the_runner_fetches():
    """``outputs=`` narrows the D2H the runner does, so it narrows the
    priced ``d2h_bytes`` (the reference prices every output of the
    method, though its runner fetches the selected ones only)."""
    mdef = get_model_def("lenet")
    model = mdef.to_model(mdef.init_fn(0))
    tables = []
    for outputs in (None, ("label",)):
        env = P.StreamExecutionEnvironment()
        (env.from_collection([], schema=model.method("serve").input_schema).count_window(8)
            .apply(ModelWindowFunction(model, policy=BucketPolicy(fixed_batch=8),
                                       outputs=outputs), name="lenet").sink_to_list())
        tables.append(costmodel.cost_table_for_env(env).ops[0].entries[0])
    full, label = tables
    assert label.d2h_bytes == 8 * 4 < full.d2h_bytes
    assert label.h2d_bytes == full.h2d_bytes


def test_cost_tables_go_through_json_and_back(priced):
    _, ptable, _, _, _ = priced("serving-paged")
    doc = json.loads(json.dumps(ptable.to_json()))
    again = costmodel.CostTable.from_json(doc)
    assert again.to_json() == ptable.to_json()
    assert again.op("continuous_batching").entry("decode_step") == ptable.ops[0].entry(
        "decode_step")
    # The reference loads the port's table, entry for entry.
    assert jcost.CostTable.from_json(doc).to_json() == doc


def test_pricing_allocates_on_no_device():
    """Every tensor any pricing call makes lies on ``meta``: an outer
    dispatch mode sees every op, the pricer's own walk included."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Devices(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (list, tuple)) else [out]):
                if isinstance(t, torch.Tensor):
                    self.seen[t.device.type] += 1
            return out

    envs = [PLANS[name]()[1] for name in ("lenet", "serving-paged", "widedeep-online")]
    with Devices() as mode:
        tables = [costmodel.cost_table_for_env(env) for env in envs]
    assert all(e.flops > 0 for t in tables for e in t.ops[0].entries if e.unit != "cache_move")
    assert set(mode.seen) == {"meta"} and mode.seen["meta"] > 100


def test_an_unpriceable_unit_is_a_note():
    """Fail-soft: a method that raises on meta tensors leaves a note on
    its operator, and the table still comes back."""
    from flink_tensorflow_tpu_torch.models.base import Model, ModelMethod

    schema = RecordSchema({"x": spec((4,))})

    def serve(module, inputs):
        return {"y": inputs["x"].numpy()}   # a host read: impossible on meta

    model = Model("broken", torch.nn.Linear(4, 4), {"serve": ModelMethod("serve", schema, ("y",),
                                                                         serve)})
    env = P.StreamExecutionEnvironment()
    (env.from_collection([], schema=schema).count_window(2)
        .apply(ModelWindowFunction(model, policy=BucketPolicy(fixed_batch=2)), name="broken")
        .sink_to_list())
    (op,) = costmodel.cost_table_for_env(env).ops
    assert op.entries == [] and op.predicted_signatures == ("b2",)
    assert len(op.notes) == 1 and "abstract pricing failed at b2" in op.notes[0]
