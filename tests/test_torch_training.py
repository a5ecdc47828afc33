"""Training in the port, held to the JAX package: Wide&Deep's module and
train step, the optimizers against optax, the TrainState bridge, and the
twins of every case of ``tests/test_training.py`` (online SGD on a keyed
stream, per-key models, snapshots, disk checkpoints, fused steps, the DP
gang), plus restart, rescale and snapshot-copy cases of the port's own.

Weights cross from flax to the port (``models/convert.py``); the port's
functions take them through a def whose ``init_fn`` returns them, so both
packages' jobs start from the same state.  The JAX package's DP gang case
trains LeNet, which is not ported; its twin here trains the tiny ResNet
(width 8, stages (1, 1), 32x32) on the JAX package's 8-device mesh and on
the port's one-device CPU mesh.

Tolerances:

- f32 Wide&Deep (the JAX side built as ``WideDeep(compute_dtype=
  jnp.float32)``): loss, params and adam moments within 1e-5 of the
  largest magnitude of each; whole jobs' losses within 1e-5 relative.
- bf16 Wide&Deep (the reference's definition): 3e-2.  Beyond bf16
  rounding, flax sums the gradient of a repeated id in bf16, the port in
  f32.
- The single-step comparisons use adam with ``eps=1e-3``: at optax's
  default 1e-8 a gradient within rounding of zero moves its param by up
  to ``lr`` either way (see ``tests/test_torch_resnet.py``).  The
  optimizers' arithmetic at the default eps is held to optax on identical
  gradients (1e-6 of the largest magnitude of each tensor: a moment that
  cancels to near zero keeps fewer correct bits than its inputs).
- The port's own paths against each other on the CPU (fused against
  sequential steps, a restarted job against an uninterrupted one): equal,
  bit for bit.
"""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch

pytest.importorskip("flax")

import jax
import jax.numpy as jnp
import optax

import flink_tensorflow_tpu as jax_pkg
from flink_tensorflow_tpu.functions import DPTrainWindowFunction as JaxDPTrain
from flink_tensorflow_tpu.functions import OnlineTrainFunction as JaxOnlineTrain
from flink_tensorflow_tpu.models import get_model_def as jax_model_def
from flink_tensorflow_tpu.models.zoo import widedeep as jwd
from flink_tensorflow_tpu.models.zoo._common import weighted_metrics as jax_weighted
from flink_tensorflow_tpu.parallel import make_mesh as jax_make_mesh
from flink_tensorflow_tpu.parallel.dp import init_train_state as jax_init_state
from flink_tensorflow_tpu.parallel.dp import make_train_step as jax_train_step
from flink_tensorflow_tpu.tensors import RecordSchema as JaxSchema
from flink_tensorflow_tpu.tensors import TensorValue as JaxValue
from flink_tensorflow_tpu.tensors import spec as jax_spec
from flink_tensorflow_tpu_torch import RestartStrategy, StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.checkpoint.store import (
    latest_checkpoint_id,
    read_checkpoint,
    write_checkpoint,
)
from flink_tensorflow_tpu_torch.core import functions as port_fn
from flink_tensorflow_tpu_torch.core.operators import StateNotRescalable
from flink_tensorflow_tpu_torch.core.runtime import JobFailure
from flink_tensorflow_tpu_torch.functions.training_function import (
    DPTrainWindowFunction,
    OnlineTrainFunction,
)
from flink_tensorflow_tpu_torch.models.convert import train_state_from_jax
from flink_tensorflow_tpu_torch.models.zoo._common import weighted_metrics
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.parallel import dp, optim
from flink_tensorflow_tpu_torch.parallel.mesh import make_mesh
from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, spec
from flink_tensorflow_tpu_torch.tensors.value import TensorValue

TINY = dict(hash_buckets=50, embed_dim=4, num_cat_slots=2, num_dense=3, num_wide=8, hidden=(8,))
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
STEP_EPS = 1e-3


# -- shared builders ----------------------------------------------------------

def jax_widedeep_def(dtype: str):
    """The JAX package's Wide&Deep def; at f32 the same def on
    ``WideDeep(compute_dtype=jnp.float32)`` with ``widedeep.py:76-86``'s loss."""
    jdef = jax_model_def("widedeep", **TINY)
    if dtype == "bfloat16":
        return jdef
    module = jwd.WideDeep(**{**TINY, "hidden": tuple(TINY["hidden"])}, compute_dtype=jnp.float32)

    def init_fn(rng):
        return module.init(rng, jnp.zeros((1, 8)), jnp.zeros((1, 3)), jnp.zeros((1, 2), jnp.int32))

    def loss_fn(variables, batch, rng):
        logit = module.apply(variables, batch["wide"], batch["dense"], batch["cat"])
        label = batch["label"].astype(jnp.float32)
        per_ex = optax.sigmoid_binary_cross_entropy(logit, label)
        hits = ((logit > 0) == (label > 0.5)).astype(jnp.float32)
        loss, acc = jax_weighted(per_ex, hits, batch.get("valid"))
        return loss, ({}, {"loss": loss, "accuracy": acc})

    return dataclasses.replace(jdef, module=module, init_fn=init_fn, loss_fn=loss_fn)


def port_def_like(jdef, dtype: str, arch: str = "widedeep", *, gang: bool = False, **config):
    """The port's def of ``arch`` whose initialiser returns ``jdef``'s
    weights as the JAX functions draw them for seed 0: subtask 0's for the
    online function, the gang's (no subtask fold-in) with ``gang``."""
    mdef = get_model_def(arch, compute_dtype=dtype, **(config or TINY))
    rng = jax.random.key(0) if gang else jax.random.fold_in(jax.random.key(0), 0)
    variables = jax.tree.map(np.asarray, jdef.init_fn(rng))
    return dataclasses.replace(mdef, init_fn=lambda seed: mdef.load_fn(variables))


def schemas():
    fields = {"wide": ((8,), np.float32), "dense": ((3,), np.float32),
              "cat": ((2,), np.int32), "label": ((), np.int32)}
    return (JaxSchema({k: jax_spec(s, d) for k, (s, d) in fields.items()}),
            RecordSchema({k: spec(s, d) for k, (s, d) in fields.items()}))


def make_fields(n, seed=0, users=("a", "b")):
    """``tests/test_training.py:make_records``' data (separable by user)."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        user = users[i % len(users)]
        label = 1 if user == "a" else 0
        out.append(({"wide": (rng.rand(8) * (1 + label)).astype(np.float32),
                     "dense": rng.rand(3).astype(np.float32),
                     "cat": rng.randint(0, 50, (2,)).astype(np.int32),
                     "label": np.int32(label)}, {"user": user}))
    return out


def records(fields, cls):
    return [cls(dict(f), meta=dict(m)) for f, m in fields]


def cpu_env(parallelism: int = 1) -> StreamExecutionEnvironment:
    env = StreamExecutionEnvironment(parallelism=parallelism)
    env.set_device_provider(lambda task, index: "cpu")
    return env


def online_job(pkg: str, fields, mdef, optimizer, **kw):
    """One keyed online-training job through ``pkg``; returns its sink."""
    jschema, schema = schemas()
    if pkg == "jax":
        env = jax_pkg.StreamExecutionEnvironment(parallelism=1)
        f = JaxOnlineTrain(mdef, optimizer, train_schema=jschema, **kw)
        recs = records(fields, JaxValue)
    else:
        env = cpu_env()
        f = OnlineTrainFunction(mdef, optimizer, train_schema=schema, **kw)
        recs = records(fields, TensorValue)
    out = (env.from_collection(recs).key_by(lambda r: r.meta["user"])
           .process(f, name="train").sink_to_list())
    env.execute(timeout=300)
    return out


def losses(out):
    return np.array([float(r["loss"]) for r in out])


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        elif isinstance(v, torch.Tensor):
            out[prefix + k] = v
    return out


def assert_trees_equal(a, b):
    fa, fb = flat(a), flat(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k


def rel(got: dict, want: dict) -> float:
    peak = max(float(w.abs().max()) for w in want.values())
    return max(float((got[k].float() - want[k].float()).abs().max()) for k in want) / peak


class _StubMetrics:
    @staticmethod
    def meter(name):
        class M:
            @staticmethod
            def mark(n):
                pass
        return M

    @staticmethod
    def counter(name):
        class C:
            @staticmethod
            def inc(n=1):
                pass
        return C


class _StubCtx:
    subtask_index = 0
    metrics = _StubMetrics
    device = "cpu"


class _StubPCtx:
    current_key = "a"


class _ListOut:
    def __init__(self):
        self.items = []

    def collect(self, v, ts=None):
        self.items.append(v)


# -- model and optimizer ------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_widedeep_adam_steps_match_jax(dtype):
    """One, then three adam steps on 6 records padded to 8 (pad rows
    replay record 0; ``valid`` keeps them out of the loss)."""
    from flink_tensorflow_tpu.functions.training_function import (
        _train_batch_arrays as jax_batch_arrays,
    )
    from flink_tensorflow_tpu.tensors import BucketPolicy as JaxPolicy
    from flink_tensorflow_tpu_torch.functions.training_function import _train_batch_arrays
    from flink_tensorflow_tpu_torch.tensors.batching import BucketPolicy

    jdef = jax_widedeep_def(dtype)
    jopt = optax.adam(1e-2, eps=STEP_EPS)
    jstate = jax_init_state(jdef, jopt, jax.random.key(0))
    mdef = get_model_def("widedeep", compute_dtype=dtype, **TINY)
    state = train_state_from_jax(jax.tree.map(np.asarray, {k: v for k, v in jstate.items()
                                                           if k != "rng"}), mdef)
    jstep = jax.jit(jax_train_step(jdef, jopt))
    step = dp.make_train_step(mdef, optim.adam(1e-2, eps=STEP_EPS))
    jschema, schema = schemas()
    all_fields = make_fields(18, seed=3)
    tol = TOL[dtype]
    for i in range(3):
        fields = [f for f, _ in all_fields[6 * i:6 * i + 6]]
        _, ja = jax_batch_arrays([JaxValue(f) for f in fields], jschema, JaxPolicy(fixed_batch=8))
        _, pa = _train_batch_arrays([TensorValue(f) for f in fields], schema,
                                    BucketPolicy(fixed_batch=8))
        assert pa["valid"].tolist() == [1.0] * 6 + [0.0] * 2
        jstate, jm = jstep(jstate, ja)
        state, m = step(state, {k: torch.from_numpy(v) for k, v in pa.items()})
        want = train_state_from_jax(jax.tree.map(np.asarray, {k: v for k, v in jstate.items()
                                                              if k != "rng"}), mdef)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= tol * abs(float(jm["loss"]))
        assert float(m["accuracy"]) == float(jm["accuracy"])
        assert rel(state["variables"]["params"], want["variables"]["params"]) <= tol
        for moment in ("mu", "nu"):
            assert rel(state["opt_state"][moment], want["opt_state"][moment]) <= tol
        assert int(state["step"]) == int(state["opt_state"]["count"]) == i + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_widedeep_serve_matches_jax(dtype):
    jdef = jax_widedeep_def(dtype)
    variables = jdef.init_fn(jax.random.key(5))
    fields = [f for f, _ in make_fields(5, seed=4)]
    batch = {k: np.stack([f[k] for f in fields]) for k in ("wide", "dense", "cat")}
    want = np.asarray(jax.jit(lambda v, b: jdef.module.apply(v, b["wide"], b["dense"], b["cat"]))(
        variables, batch))
    mdef = get_model_def("widedeep", compute_dtype=dtype, **TINY)
    with torch.no_grad():
        got = mdef.methods["serve"].fn(mdef.to_model(jax.tree.map(np.asarray, variables)).params,
                                       {k: torch.from_numpy(v) for k, v in batch.items()})
    assert np.abs(got["logit"].numpy() - want).max() <= TOL[dtype] * np.abs(want).max()
    np.testing.assert_allclose(got["prob"].numpy(), 1 / (1 + np.exp(-got["logit"].numpy())),
                               rtol=1e-6)


@pytest.mark.parametrize("valid", [None, [1, 1, 1, 0], [0, 0, 0, 0], [1, 0, 1, 1]])
def test_weighted_metrics_match_jax(valid):
    rng = np.random.RandomState(0)
    loss = rng.rand(4).astype(np.float32)
    hit = (rng.rand(4) > 0.5).astype(np.float32)
    v = None if valid is None else np.asarray(valid, np.float32)
    want = jax_weighted(jnp.asarray(loss), jnp.asarray(hit), None if v is None else jnp.asarray(v))
    got = weighted_metrics(torch.from_numpy(loss), torch.from_numpy(hit),
                           None if v is None else torch.from_numpy(v))
    for g, w in zip(got, want):
        assert abs(float(g) - float(w)) <= 1e-7


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_optimizers_match_optax_on_identical_gradients(name):
    rng = np.random.RandomState(0)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32)}
    jopt = optax.adam(1e-2) if name == "adam" else optax.sgd(0.1)
    opt = optim.adam(1e-2) if name == "adam" else optim.sgd(0.1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = opt.init(tp)
    ip = {k: v.clone() for k, v in tp.items()}   # the in-place twin
    istate = opt.init(ip)
    for _ in range(5):
        g = {k: (rng.standard_normal(v.shape) * 1e-3).astype(np.float32)
             for k, v in params.items()}
        g["b"][0] = 0.0   # an exactly-zero gradient
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, ju)
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        tu, ts = opt.update(tg, ts, tp)
        tp = optim.apply_updates(tp, tu)
        opt.apply_(tg, istate, ip)
        for k in params:
            for got, want in ((tu[k], ju[k]), (tp[k], jp[k])):
                want = np.asarray(want)
                assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
            assert torch.equal(ip[k], tp[k])
    if name == "adam":
        assert int(ts["count"]) == int(istate["count"]) == 5


def test_train_state_from_jax_round_trips_an_adam_state():
    """Two JAX steps, the state carried across, then one more step in each
    package: the same step number, moments and count as JAX's."""
    jdef = jax_widedeep_def("float32")
    jopt = optax.adam(1e-2, eps=STEP_EPS)
    jstate = jax_init_state(jdef, jopt, jax.random.key(1))
    jstep = jax.jit(jax_train_step(jdef, jopt))
    fields = [f for f, _ in make_fields(12, seed=2)]
    batches = [{k: np.stack([f[k] for f in fields[i:i + 4]]) for k in fields[0]}
               for i in (0, 4, 8)]
    for b in batches[:2]:
        jstate, _ = jstep(jstate, dict(b, valid=np.ones(4, np.float32)))
    host = jax.tree.map(np.asarray, {k: v for k, v in jstate.items() if k != "rng"})
    mdef = get_model_def("widedeep", compute_dtype="float32", **TINY)
    state = train_state_from_jax(host, mdef)
    adam_state = host["opt_state"][0]
    assert int(state["step"]) == 2 and int(state["opt_state"]["count"]) == 2
    np.testing.assert_array_equal(state["opt_state"]["mu"]["hidden.0.weight"].numpy(),
                                  adam_state.mu["Dense_0"]["kernel"].T)
    np.testing.assert_array_equal(state["opt_state"]["nu"]["embed.weight"].numpy(),
                                  adam_state.nu["embed"]["embedding"])
    np.testing.assert_array_equal(state["variables"]["params"]["wide.bias"].numpy(),
                                  host["variables"]["params"]["wide"]["bias"])
    last = dict(batches[2], valid=np.ones(4, np.float32))
    jstate, jm = jstep(jstate, last)
    state, m = dp.make_train_step(mdef, optim.adam(1e-2, eps=STEP_EPS))(
        state, {k: torch.from_numpy(v) for k, v in last.items()})
    want = train_state_from_jax(jax.tree.map(np.asarray, {k: v for k, v in jstate.items()
                                                          if k != "rng"}), mdef)
    assert int(state["step"]) == int(want["step"]) == 3
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * float(jm["loss"])
    assert rel(state["variables"]["params"], want["variables"]["params"]) <= 1e-5
    assert rel(state["opt_state"]["nu"], want["opt_state"]["nu"]) <= 1e-5
    sgd_host = jax.tree.map(np.asarray, {k: v for k, v in jax_init_state(
        jdef, optax.sgd(0.1), jax.random.key(1)).items() if k != "rng"})
    assert train_state_from_jax(sgd_host, mdef)["opt_state"] == {}


# -- twins of tests/test_training.py ------------------------------------------

class TestOnlineTrain:
    def test_keyed_online_sgd_loss_decreases(self):
        """Twin of ``test_training.py:83``, and equal to the JAX job."""
        jdef = jax_widedeep_def("float32")
        mdef = port_def_like(jdef, "float32")
        fields = make_fields(80)
        out = online_job("torch", fields, mdef, optim.adam(5e-2), mini_batch=4)
        got = losses(out)
        assert len(got) == 20  # 80 records / mini_batch 4
        assert np.mean(got[-4:]) < np.mean(got[:4]), got
        want = losses(online_job("jax", fields, jdef, optax.adam(5e-2), mini_batch=4))
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert [int(r["step"]) for r in out] == list(range(1, 21))

    def test_per_key_scope_independent_models(self):
        """Twin of ``test_training.py:100``."""
        jdef = jax_widedeep_def("float32")
        fields = make_fields(12, users=("a", "b", "c"))
        out = online_job("torch", fields, port_def_like(jdef, "float32"), optim.sgd(1e-2),
                         scope="key", mini_batch=2)
        by_key = {}
        for r in out:
            by_key.setdefault(r.meta["key"], []).append(int(r["step"]))
        assert set(by_key) == {"a", "b", "c"}
        for steps in by_key.values():
            assert steps == [1, 2]
        want = online_job("jax", fields, jdef, optax.sgd(1e-2), scope="key", mini_batch=2)
        key_loss = {(r.meta["key"], int(r["step"])): float(r["loss"]) for r in want}
        for r in out:
            assert abs(float(r["loss"]) - key_loss[(r.meta["key"], int(r["step"]))]) \
                <= 1e-5 * float(r["loss"])

    def _fn(self, optimizer, **kw):
        return OnlineTrainFunction(port_def_like(jax_widedeep_def("float32"), "float32"),
                                   optimizer, train_schema=schemas()[1], mini_batch=2, **kw)

    def test_snapshot_restore_roundtrip(self):
        """Twin of ``test_training.py:122``; the snapshot is a copy of the
        state, not a view of it."""
        f = self._fn(optim.sgd(1e-2))
        f.open(_StubCtx())
        out = _ListOut()
        for r in records(make_fields(4, users=("a",)), TensorValue):
            f.process_element(r, _StubPCtx, out)
        snap = f.snapshot_state()
        assert len(out.items) == 2
        assert [int(r["step"]) for r in out.items] == [1, 2]
        live = flat(f._state)
        assert all(t.data_ptr() != live[k].data_ptr() for k, t in flat(snap["state"]).items())

        g = self._fn(optim.sgd(1e-2))
        g.restore_state(snap)
        g.open(_StubCtx())
        assert_trees_equal(f.current_params(), g.current_params())

    def test_disk_checkpoint_roundtrip_with_adam(self, tmp_path):
        """Twin of ``test_training.py:148``: the snapshot survives
        write_checkpoint -> pickle -> read_checkpoint with the adam state
        intact, and a post-restore adam step continues the numbering."""
        f = self._fn(optim.adam(1e-2))
        f.open(_StubCtx())
        out = _ListOut()
        for r in records(make_fields(4, users=("a",)), TensorValue):
            f.process_element(r, _StubPCtx, out)
        snap = f.snapshot_state()
        write_checkpoint(str(tmp_path), 1, {"train": {0: snap}})
        cid, snapshots = read_checkpoint(str(tmp_path))
        assert cid == 1
        assert int(snapshots["train"][0]["state"]["opt_state"]["count"]) == 2

        g = self._fn(optim.adam(1e-2))
        g.restore_state(snapshots["train"][0])
        g.open(_StubCtx())
        assert_trees_equal(f.current_params(), g.current_params())
        out2 = _ListOut()
        for r in records(make_fields(2, seed=1, users=("a",)), TensorValue):
            g.process_element(r, _StubPCtx, out2)
        g.on_finish(out2)
        assert len(out2.items) == 1
        assert int(out2.items[0]["step"]) == 3
        assert np.isfinite(float(out2.items[0]["loss"]))


class TestDPTrainGang:
    def _recs(self, cls, n=128):
        rng = np.random.RandomState(0)
        out = []
        for i in range(n):
            label = i % 4
            img = (rng.rand(32, 32, 3) * 0.2 + label * 0.25).astype(np.float32)
            out.append(cls({"image": img, "label": np.int32(label)}))
        return out

    def test_gang_dp_training_loss_decreases(self):
        """Twin of ``test_training.py:191`` on the tiny ResNet (LeNet is
        not ported): 8 steps of 32, loss falls, the step counter reads 8,
        and the losses equal the JAX gang's on its 8-device mesh."""
        cfg = dict(num_classes=4, image_size=32, width=8, stage_sizes=(1, 1))
        jdef = jax_model_def("resnet50", **cfg)
        schema = RecordSchema({"image": spec((32, 32, 3)), "label": spec((), np.int32)})
        env = StreamExecutionEnvironment(parallelism=1)
        env.set_mesh(make_mesh({"data": 1}, devices=["cpu"]))
        out = (env.from_collection(self._recs(TensorValue) * 2).count_window(32)
               .apply(DPTrainWindowFunction(
                   port_def_like(jdef, "bfloat16", "resnet50", gang=True, **cfg),
                   optim.adam(1e-2), train_schema=schema, global_batch=32), name="dp_train")
               .sink_to_list())
        result = env.execute(timeout=600)
        got = losses(out)
        assert len(got) == 8
        assert got[-1] < got[0], got
        assert result.metrics["dp_train.0.train_steps"] == 8

        jenv = jax_pkg.StreamExecutionEnvironment(parallelism=1)
        jenv.set_mesh(jax_make_mesh({"data": 8}))
        jschema = JaxSchema({"image": jax_spec((32, 32, 3)), "label": jax_spec((), np.int32)})
        jout = (jenv.from_collection(self._recs(JaxValue) * 2).count_window(32)
                .apply(JaxDPTrain(jdef, optax.adam(1e-2), train_schema=jschema, global_batch=32))
                .sink_to_list())
        jenv.execute(timeout=600)
        np.testing.assert_allclose(got, losses(jout), rtol=TOL["bfloat16"])

    def test_gang_requires_mesh(self):
        """Twin of ``test_training.py:223``."""
        env = cpu_env()
        f = DPTrainWindowFunction(
            get_model_def("resnet50", num_classes=4, image_size=32, width=8, stage_sizes=(1, 1)),
            train_schema=RecordSchema({"image": spec((32, 32, 3)), "label": spec((), np.int32)}),
            global_batch=8)
        env.from_collection([TensorValue({"image": np.zeros((32, 32, 3), np.float32),
                                          "label": np.int32(0)})]).count_window(8).apply(f) \
            .sink_to_list()
        with pytest.raises(JobFailure) as info:
            env.execute(timeout=60)
        assert "set_mesh" in str(info.value.__cause__)

    def test_gang_rejects_parallelism_and_indivisible_batch(self):
        schema = RecordSchema({"image": spec((32, 32, 3)), "label": spec((), np.int32)})
        mdef = get_model_def("resnet50", num_classes=4, image_size=32, width=8, stage_sizes=(1, 1))
        for parallelism, match in ((2, "parallelism must be 1"),):
            env = StreamExecutionEnvironment(parallelism=parallelism)
            env.set_mesh(make_mesh({"data": 1}, devices=["cpu"]))
            env.from_collection(self._recs(TensorValue, 16)).count_window(8) \
                .apply(DPTrainWindowFunction(mdef, train_schema=schema, global_batch=8),
                       parallelism=parallelism).sink_to_list()
            with pytest.raises(JobFailure) as info:
                env.execute(timeout=60)
            assert match in str(info.value.__cause__)
        # A mesh over two processes needs a cohort of two (one device
        # each); this process is in none.
        with pytest.raises(ValueError, match="multihost.initialize"):
            make_mesh({"data": 2})

    def test_gang_restart_from_checkpoint_equals_uninterrupted(self, tmp_path):
        """A crash mid-job under ``RestartStrategy``: the restored gang
        continues from the checkpointed state (a host copy) and ends with
        the params and step of an uninterrupted run, bit for bit."""
        cfg = dict(num_classes=4, image_size=32, width=8, stage_sizes=(1, 1))
        schema = RecordSchema({"image": spec((32, 32, 3)), "label": spec((), np.int32)})
        kept = []

        class Kept(DPTrainWindowFunction):
            def clone(self):
                dup = super().clone()
                kept.append(dup)
                return dup

        class CrashOnce(port_fn.MapFunction):
            def __init__(self):
                self.seen, self.crashed = 0, False

            def clone(self):
                return self

            def map(self, value):
                self.seen += 1
                if not self.crashed and self.seen == 40:
                    self.crashed = True
                    raise RuntimeError("injected crash")
                return value

        def run(crash: bool, d=None):
            env = StreamExecutionEnvironment(parallelism=1)
            env.set_mesh(make_mesh({"data": 1}, devices=["cpu"]))
            stream = env.from_collection(self._recs(TensorValue, 64))
            if crash:
                env.enable_checkpointing(d, every_n_records=16)
                # Paced, so the gang has trained past a checkpoint when the
                # tap raises.
                env.source_throttle_s = 0.02
                stream = stream.map(CrashOnce())
            out = (stream.count_window(8)
                   .apply(Kept(get_model_def("resnet50", **cfg), optim.adam(1e-2),
                               train_schema=schema, global_batch=8), name="dp_train")
                   .sink_to_list())
            result = env.execute(timeout=300, restart_strategy=RestartStrategy(max_restarts=1)
                                 if crash else None)
            return out, result, kept[-1]

        base_out, _, base = run(False)
        out, result, final = run(True, str(tmp_path))
        assert result.restarts == 1
        assert latest_checkpoint_id(str(tmp_path)) >= 2
        assert int(final._state["step"]) == int(base._state["step"]) == 8
        assert_trees_equal(final.current_params(), base.current_params())
        steps = {int(r["step"]): float(r["loss"]) for r in out}
        assert steps == {int(r["step"]): float(r["loss"]) for r in base_out}


class TestFusedOnlineSteps:
    """Twin of ``test_training.py:239``: the fused steps are the
    sequential steps (bit for bit in the port), and partial chunks flush."""

    def _run(self, k, n=24):
        return online_job("torch", make_fields(n, users=("a",)),
                          port_def_like(jax_widedeep_def("float32"), "float32"),
                          optim.sgd(5e-2), mini_batch=2, steps_per_dispatch=k)

    def test_fused_matches_sequential(self):
        a, b = self._run(1), self._run(4)
        assert [int(r["step"]) for r in a] == [int(r["step"]) for r in b] == list(range(1, 13))
        np.testing.assert_array_equal(losses(a), losses(b))
        want = online_job("jax", make_fields(24, users=("a",)), jax_widedeep_def("float32"),
                          optax.sgd(5e-2), mini_batch=2, steps_per_dispatch=4)
        np.testing.assert_allclose(losses(b), losses(want), rtol=1e-5)

    def test_partial_chunk_flushes_at_finish(self):
        out = self._run(5)
        assert [int(r["step"]) for r in out] == list(range(1, 13))


# -- exactly-once, rescale, devices -------------------------------------------

def _crash_after(n: int, directory=None, min_id: int = 1):
    """A tap that raises once, at the ``n``-th event; with ``directory`` it
    first waits there until checkpoint ``min_id`` (cut before event ``n``)
    or a later one is on disk, so the crash comes at the same event
    however long the write takes."""
    class CrashOnce(port_fn.MapFunction):
        def __init__(self):
            self.seen, self.crashed = 0, False

        def clone(self):
            return self

        def map(self, value):
            self.seen += 1
            if not self.crashed and self.seen >= n:
                deadline = time.monotonic() + 60
                while directory is not None and (latest_checkpoint_id(directory) or 0) < min_id:
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"checkpoint {min_id} not written within 60 s")
                    time.sleep(0.005)
                self.crashed = True
                raise RuntimeError("injected crash")
            return value

    return CrashOnce()


def _keyed_job(fields, parallelism, mdef, *, scope, tap=None, d=None):
    env = cpu_env(parallelism)
    if d is not None:
        env.enable_checkpointing(d, every_n_records=8)
    if tap is not None:
        # Paced, so the trainers have passed a checkpoint when the tap raises.
        env.source_throttle_s = 0.01
    stream = env.from_collection(records(fields, TensorValue))
    if tap is not None:
        stream = stream.map(tap, parallelism=1)
    out = (stream.key_by(lambda r: r.meta["user"])
           .process(OnlineTrainFunction(mdef, optim.adam(1e-2), train_schema=schemas()[1],
                                        scope=scope, mini_batch=2, steps_per_dispatch=2),
                    name="train", parallelism=parallelism)
           .sink_to_list())
    return env, out


def test_key_scope_rescales_2_to_3_by_key_group(tmp_path):
    """Per-key TrainStates checkpointed at parallelism 2 and restored at 3
    land with their keys' new subtasks: every (key, step) emitted across
    both runs carries the loss of an uninterrupted run, and each key
    reaches its last step."""
    mdef = port_def_like(jax_widedeep_def("float32"), "float32")
    users = ("a", "b", "c", "d", "e")
    fields = make_fields(100, users=users)
    env, base = _keyed_job(fields, 2, mdef, scope="key")
    env.execute(timeout=300)
    want = {(r.meta["key"], int(r["step"])): float(r["loss"]) for r in base}
    d = str(tmp_path)
    env1, out1 = _keyed_job(fields, 2, mdef, scope="key", tap=_crash_after(60), d=d)
    with pytest.raises(JobFailure):
        env1.execute(timeout=300)
    cid = latest_checkpoint_id(d)
    assert cid is not None
    env2, out2 = _keyed_job(fields, 3, mdef, scope="key")
    env2.execute(timeout=300, restore_from=d, restore_checkpoint_id=cid)
    assert out2, "the restored run trained nothing"
    got = {}
    for r in list(out1) + list(out2):
        k = (r.meta["key"], int(r["step"]))
        assert got.setdefault(k, float(r["loss"])) == float(r["loss"]), k
    assert got == want
    assert {u: max(s for k, s in got if k == u) for u in users} == {u: 10 for u in users}


def test_subtask_scope_refuses_rescale(tmp_path):
    mdef = port_def_like(jax_widedeep_def("float32"), "float32")
    fields = make_fields(60, users=("a", "b", "c"))
    d = str(tmp_path)
    env1, _ = _keyed_job(fields, 2, mdef, scope="subtask", tap=_crash_after(40), d=d)
    with pytest.raises(JobFailure):
        env1.execute(timeout=300)
    env2, _ = _keyed_job(fields, 3, mdef, scope="subtask")
    with pytest.raises(StateNotRescalable, match="scope='key'"):
        env2.execute(timeout=300, restore_from=d)


def test_online_restart_strategy_is_exactly_once(tmp_path):
    """A crash under ``RestartStrategy(max_restarts=1)`` with checkpoints
    every 8 records: the final TrainState and step equal those of the same
    job with the same checkpoints and no crash, bit for bit (no step lost,
    none doubled).  The reference is checkpointed too: a barrier runs the
    staged mini-batches of every key at once (``snapshot_state``, as the
    JAX package does), which reorders the steps of a subtask's shared
    model against a run without barriers."""
    mdef = port_def_like(jax_widedeep_def("float32"), "float32")
    fields = make_fields(64, users=("a", "b", "c"))
    kept = []

    class Kept(OnlineTrainFunction):
        def clone(self):
            dup = super().clone()
            kept.append(dup)
            return dup

    def run(tap=None, d=None):
        env = cpu_env()
        if d is not None:
            env.enable_checkpointing(d, every_n_records=8)
            env.source_throttle_s = 0.01
        stream = env.from_collection(records(fields, TensorValue))
        if tap is not None:
            stream = stream.map(tap)
        stream.key_by(lambda r: r.meta["user"]).process(
            Kept(mdef, optim.adam(1e-2), train_schema=schemas()[1], mini_batch=4,
                 steps_per_dispatch=3), name="train").sink_to_list()
        result = env.execute(timeout=300, restart_strategy=RestartStrategy(max_restarts=1))
        return result, kept[-1]

    _, base = run(d=str(tmp_path / "plain"))
    result, final = run(_crash_after(37), str(tmp_path / "crash"))
    assert result.restarts == 1
    assert latest_checkpoint_id(str(tmp_path / "crash")) >= 4
    assert int(final._state["step"]) == int(base._state["step"]) == 18   # 6 steps per user
    assert_trees_equal(final._state, base._state)
    assert all(t.device.type == "cpu" for t in flat(final._state).values())


def test_training_entry_points_need_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh({"data": 1})
    mdef = get_model_def("widedeep", **TINY)
    env = StreamExecutionEnvironment(parallelism=1)
    env.from_collection(records(make_fields(4), TensorValue)).key_by(lambda r: r.meta["user"]) \
        .process(OnlineTrainFunction(mdef, train_schema=schemas()[1], mini_batch=2)).sink_to_list()
    with pytest.raises(JobFailure) as info:
        env.execute(timeout=60)
    assert "CUDA is not available" in str(info.value.__cause__)


def test_train_schema_rejects_synthesized_names():
    mdef = get_model_def("widedeep", **TINY)
    with pytest.raises(ValueError, match="valid"):
        OnlineTrainFunction(mdef, train_schema=RecordSchema({"valid": spec(())}))
    with pytest.raises(ValueError, match="tokens_len"):
        DPTrainWindowFunction(mdef, global_batch=2, train_schema=RecordSchema(
            {"tokens": spec((None,), np.int32), "tokens_len": spec((), np.int32)}))
    with pytest.raises(ValueError, match="scope"):
        OnlineTrainFunction(mdef, train_schema=schemas()[1], scope="global")


def test_no_port_module_imports_optax_or_flax():
    import sys

    port = [m for m in sys.modules if m.startswith("flink_tensorflow_tpu_torch")]
    assert "flink_tensorflow_tpu_torch.functions.training_function" in port
    for name in port:
        src = getattr(sys.modules[name], "__file__", None)
        if src and os.path.exists(src):
            text = open(src).read()
            assert "import optax" not in text and "import flax" not in text, name


def test_widedeep_cell_restart_is_exactly_once(tmp_path):
    """The widedeep-online cell's job (``functions/train_cell.py``) at 2048
    events on the CPU, checkpointed every 256 events, with and without a
    crash after 700 under ``RestartStrategy``: equal final TrainStates and
    the expected step count.  Every user's mini-batches stay staged until a
    barrier or the end (16 users x 4 mini-batches < a chunk of 16), so the
    staged keys' order, restored from the snapshot, orders the steps."""
    from flink_tensorflow_tpu_torch.functions import train_cell as cell

    mdef, schema, events = cell.widedeep_cell(records=2048)
    cpu = dict(device_provider=lambda task, index: "cpu", every_n_records=256)
    plain = cell.run_widedeep(mdef, schema, events, checkpoint_dir=str(tmp_path / "a"), **cpu)
    tap = _crash_after(1500, str(tmp_path / "b"), min_id=4)
    crashed = cell.run_widedeep(mdef, schema, events, checkpoint_dir=str(tmp_path / "b"),
                                tap=tap, max_restarts=1, throttle_s=0.0005, **cpu)
    assert tap.crashed
    assert crashed.env.metric_registry.report()["recovery.restarts_total"] == 1
    want = cell.expected_steps(events)
    assert int(plain.function._state["step"]) == int(crashed.function._state["step"]) == want
    assert_trees_equal(crashed.function._state, plain.function._state)
    assert len({(r.meta["key"], int(r["step"])) for r in plain.results}) == want


def test_widedeep_cell_is_chaotic_past_its_first_checkpoint(tmp_path):
    """Why ``chip_smoke.py`` holds the card's widedeep-online job to a CPU
    run at checkpoint 1 and not at the end: the full cell (8192 events,
    bf16) from params moved by 1e-7 relative agrees with the unmoved run at
    checkpoint 1 (23 steps) to 1e-5 by norm, and its final state is more
    than 1e-2 away (one model, 16 users' label rules, adam at eps 1e-8)."""
    from flink_tensorflow_tpu_torch.functions import train_cell as cell

    mdef, schema, events = cell.widedeep_cell()
    g = torch.Generator().manual_seed(1)

    def moved(seed, init=mdef.init_fn):
        module = init(seed)
        with torch.no_grad():
            for p in module.parameters():
                p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=g))
        return module

    runs = [cell.run_widedeep(d, schema, events, checkpoint_dir=str(tmp_path / n),
                              device_provider=lambda task, index: "cpu")
            for n, d in (("a", mdef), ("b", dataclasses.replace(mdef, init_fn=moved)))]
    start = dp.init_train_state(mdef, optim.adam(cell.WIDEDEEP_LR), dp.fold_in(0, 0))
    p0 = flat(start["variables"]["params"])

    def update_err(a, b):
        a, b = flat(a["variables"]["params"]), flat(b["variables"]["params"])
        diff = sum(float((a[k] - b[k]).double().square().sum()) for k in b)
        return (diff / sum(float((b[k] - p0[k]).double().square().sum()) for k in b)) ** 0.5

    first = [read_checkpoint(str(tmp_path / n), 1)[1]["online_train"][0]["function"]["state"]
             for n in ("a", "b")]
    assert int(first[0]["step"]) == int(first[1]["step"]) == 23
    assert update_err(first[1], first[0]) <= 1e-5
    assert update_err(runs[1].function._state, runs[0].function._state) > 1e-2


def test_a_cancelled_attempt_dispatches_no_step_after_close(tmp_path, monkeypatch):
    """A cancelled attempt closes with staged mini-batches.  The runtime
    takes no final snapshot of its subtasks (a snapshot runs the staged
    steps: it would train a closed function, leave its state on the
    device, and could ack a pending checkpoint with steps the replay runs
    again).  They replay from the checkpoint instead; the attempt that
    reaches the end of input is snapshotted once more after it closes."""
    from flink_tensorflow_tpu_torch.functions import train_cell as cell

    closed, staged_at_close, late, snapped = set(), [], [], []
    close, dispatch = OnlineTrainFunction.close, OnlineTrainFunction._run_steps_fused
    snapshot = OnlineTrainFunction.snapshot_state

    def closing(self):
        staged_at_close.append(sum(len(v) for v in self._staged.values()))
        close(self)
        closed.add(id(self))

    def dispatching(self, key, chunk, *, fused):
        if id(self) in closed:
            late.append(key)
        dispatch(self, key, chunk, fused=fused)

    def snapshotting(self):
        if id(self) in closed:
            snapped.append(len(closed))
        return snapshot(self)

    monkeypatch.setattr(OnlineTrainFunction, "close", closing)
    monkeypatch.setattr(OnlineTrainFunction, "_run_steps_fused", dispatching)
    monkeypatch.setattr(OnlineTrainFunction, "snapshot_state", snapshotting)
    mdef, schema, events = cell.widedeep_cell(records=1024)
    tap = _crash_after(700, str(tmp_path), min_id=2)
    crashed = cell.run_widedeep(mdef, schema, events, checkpoint_dir=str(tmp_path), tap=tap,
                                every_n_records=256, max_restarts=1, throttle_s=0.0005,
                                device_provider=lambda task, index: "cpu")
    assert tap.crashed and len(staged_at_close) == 2
    assert staged_at_close[0] > 0     # the cancelled attempt had staged steps
    assert late == []
    assert snapped == [2]             # the restarted attempt's, none of the cancelled one
    assert int(crashed.function._state["step"]) == cell.expected_steps(events)


def test_resnet_cell_gang_equals_a_direct_loop_of_its_step():
    """The resnet-train cell's job (``functions/train_cell.py``) at a tiny
    size on the CPU mesh, held to a direct loop of ``make_dp_train_step``
    over the same batches (``chip_smoke.py`` phase 7 (a) on the card):
    equal losses and final state, bit for bit."""
    from flink_tensorflow_tpu_torch.functions import train_cell as cell
    from flink_tensorflow_tpu_torch.functions.training_function import _train_batch_arrays
    from flink_tensorflow_tpu_torch.parallel.mesh import replicate, shard_batch
    from flink_tensorflow_tpu_torch.tensors.batching import BucketPolicy

    mdef, schema, records = cell.resnet_cell(records=24, image_size=32, num_classes=10,
                                             width=8, stage_sizes=(1, 1))
    mesh = make_mesh({"data": 1}, devices=["cpu"])
    run = cell.run_resnet(mdef, schema, records, mesh, batch=8)
    assert [int(r["step"]) for r in run.results] == [1, 2, 3]
    opt = optim.adam(cell.RESNET_LR)
    state = replicate(mesh, dp.init_train_state(mdef, opt, 0))
    step = dp.make_dp_train_step(mdef, opt, mesh)
    losses = []
    for i in range(3):
        _, arrays = _train_batch_arrays(records[8 * i:8 * i + 8], schema,
                                        BucketPolicy(fixed_batch=8))
        state, m = step(state, shard_batch(mesh, arrays), i)
        losses.append(float(m["loss"]))
    assert losses == [float(r["loss"]) for r in run.results]
    assert_trees_equal(run.function.current_params(), state["variables"])
    assert cell.rate(run.arrivals, 8) > 0
