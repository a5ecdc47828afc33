"""The port's continuous-batching operator, driven by the port's subtask
loop on the CPU, held against the JAX package's serving pipeline
(``tests/test_serving.py:run_pipeline``) on the same weights: per-session
token streams must be equal.  Also: batched == solo, preemption under a
small budget (device-resident and host blocks) is byte-identical, and a
mid-generation snapshot restored into a fresh operator continues
byte-identically.
"""

import dataclasses
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flink_tensorflow_tpu import StreamExecutionEnvironment
from flink_tensorflow_tpu import serving as jax_serving
from flink_tensorflow_tpu.models import get_model_def as jax_model_def
from flink_tensorflow_tpu_torch.core.runtime import KeyedSubtask
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.serving import (
    ContinuousBatchingOperator,
    DeviceKVBlock,
    GenerateRequest,
    KVBlock,
    ServingConfig,
    TokenBudgetScheduler,
)

CAPACITY = 40
CFG = dict(vocab_size=48, embed_dim=32, num_heads=2, num_layers=2, capacity=CAPACITY)


@pytest.fixture(scope="module")
def weights():
    return get_model_def("char_transformer", **CFG).init_params(0)


@pytest.fixture(scope="module")
def model(weights):
    return get_model_def("char_transformer", **CFG).to_model(weights)


def make_requests(n, max_new=8, seed=3, cls=GenerateRequest):
    rng = np.random.RandomState(seed)
    return [cls(session_id=f"s{i}", prompt=rng.randint(1, 48, (int(rng.randint(4, 10)),)),
                max_new_tokens=max_new)
            for i in range(n)]


def tokens_by_session(events):
    out = {}
    for ev in events:
        if ev.index < 0:
            continue
        prev = out.setdefault(ev.session_id, {}).get(ev.index)
        assert prev is None or prev == ev.token, (ev.session_id, ev.index)
        out[ev.session_id][ev.index] = ev.token
    return {sid: [toks[i] for i in sorted(toks)] for sid, toks in out.items()}


def serve(model, requests, config):
    op = ContinuousBatchingOperator("continuous_batching", model, config, device="cpu")
    sub = KeyedSubtask(op)
    events = sub.run(requests)
    return tokens_by_session(events), op, sub


def test_matches_jax_pipeline(model, weights):
    jdef = jax_model_def("char_transformer", **CFG)
    jmodel = jdef.to_model(jax.tree.map(jnp.asarray, weights))
    jreqs = make_requests(10, seed=3, cls=jax_serving.GenerateRequest)
    cfg = dict(max_active_seqs=4, token_budget=64, capacity=CAPACITY)
    env = StreamExecutionEnvironment(parallelism=1)
    out = jax_serving.continuous_batching(
        env.from_collection(jreqs, parallelism=1).key_by(lambda r: r.session_id),
        jmodel, config=jax_serving.ServingConfig(**cfg)).sink_to_list()
    env.execute("jax-serve", timeout=300)
    want = tokens_by_session(out)
    got, op, _ = serve(model, make_requests(10, seed=3), ServingConfig(**cfg))
    assert set(got) == {f"s{i}" for i in range(10)}
    assert got == want
    assert op._sched.counters.evicted == 10


def test_batched_equals_solo(model):
    reqs = make_requests(5, max_new=5, seed=7)
    cfg = ServingConfig(max_active_seqs=4, token_budget=200, capacity=CAPACITY)
    batched, _, _ = serve(model, reqs, cfg)
    for r in reqs:
        solo, _, _ = serve(model, [r], cfg)
        assert solo[r.session_id] == batched[r.session_id]


@pytest.mark.parametrize("resident", [True, False], ids=["device_blocks", "host_blocks"])
def test_preemption_is_byte_identical(model, resident):
    reqs = make_requests(6, max_new=8, seed=5)
    loose, _, _ = serve(model, reqs, ServingConfig(
        max_active_seqs=4, token_budget=1000, capacity=CAPACITY))
    tight, op, sub = serve(model, reqs, ServingConfig(
        max_active_seqs=4, token_budget=30, capacity=CAPACITY,
        device_resident_blocks=resident))
    assert tight == loose and all(len(v) == 8 for v in tight.values())
    rep = sub.ctx.metrics.report()
    assert rep["continuous_batching.0.preempted"] >= 1
    if resident:
        assert rep["continuous_batching.0.cache_resident_moves"] >= 2
        assert rep["continuous_batching.0.cache_h2d_blocks"] == 0
        assert rep["continuous_batching.0.cache_d2h_blocks"] == 0
    else:
        assert rep["continuous_batching.0.cache_d2h_blocks"] >= 1
        assert rep["continuous_batching.0.cache_h2d_blocks"] >= 1


def test_snapshot_restore_continues_byte_identically(model):
    reqs = make_requests(6, max_new=12, seed=2)
    cfg = ServingConfig(max_active_seqs=3, token_budget=40, capacity=CAPACITY)
    ref, _, _ = serve(model, reqs, cfg)

    first = KeyedSubtask(ContinuousBatchingOperator("continuous_batching", model, cfg,
                                                    device="cpu"))
    first.open()
    for r in reqs:
        first.process(r)
    for _ in range(4):
        first.fire_due()
    active = dict(first.operator._sched.active)
    assert active  # the barrier lands mid-generation
    snap = pickle.loads(pickle.dumps(first.snapshot(checkpoint_id=1)))
    first.close()

    second = KeyedSubtask(ContinuousBatchingOperator("continuous_batching", model, cfg,
                                                     device="cpu"))
    second.open(restore=snap)
    second.finish()
    second.close()
    assert second.operator._runner.block_h2d_events >= len(active)
    merged = tokens_by_session(first.emitted + second.emitted)
    assert merged == ref


def test_step_h2d_is_the_per_slot_vectors(model):
    reqs = make_requests(8, max_new=8)
    cfg = ServingConfig(max_active_seqs=4, token_budget=1000, capacity=CAPACITY)
    _, op, sub = serve(model, reqs, cfg)
    rep = sub.ctx.metrics.report()
    steps = rep["continuous_batching.0.serving_steps"]
    # tokens[S]*4 + lengths[S]*4 + mask[S] per step, plus prefill's
    # tokens[B, T]*4 + lengths/slots — far below one cache block.
    assert rep["continuous_batching.0.step_h2d_bytes"] <= steps * 4 * (4 * 9 + 8 * 16 * 4 + 64)
    assert rep["continuous_batching.0.cache_h2d_blocks"] == 0


def test_rejects_oversized_and_ignores_duplicates(model):
    big = GenerateRequest(session_id="big", prompt=np.ones((CAPACITY,), np.int32),
                          max_new_tokens=8)
    dup = make_requests(1, max_new=4)[0]
    op = ContinuousBatchingOperator("continuous_batching", model,
                                    ServingConfig(capacity=CAPACITY), device="cpu")
    events = KeyedSubtask(op).run([big, dup, dup])
    rejected = [e for e in events if e.session_id == "big"]
    assert len(rejected) == 1 and rejected[0].meta["rejected"] == "capacity"
    assert len(tokens_by_session(events)[dup.session_id]) == 4


def test_host_block_pickles_device_block_refuses():
    k = np.zeros((2, 8, 2, 4), np.float32)
    rt = pickle.loads(pickle.dumps(KVBlock(k, k, 5)))
    assert rt.length == 5 and rt.k.shape == k.shape
    dblk = DeviceKVBlock(torch.zeros(2, 8, 2, 4), torch.zeros(2, 8, 2, 4), 5)
    with pytest.raises(TypeError, match="device-resident"):
        pickle.dumps(dblk)
    host = dblk.to_host()
    assert isinstance(host, KVBlock) and host.length == 5


def _page_gate(key, length):
    """A stand-in for the paged pool's page check: refuses some sessions
    (the same ones for both schedulers)."""
    return (int(key[1:]) * 7 + length) % 4 != 0


@pytest.mark.parametrize("seed, knobs", [
    pytest.param(0, {}, id="0"), pytest.param(1, {}, id="1"), pytest.param(2, {}, id="2"),
    pytest.param(0, {"admit_gate": True}, id="admit_gate-0"),
    pytest.param(1, {"admit_gate": True}, id="admit_gate-1"),
    pytest.param(0, {"admit_hysteresis": 2}, id="admit_hysteresis-0"),
    pytest.param(1, {"admit_hysteresis": 3, "admit_gate": True}, id="admit_hysteresis-gate-1"),
    pytest.param(0, {"padding_buckets": False}, id="padding_buckets-0"),
])
def test_scheduler_matches_jax_scheduler(seed, knobs):
    """The copied scheduler makes the same decisions as the JAX one on a
    random sequence of arrivals, steps, finishes and preemptions, with the
    paged pool's admission gate, admission hysteresis, and with or without
    padding buckets (whose shape ladders, step shapes and page partitions
    match too)."""
    knobs = dict(knobs)
    gate = _page_gate if knobs.pop("admit_gate", False) else None
    cfg = dict(max_active_seqs=3, token_budget=40, capacity=64, **knobs)
    ours_cfg, theirs_cfg = ServingConfig(**cfg), jax_serving.ServingConfig(**cfg)
    assert ours_cfg.compile_signatures() == theirs_cfg.compile_signatures()
    assert ours_cfg.resolved_hbm_pages() == theirs_cfg.resolved_hbm_pages()
    for groups in (1, 2, 3, 7, 128):
        assert ours_cfg.page_partition(groups) == theirs_cfg.page_partition(groups)
    for n in range(0, 70, 3):
        assert ours_cfg.bucket_prompt_len(n) == theirs_cfg.bucket_prompt_len(n)
        assert ours_cfg.bucket_admit(n % 5) == theirs_cfg.bucket_admit(n % 5)
    ours = TokenBudgetScheduler(ours_cfg)
    theirs = jax_serving.TokenBudgetScheduler(theirs_cfg)
    rng = np.random.RandomState(seed)
    lengths = {}
    for step in range(60):
        for _ in range(rng.randint(0, 3)):
            key = f"k{len(lengths)}"
            lengths[key] = int(rng.randint(2, 12))
            ours.enqueue(key)
            theirs.enqueue(key)
        assert ours.plan_admissions(lengths.get, gate) == theirs.plan_admissions(lengths.get, gate)
        for key in list(ours.active):
            ours.grow(key)
            theirs.grow(key)
        if ours.active and rng.rand() < 0.3:
            key = next(iter(ours.active))
            assert ours.release(key, reason="finished") == theirs.release(key, reason="finished")
        victims = ours.over_budget()
        assert victims == theirs.over_budget()
        for key in victims:
            lengths[key] = ours.lengths[key]
            assert ours.preempt(key) == theirs.preempt(key)
        assert (dict(ours.active), ours.lengths, list(ours.waiting), ours.tokens_in_use) == \
            (dict(theirs.active), theirs.lengths, list(theirs.waiting), theirs.tokens_in_use)
    assert dataclasses.asdict(ours.counters) == dataclasses.asdict(theirs.counters)
