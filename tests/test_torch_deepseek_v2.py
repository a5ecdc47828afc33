"""DeepSeek-V2 in the port (``models/zoo/deepseek_v2.py``) on the CPU, at
a size that keeps every mechanism: a dense first layer, then three expert
layers of 8 experts (top-2, 2 shared), no q compression, and YaRN (factor
4 over an original length of 16) with positions run past 16.  Held to the
plain reference beside these tests (``tests/_deepseek_v2_reference.py``,
float64, the whole sequence at once) on seeded weights: prefill logits,
then prefill and decode through the dense and the paged runner's latent
pools at every position; a preempted session's latent cache round trip;
the grouped expert path against a loop over experts; the scheduler's
prefill token budget; and the step probe's counts.

The port runs in float32 here: it differs from the float64 reference by
float32 rounding in another order of sums, about 1e-6 of the logits'
spread through four layers; each comparison allows 1e-4 of it.
"""

import numpy as np
import pytest
import torch
from _deepseek_v2_reference import experts_loop, forward, rope_table

from flink_tensorflow_tpu_torch.core.runtime import KeyedSubtask
from flink_tensorflow_tpu_torch.functions.runner import DecodeStepRunner, PagedDecodeStepRunner
from flink_tensorflow_tpu_torch.models.zoo import deepseek_v2 as ds
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.serving import (
    ContinuousBatchingOperator,
    GenerateRequest,
    ServingConfig,
    TokenBudgetScheduler,
)

YARN = {"type": "yarn", "factor": 4, "original_max_position_embeddings": 16,
        "beta_fast": 32, "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707}
TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=48, moe_intermediate_size=16,
            num_hidden_layers=4, num_attention_heads=2, n_routed_experts=8,
            n_shared_experts=2, num_experts_per_tok=2, first_k_dense_replace=1,
            kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8,
            rms_norm_eps=1e-6, rope_theta=10000.0, rope_scaling=YARN,
            routed_scaling_factor=1.0, compute_dtype="float32", q_lora_rank=None)
CAPACITY = 32
#: Of the logits' spread (float32 against float64; see the docstring).
TOL = 1e-4


@pytest.fixture(scope="module")
def model():
    return get_model_def("deepseek_v2", **TINY).to_model(5)


def _params(model):
    return dict(model.params.named_parameters())


def _ref_logits(model, seq):
    return forward(_params(model), model.params.c, torch.as_tensor(seq)).float()


def _close(got, want):
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    spread = want.std(dim=-1, keepdim=True)
    assert ((got - want).abs() / spread).max() < TOL


def _prompts(seed, n, lo=5, hi=14):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, TINY["vocab_size"], int(rng.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


def _capture_logits(module):
    """Every ``[B, vocab]`` logits the module takes its argmax of, in order."""
    seen = []
    plain = type(module)._logits

    def logits(h):
        out = plain(module, h)
        seen.append(out.detach().clone())
        return out

    module._logits = logits
    return seen


def test_published_widths_build_on_meta_with_the_published_count():
    config = {"attention_bias": False, "first_k_dense_replace": 1, "hidden_act": "silu",
              "hidden_size": 2048, "intermediate_size": 10944, "kv_lora_rank": 512,
              "max_position_embeddings": 163840, "model_type": "deepseek_v2",
              "moe_intermediate_size": 1408, "moe_layer_freq": 1, "n_group": 1,
              "n_routed_experts": 64, "n_shared_experts": 2, "norm_topk_prob": False,
              "num_attention_heads": 16, "num_experts_per_tok": 6, "num_hidden_layers": 27,
              "num_key_value_heads": 16, "q_lora_rank": None, "qk_nope_head_dim": 128,
              "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06,
              "rope_scaling": dict(YARN, factor=40, original_max_position_embeddings=4096),
              "rope_theta": 10000, "routed_scaling_factor": 1, "scoring_func": "softmax",
              "seq_aux": True, "tie_word_embeddings": False, "topk_group": 1,
              "topk_method": "greedy", "v_head_dim": 128, "vocab_size": 102400,
              "compute_dtype": "bfloat16"}
    mdef = get_model_def("deepseek_v2", **config)
    with torch.device("meta"):
        module = mdef.make_module()
    assert sum(p.numel() for p in module.parameters()) == 15_706_484_224
    assert all(p.dtype == torch.bfloat16 for p in module.parameters())
    spec = module.kv_cache_spec()
    assert (spec.layers, spec.parts) == (27, ((1, 512), (1, 64)))
    assert module.scale == pytest.approx(0.11472, abs=5e-6)
    with pytest.raises(ValueError):
        get_model_def("deepseek_v2", **dict(config, q_lora_rank=1536))


def test_yarn_rope_table_follows_the_published_one():
    sc = dict(YARN, factor=40, original_max_position_embeddings=4096)
    pos = torch.arange(9000)
    inv = ds.yarn_inv_freq(64, 10000.0, sc, "cpu")
    freqs = pos.double()[:, None] * inv.double()
    emb = torch.cat([freqs, freqs], -1)
    cos, sin = rope_table(64, 10000.0, sc, 9000)
    # The port's table is float32: its angles at position 9,000 carry
    # float32's rounding of about 1e-3 rad.
    assert (emb.cos() * ds.rope_scale(sc) - cos).abs().max() < 2e-3
    assert (emb.sin() * ds.rope_scale(sc) - sin).abs().max() < 2e-3


def test_prefill_logits_match_the_reference(model):
    prompts = _prompts(1, 3)
    t = max(len(p) for p in prompts)
    tokens = torch.zeros((3, t), dtype=torch.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = torch.as_tensor(p)
    got = model.params.last_logits({"tokens": tokens,
                                    "lengths": torch.tensor([len(p) for p in prompts])})
    for i, p in enumerate(prompts):
        _close(got[i], _ref_logits(model, p)[-1])


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_prefill_then_decode_through_the_runner_matches_the_reference(model, paged):
    """Three sessions of 5-13 prompt tokens prefilled in one padded batch
    into the latent pool, then 14 decode steps, so positions pass YaRN's
    original 16: every step's logits of every session against the
    reference's full forward over the prompt and the served tokens."""
    kw = dict(pool_slots=4, capacity=CAPACITY, prompt_buckets=(8, 16), device="cpu")
    runner = (PagedDecodeStepRunner(model, page_tokens=8, **kw) if paged
              else DecodeStepRunner(model, **kw))
    runner.open()
    assert runner._module is model.params           # in place, no copy
    spec = model.params.kv_cache_spec()
    assert runner._kc.shape[1:] == (spec.layers, runner._kc.shape[2], 1, 16)
    assert runner._vc.shape[3:] == (1, 8)
    seen = _capture_logits(runner._module)
    try:
        prompts = _prompts(2, 3)
        slots = [0, 2, 3]
        first = runner.prefill(prompts, [len(p) for p in prompts], slots, batch_bucket=4)
        served = [[int(t)] for t in first]
        lengths = [len(p) for p in prompts]
        rows = [seen[-1][:3]]
        for _ in range(14):
            tokens, lens = [0] * 4, [0] * 4
            for s, slot in enumerate(slots):
                tokens[slot], lens[slot] = served[s][-1], lengths[s]
            if paged:
                for s, slot in enumerate(slots):
                    assert runner.ensure_writable(slot, lengths[s])
            out = runner.decode_step(tokens, lens, slots)
            rows.append(seen[-1][slots])
            for s, slot in enumerate(slots):
                served[s].append(int(out[slot]))
                lengths[s] += 1
    finally:
        del runner._module._logits
    for s, p in enumerate(prompts):
        ref = _ref_logits(model, np.concatenate([p, served[s][:-1]]))
        got = torch.stack([r[s] for r in rows])
        _close(got, ref[len(p) - 1:])
        assert served[s] == ref[len(p) - 1:].argmax(-1).tolist()


def _serve(model, requests, config):
    op = ContinuousBatchingOperator("continuous_batching", model, config, device="cpu")
    sub = KeyedSubtask(op)
    out = {}
    for ev in sub.run(requests):
        if ev.index >= 0:
            out.setdefault(ev.session_id, {})[ev.index] = ev.token
    return {k: [v[i] for i in sorted(v)] for k, v in out.items()}, sub


def _requests(n, max_new, seed):
    return [GenerateRequest(session_id=f"s{i}", prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(_prompts(seed, n, 4, 10))]


@pytest.mark.parametrize("cfg", [dict(device_resident_blocks=True),
                                 dict(device_resident_blocks=False),
                                 dict(paged_kv=True, page_tokens=8)],
                         ids=["device_blocks", "host_blocks", "paged"])
def test_preempted_latent_cache_round_trips(model, cfg):
    """Under a token budget that forces preemption, every session's
    latent cache leaves the pool (extract_block, or parked pages) and
    comes back (insert_block, attach): its tokens equal an unpreempted
    run's, which follow the reference."""
    reqs = _requests(5, 9, 4)
    loose, _ = _serve(model, reqs, ServingConfig(max_active_seqs=4, token_budget=1000,
                                                 capacity=CAPACITY))
    tight, sub = _serve(model, reqs, ServingConfig(max_active_seqs=4, token_budget=36,
                                                   capacity=CAPACITY, **cfg))
    assert tight == loose and all(len(v) == 9 for v in tight.values())
    assert sub.ctx.metrics.report()["continuous_batching.0.preempted"] >= 1
    for r in reqs[:2]:
        ref = _ref_logits(model, np.concatenate([r.prompt, loose[r.session_id][:-1]]))
        assert loose[r.session_id] == ref[len(r.prompt) - 1:].argmax(-1).tolist()


def test_host_block_shapes_are_the_latent_parts(model):
    runner = DecodeStepRunner(model, pool_slots=2, capacity=CAPACITY, device="cpu",
                              prompt_buckets=(8,))
    runner.open()
    runner.prefill([np.arange(1, 7, dtype=np.int32)], [6], [1])
    k, v = runner.extract_block(1, 6, host=True)
    assert k.shape == (4, CAPACITY, 1, 16) and v.shape == (4, CAPACITY, 1, 8)
    # Written up to the prompt's bucket (8), zero past it.
    assert np.abs(k[:, :6]).min() > 0 and not np.abs(k[:, 8:]).any()
    runner.insert_block(0, k, v)
    assert torch.equal(runner._kc[0], runner._kc[1]) and torch.equal(runner._vc[0], runner._vc[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_experts_equal_a_loop_over_experts(dtype):
    """An empty expert (no token routed to it) included."""
    gen = torch.Generator().manual_seed(0)
    n, d, f, e, k = 11, 32, 16, 8, 2
    x = torch.randn(n, d, generator=gen)
    w13 = torch.randn(e * 2 * f, d, generator=gen) / d ** 0.5
    w2 = torch.randn(e * d, f, generator=gen) / f ** 0.5
    experts = torch.randint(0, e - 1, (n, k), generator=gen)   # expert e-1 empty
    experts[:, 1] = (experts[:, 0] + 1 + torch.randint(0, e - 3, (n,), generator=gen)) % (e - 1)
    weights = torch.rand(n, k, generator=gen)
    got = ds.grouped_experts(x.to(dtype), weights, experts, w13.to(dtype), w2.to(dtype), e)
    want = experts_loop(x.to(dtype).double(), weights.double(), experts,
                        w13.to(dtype).double(), w2.to(dtype).double(), e)
    # float32: sums in another order; bfloat16: the grouped path rounds
    # its gate, up and down products once each to bf16 (2^-8 relative).
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    assert ((got.double() - want).abs().max() / want.abs().max()) < tol


def test_the_traced_step_probe_counts_rows_experts_and_live_bytes(model):
    from flink_tensorflow_tpu_torch.metrics.registry import MetricGroup

    class Spans:
        def span(self, *a, **k):
            self.last = (a, k)

        def instant(self, *a, **k):
            pass

    runner = DecodeStepRunner(model, pool_slots=4, capacity=CAPACITY, device="cpu")
    runner.open()
    runner._metrics = MetricGroup("t")
    runner._tracer, runner._trace_track = Spans(), "t.0"
    runner.prefill(_prompts(3, 2), [7, 9], [0, 3], batch_bucket=2)
    runner.decode_step([5, 0, 0, 6], [7, 0, 0, 9], [0, 3])
    got = {name: runner._metrics.histogram(name).values for name in
           ("moe_routed_rows", "latent_live_bytes", "moe_experts_touched")}
    assert got["moe_routed_rows"] == [2 * 2 * 3]                 # live rows x top-k x layers
    assert got["latent_live_bytes"] == [(8 + 10) * (16 + 8) * 4 * 4]
    assert 3 <= got["moe_experts_touched"][0] <= 3 * 8
    args = runner._tracer.last[1]["args"]
    assert (args["live_positions"], args["padded_positions"]) == (18, 4 * CAPACITY)
    # No CUDA events on the CPU: the sections are timed on the card only.
    assert runner._metrics.histogram("moe_device_s").values == []


# -- the prefill token budget -------------------------------------------------

def _sched(budget, **kw):
    cfg = ServingConfig(max_active_seqs=8, token_budget=10_000, capacity=64,
                        prompt_buckets=(16, 32, 64), admit_buckets=(1, 2, 4, 8),
                        prefill_token_budget=budget, **kw)
    return TokenBudgetScheduler(cfg)


def test_prefill_budget_admits_the_first_session_whatever_its_size():
    s = _sched(8)
    for key in "ab":
        s.enqueue(key)
    got = s.plan_admissions({"a": 40, "b": 3}.get)
    assert [k for k, _ in got] == ["a"] and s.prefill_budget_held == 1


def test_prefill_budget_holds_admission_at_the_budget():
    s = _sched(64)
    lengths = {"a": 10, "b": 12, "c": 30, "d": 5}
    for key in lengths:
        s.enqueue(key)
    # a, b: 2 x 16 = 32; c would make 4 x 32 = 128 > 64.
    assert [k for k, _ in s.plan_admissions(lengths.get)] == ["a", "b"]
    assert s.prefill_budget_held == 1 and list(s.waiting) == ["c", "d"]
    # A session resuming from its cache prefills nothing and passes.
    s2 = _sched(64)
    for key in lengths:
        s2.enqueue(key)
    resumed = {"c"}
    got = s2.plan_admissions(lengths.get, prefill_of=lambda k: 0 if k in resumed else
                             lengths[k])
    assert [k for k, _ in got] == ["a", "b", "c", "d"]


def test_prefill_budget_none_changes_nothing():
    lengths = {k: v for k, v in zip("abcdefgh", [10, 60, 3, 33, 17, 8, 40, 2])}
    plans = []
    for budget in (None, "absent"):
        s = _sched(None) if budget is None else TokenBudgetScheduler(ServingConfig(
            max_active_seqs=8, token_budget=10_000, capacity=64, prompt_buckets=(16, 32, 64),
            admit_buckets=(1, 2, 4, 8)))
        for key in lengths:
            s.enqueue(key)
        plans.append((s.plan_admissions(lengths.get), s.config.compile_signatures()))
    assert plans[0] == plans[1] and len(plans[0][0]) == 8


def test_prefill_budget_drops_shapes_from_signatures_and_warmup(model):
    cfg = _sched(64).config
    grid = {(b, t) for kind, b, t in cfg.compile_signatures() if kind == "prefill"}
    assert grid == {(1, 16), (1, 32), (1, 64), (2, 16), (2, 32), (4, 16)}
    runner = DecodeStepRunner(model, pool_slots=2, capacity=CAPACITY, device="cpu",
                              prompt_buckets=(8, 16, 32))
    runner.open()
    ran = []
    plain = runner.prefill
    runner.prefill = lambda prompts, lengths, slots, batch_bucket=None: (
        ran.append((batch_bucket, len(prompts[0]))) or plain(prompts, lengths, slots,
                                                             batch_bucket=batch_bucket))
    runner.warmup((1, 2, 4), (8, 16, 32), prefill_token_budget=32)
    assert sorted(ran) == [(1, 8), (1, 16), (1, 32), (2, 8), (2, 16), (4, 8)]
