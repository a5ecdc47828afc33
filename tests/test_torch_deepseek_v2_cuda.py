"""DeepSeek-V2-Lite whole on the card (marked ``cuda``; skips without one):
the published widths, 27 layers, 64 experts, the full vocabulary, bf16.

Two prompts of about 4k tokens are prefilled through the dense runner's
latent pool and decoded 32 steps; every logit the model takes its argmax
of is held to the plain reference beside these tests run one layer at a
time in float32 (TF32 off) over the prompt and the served tokens.  The
decode call runs under ``torch.cuda.set_sync_debug_mode("error")`` (no
host sync inside the step), the prefill under ``sdpa_kernel`` without the
math backend (the model's own choice on the card), and the grouped expert
path is held to a loop over experts at the decode step's shape.

    python -m pytest tests/test_torch_deepseek_v2_cuda.py -m cuda -q -s
"""

import numpy as np
import pytest
import torch
from _deepseek_v2_reference import experts_loop, forward

pytestmark = pytest.mark.cuda

CONFIG = dict(vocab_size=102400, hidden_size=2048, intermediate_size=10944,
              moe_intermediate_size=1408, num_hidden_layers=27, num_attention_heads=16,
              n_routed_experts=64, n_shared_experts=2, num_experts_per_tok=6,
              first_k_dense_replace=1, kv_lora_rank=512, qk_nope_head_dim=128,
              qk_rope_head_dim=64, v_head_dim=128, rms_norm_eps=1e-6, rope_theta=10000,
              rope_scaling={"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
                            "mscale_all_dim": 0.707,
                            "original_max_position_embeddings": 4096, "type": "yarn"},
              routed_scaling_factor=1, compute_dtype="bfloat16")
#: The widest gap of a served logit from the float32 reference's, over
#: the position's spread of logits.  bf16 weights are exact on both sides;
#: the gap is the program's bf16 activations through 27 layers (each
#: product rounded once to bf16, 2^-9 relative): 0.315 and 0.372 on the
#: card at this test's two prompts and 33 positions each, the order of the
#: experts' sums alone moving it by a fifth (PERF.md).
LOGIT_TOL = 0.6
#: The largest logit the program serves below the reference's best, over
#: the spread: a greedy choice among near-ties only; the serving cell's
#: ``token_gap`` limit, set between the program's readings and the fp8
#: control's (PERF.md).
GAP_TOL = 0.6


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def model(card):
    from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def

    mdef = get_model_def("deepseek_v2", **CONFIG)
    with torch.device(card):
        model = mdef.to_model(3)
    yield model
    model.params = None
    torch.cuda.empty_cache()


def test_whole_model_prefill_then_decode_against_the_reference(model, card):
    from flink_tensorflow_tpu_torch.functions.runner import DecodeStepRunner

    module = model.params
    assert sum(p.numel() for p in module.parameters()) == 15_706_484_224
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 102400, n).astype(np.int32) for n in (4096, 3970)]
    steps = 32
    runner = DecodeStepRunner(model, pool_slots=2, capacity=4096 + steps + 1,
                              prompt_buckets=(4096,), device=card)
    runner.open()
    assert runner._module is module        # in place on the card: no second copy
    seen = []
    plain = type(module)._logits
    module._logits = lambda h: seen.append(plain(module, h)) or seen[-1]
    try:
        first = runner.prefill(prompts, [len(p) for p in prompts], [0, 1])
        served = [[int(t)] for t in first]
        rows = [seen[-1].float().cpu()]
        lengths = [len(p) for p in prompts]
        for _ in range(steps):
            out = runner.decode_step([s[-1] for s in served], lengths, [0, 1])
            rows.append(seen[-1].float().cpu())
            for s in range(2):
                served[s].append(int(out[s]))
                lengths[s] += 1
    finally:
        del module._logits
    params = dict(module.named_parameters())
    worst = {"logit": 0.0, "gap": 0.0}
    for s, p in enumerate(prompts):
        seq = torch.from_numpy(np.concatenate([p, served[s][:-1]]).astype(np.int64))
        with torch.no_grad():
            ref = forward(params, module.c, seq, torch.float32)[len(p) - 1:].double().cpu()
        got = torch.stack([r[s] for r in rows]).double()
        spread = ref.std(dim=1, keepdim=True)
        worst["logit"] = max(worst["logit"], float(((got - ref).abs() / spread).max()))
        gap = ref.max(dim=1).values - ref[torch.arange(len(served[s])), torch.tensor(served[s])]
        worst["gap"] = max(worst["gap"], float((gap / spread[:, 0]).max()))
        del ref
    print(f"whole model on the card: widest logit error {worst['logit']!r}, "
          f"widest token gap {worst['gap']!r} (of the spread)")
    assert worst["logit"] < LOGIT_TOL and worst["gap"] < GAP_TOL
    runner.close()


def test_decode_step_syncs_nothing_and_prefill_takes_a_fused_backend(model, card):
    module = model.params
    spec = module.kv_cache_spec()
    slots, cap = 96, 8576
    lat = torch.zeros((slots, spec.layers, cap, *spec.parts[0]), dtype=spec.dtype, device=card)
    pe = torch.zeros((slots, spec.layers, cap, *spec.parts[1]), dtype=spec.dtype, device=card)
    tokens = torch.randint(0, 102400, (2, 2048), device=card, dtype=torch.int32)
    out = module.prefill({"tokens": tokens, "lengths": torch.tensor([2048, 1500], device=card)})
    lat[:2, :, :2048] = out["k_cache"]
    pe[:2, :, :2048] = out["v_cache"]
    inputs = {"token": torch.randint(0, 102400, (slots,), device=card, dtype=torch.int32),
              "lengths": torch.randint(0, cap - 1, (slots,), device=card, dtype=torch.int32),
              "k_cache": lat, "v_cache": pe,
              "active": torch.ones(slots, dtype=torch.bool, device=card)}
    module.decode_step(inputs)            # warm: caches, handles
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        result = module.decode_step(inputs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert result["next_token"].shape == (slots,)
    del lat, pe


def test_grouped_experts_equal_a_loop_at_the_decode_shape(card):
    from flink_tensorflow_tpu_torch.models.zoo.deepseek_v2 import grouped_experts

    gen = torch.Generator(card).manual_seed(0)
    n, d, f, e, k = 96, 2048, 1408, 64, 6
    x = torch.randn(n, d, generator=gen, device=card).bfloat16()
    w13 = (torch.randn(e * 2 * f, d, generator=gen, device=card) / d ** 0.5).bfloat16()
    w2 = (torch.randn(e * d, f, generator=gen, device=card) / f ** 0.5).bfloat16()
    scores = torch.rand(n, e - 1, generator=gen, device=card)       # expert 63 left empty
    weights, experts = torch.topk(torch.softmax(scores, -1), k, dim=-1)
    got = grouped_experts(x, weights, experts, w13, w2, e).double()
    want = experts_loop(x.double(), weights.double(), experts, w13.double(), w2.double(), e)
    # bf16 products, each rounded once to bf16 (2^-8 relative), sum of 6.
    assert float((got - want).abs().max() / want.abs().max()) < 3e-2


def test_graphed_decode_equals_eager_and_its_probe_reads(model, card):
    """The runner's captured step against the eager step on the same
    sessions: the same tokens and the same latent written; traced, the
    probe captured with the graph reads the expert layers' and the latent
    attention's device time and the step's counts after each replay."""
    from flink_tensorflow_tpu_torch.functions.runner import DecodeStepRunner
    from flink_tensorflow_tpu_torch.metrics.registry import MetricGroup

    class Spans:
        def span(self, *a, **k):
            pass

    module = model.params
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 102400, n).astype(np.int32) for n in (1000, 2048, 700)]
    runs = []
    for graphed in (True, False):
        module.decode_graph_safe = graphed
        runner = DecodeStepRunner(model, pool_slots=4, capacity=2048 + 8,
                                  prompt_buckets=(2048,), device=card)
        runner.open()
        runner._metrics, runner._tracer, runner._trace_track = MetricGroup("t"), Spans(), "t"
        served = [[int(t)] for t in runner.prefill(prompts, [len(p) for p in prompts],
                                                   [0, 1, 3], batch_bucket=4)]
        lengths = [len(p) for p in prompts]
        for _ in range(6):
            toks, lens = [0] * 4, [0] * 4
            for s, slot in enumerate((0, 1, 3)):
                toks[slot], lens[slot] = served[s][-1], lengths[s]
            out = runner.decode_step(toks, lens, [0, 1, 3])
            for s, slot in enumerate((0, 1, 3)):
                served[s].append(int(out[slot]))
                lengths[s] += 1
        assert (runner._graph is not None) == graphed
        hist = {name: runner._metrics.histogram(name).values for name in
                ("moe_device_s", "latent_attn_device_s", "moe_routed_rows",
                 "moe_experts_touched", "latent_live_bytes")}
        runs.append((served, runner._kc[[0, 1, 3]].clone(), hist))
        runner.close()
    del module.decode_graph_safe
    (g_tok, g_lat, g_hist), (e_tok, e_lat, e_hist) = runs
    print("graphed against eager: latent", float((g_lat.float() - e_lat.float()).abs().max()))
    assert g_tok == e_tok and torch.equal(g_lat, e_lat)
    print("graphed probe:", {k: v[:2] for k, v in g_hist.items()},
          "eager probe:", {k: v[:2] for k, v in e_hist.items()})
    for name in g_hist:
        assert len(g_hist[name]) == 6 and all(v > 0 for v in g_hist[name])
    assert g_hist["moe_routed_rows"] == e_hist["moe_routed_rows"] == [3 * 6 * 26] * 6
    assert g_hist["latent_live_bytes"] == e_hist["latent_live_bytes"]
