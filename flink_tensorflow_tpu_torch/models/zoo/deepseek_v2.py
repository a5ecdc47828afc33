"""DeepSeek-V2 (arXiv:2405.04434): multi-head latent attention over a
latent KV cache, sparse experts on grouped matmuls, YaRN rotary
positions.  Served through the serving plane like ``char_transformer``.

Written from DeepSeek's published ``config.json`` and modeling code
(``DeepSeek-V2-Lite``: no q compression).  Per layer:

- attention: ``q = W_q h`` split per head into ``q_nope`` (128) and
  ``q_pe`` (64); ``[c, k_pe] = W_kva h`` with ``c`` (512) RMS-normalised;
  ``[k_nope, v] = W_kvb c`` per head (128 + 128); rotary positions on
  ``q_pe`` and the one shared ``k_pe``, after de-interleaving the 64 rope
  dims (DeepSeek's layout), then rotate-half; softmax scale
  ``(192)^-1/2 * mscale^2`` with YaRN's ``mscale = 0.1 * mscale_all_dim *
  ln(factor) + 1``; ``o = W_o [heads]``.
- feed-forward: layer ``< first_k_dense_replace`` a SiLU-gated MLP;
  every later layer a softmax router over ``n_routed_experts``, greedy
  top-k, weights not renormalised (times ``routed_scaling_factor``), the
  routed experts' SiLU-gated MLPs plus the shared experts as one MLP of
  ``n_shared_experts`` times the expert width.
- pre-norm residuals, RMSNorm eps from the config, untied head.

The two served methods keep ``char_transformer``'s contract:

- ``prefill``: ``{tokens [B, T], lengths [B]}`` -> ``{next_token [B],
  k_cache [B, L, T, 1, kv_lora_rank], v_cache [B, L, T, 1, rope]}``: the
  cache holds the normalised latent ``c`` and ``k_pe`` after rope (the
  def's :meth:`DeepSeekV2.kv_cache_spec`).  Attention is the expanded
  form (q.k at 192, v at 128) through ``scaled_dot_product_attention``,
  causal, with the math backend excluded on the card, so no ``T x T``
  matrix is materialised and a shape no fused backend takes raises.  (The
  CPU has no fused kernel for a v narrower than q and k: there the math
  backend is allowed.)
- ``decode_step``: ``{token, lengths, k_cache, v_cache[, active][,
  probe]}`` -> the same outputs; writes the new position's latent into
  the given caches in place (active rows whose position fits only) and
  attends in the absorbed form: ``q_lat = q_nope W_UK`` per head, scores
  ``q_lat . c + q_pe . k_pe`` masked by each row's length, ``o = (p c)
  W_UV``, then ``W_o``.  Operands are in the compute dtype, products
  accumulate in float32, and the cache is never widened.

Routed experts run as two ``torch._grouped_mm`` over all experts: the
``(token, expert)`` pairs sorted by expert on the device, offsets from a
device count and a cumulative sum, no loop over experts and no host sync.

Weights: matrices are ``(out, in)``; each expert layer's weights are held
stacked as 2-D tensors (``experts_w13`` ``[E * 2F, D]``, gate rows then up
rows per expert; ``experts_w2`` ``[E * D, F]``) and viewed per expert.
The module is built in its compute dtype wherever the ambient device is
(``with torch.device("cuda"): ...``), with no host float32 copy.
"""

from __future__ import annotations

import contextlib
import math
import typing

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from flink_tensorflow_tpu_torch.models.base import KVCacheSpec, ModelMethod
from flink_tensorflow_tpu_torch.models.zoo.registry import ModelDef, register_model_def
from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, TensorSpec

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


# -- YaRN ---------------------------------------------------------------------

def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def _correction_dim(rotations: float, dim: int, base: float, original: int) -> float:
    return dim * math.log(original / (rotations * 2 * math.pi)) / (2 * math.log(base))


def yarn_inv_freq(dim: int, base: float, scaling: typing.Optional[dict],
                  device) -> torch.Tensor:
    """``[dim / 2]`` float32 inverse frequencies: YaRN's blend of the
    extrapolated and interpolated frequencies over the ramp between the
    ``beta_fast`` and ``beta_slow`` correction dims (plain rope without
    ``scaling``).  Made on ``device`` with no host copy."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / base ** exps
    if not scaling:
        return extra
    factor = float(scaling["factor"])
    original = int(scaling["original_max_position_embeddings"])
    low = max(math.floor(_correction_dim(scaling["beta_fast"], dim, base, original)), 0)
    high = min(math.ceil(_correction_dim(scaling["beta_slow"], dim, base, original)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp
    return extra / factor * (1 - keep) + extra * keep


def rope_scale(scaling: typing.Optional[dict]) -> float:
    """YaRN's factor on cos and sin: ``mscale / mscale_all_dim``."""
    if not scaling:
        return 1.0
    f = float(scaling["factor"])
    return (yarn_mscale(f, scaling.get("mscale", 1.0))
            / yarn_mscale(f, scaling.get("mscale_all_dim", 1.0)))


def softmax_scale(qk_dim: int, scaling: typing.Optional[dict]) -> float:
    scale = qk_dim ** -0.5
    if scaling and scaling.get("mscale_all_dim"):
        m = yarn_mscale(float(scaling["factor"]), scaling["mscale_all_dim"])
        scale *= m * m
    return scale


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """DeepSeek's rope on the last dim of ``x``: de-interleave (even dims,
    then odd), then rotate-half; ``cos``/``sin`` broadcast against it
    (``[..., dim]``, both halves equal).  In float32, rounded once."""
    d = x.shape[-1]
    xf = x.float().unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    rot = torch.cat([-xf[..., d // 2:], xf[..., :d // 2]], dim=-1)
    return (xf * cos + rot * sin).to(x.dtype)


# -- arithmetic ---------------------------------------------------------------

def _rms_norm(x, scale, eps):
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps) * scale).to(x.dtype)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (batched) in float32 from operands in their own dtype:
    on the card the product of the narrow operands accumulates and lands
    in float32; the CPU, which has no such kernel, widens the operands."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _bmm_f32(a[None], b[None])[0]


def _silu_gate(h: torch.Tensor, width: int) -> torch.Tensor:
    return F.silu(h[..., :width]) * h[..., width:]


def route(x: torch.Tensor, router: torch.Tensor, top_k: int, scaling: float):
    """Softmax scores over the experts (in float32, as published), greedy
    top-k: ``(weights [N, k] float32, experts [N, k] int64)``."""
    scores = torch.softmax(x.float() @ router.float().t(), dim=-1)
    weights, experts = torch.topk(scores, top_k, dim=-1)
    return weights * scaling, experts


def grouped_experts(x: torch.Tensor, weights: torch.Tensor, experts: torch.Tensor,
                    w13: torch.Tensor, w2: torch.Tensor, num_experts: int,
                    probe=None) -> torch.Tensor:
    """The routed experts' sum for ``x`` ``[N, D]``: pairs sorted by
    expert, gate+up as one grouped matmul over every expert (``w13``
    viewed ``[E, 2F, D]``), SiLU times up, down as a second (``w2``
    viewed ``[E, D, F]``), each row weighted and summed per token in
    float32.  An expert with no row is an empty group."""
    n, d = x.shape
    k = experts.shape[1]
    flat = experts.reshape(-1)
    order = torch.argsort(flat, stable=True)
    token = order // k
    # A count on the device (bincount reads the largest id on the host).
    counts = torch.zeros(num_experts, dtype=torch.int32, device=x.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    offs = torch.cumsum(counts, 0, dtype=torch.int32)
    if probe is not None:
        probe.add("moe_experts_touched", (counts > 0).sum())
    width = w2.shape[1]
    h = torch._grouped_mm(x[token], w13.view(num_experts, 2 * width, d).transpose(1, 2),
                          offs=offs)
    y = torch._grouped_mm(_silu_gate(h, width), w2.view(num_experts, d, width).transpose(1, 2),
                          offs=offs)
    # Back to (token, slot) order by the permutation (each row written
    # once), then each token's k rows weighted and summed in float32: the
    # same sums in the same order every run, no atomics.
    rows = torch.empty_like(y)
    rows[order] = y
    return (rows.view(n, k, d).float() * weights[..., None]).sum(dim=1).to(x.dtype)


# -- the module ---------------------------------------------------------------

def _matrix(out_dim: int, in_dim: int, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty((out_dim, in_dim), dtype=dtype), requires_grad=False)


def _norm(dim: int, dtype) -> nn.Parameter:
    return nn.Parameter(torch.ones(dim, dtype=dtype), requires_grad=False)


class _Layer(nn.Module):
    """One decoder layer's parameters, registered in the order the
    benchmark's reference lists them."""

    def __init__(self, c: dict, dense: bool, dtype):
        super().__init__()
        d, heads = c["hidden_size"], c["num_attention_heads"]
        qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
        self.attn_norm_gamma = _norm(d, dtype)
        self.q_proj = _matrix(heads * qk, d, dtype)
        self.kv_a_proj = _matrix(c["kv_lora_rank"] + c["qk_rope_head_dim"], d, dtype)
        self.kv_a_norm_gamma = _norm(c["kv_lora_rank"], dtype)
        self.kv_b_proj = _matrix(heads * (c["qk_nope_head_dim"] + c["v_head_dim"]),
                                 c["kv_lora_rank"], dtype)
        self.o_proj = _matrix(d, heads * c["v_head_dim"], dtype)
        self.mlp_norm_gamma = _norm(d, dtype)
        self.dense = dense
        if dense:
            f = c["intermediate_size"]
            self.w13 = _matrix(2 * f, d, dtype)
            self.w2 = _matrix(d, f, dtype)
        else:
            e, f = c["n_routed_experts"], c["moe_intermediate_size"]
            fs = f * c["n_shared_experts"]
            self.router = _matrix(e, d, dtype)
            self.experts_w13 = _matrix(e * 2 * f, d, dtype)
            self.experts_w2 = _matrix(e * d, f, dtype)
            self.shared_w13 = _matrix(2 * fs, d, dtype)
            self.shared_w2 = _matrix(d, fs, dtype)


class DeepSeekV2(nn.Module):
    """DeepSeek-V2 with the served methods (see the module docstring)."""

    #: ``decode_step`` queues its work with no host sync and no shape that
    #: depends on the data, so the serving runner may capture it once as a
    #: CUDA graph and replay it.
    decode_graph_safe = True

    def __init__(self, vocab_size: int = 102400, hidden_size: int = 2048,
                 intermediate_size: int = 10944, moe_intermediate_size: int = 1408,
                 num_hidden_layers: int = 27, num_attention_heads: int = 16,
                 n_routed_experts: int = 64, n_shared_experts: int = 2,
                 num_experts_per_tok: int = 6, first_k_dense_replace: int = 1,
                 kv_lora_rank: int = 512, qk_nope_head_dim: int = 128,
                 qk_rope_head_dim: int = 64, v_head_dim: int = 128,
                 rms_norm_eps: float = 1e-6, rope_theta: float = 10000.0,
                 rope_scaling: typing.Optional[dict] = None,
                 routed_scaling_factor: float = 1.0, compute_dtype: str = "bfloat16"):
        super().__init__()
        c = dict(locals())
        c.pop("self")
        c.pop("__class__", None)
        self.c = c
        dtype = _DTYPES[compute_dtype]
        self.embed = _matrix(vocab_size, hidden_size, dtype)
        self.layers = nn.ModuleList(
            _Layer(c, i < first_k_dense_replace, dtype) for i in range(num_hidden_layers))
        self.norm_gamma = _norm(hidden_size, dtype)
        self.head = _matrix(vocab_size, hidden_size, dtype)
        self.eps = rms_norm_eps
        self.heads = num_attention_heads
        self.scale = softmax_scale(qk_nope_head_dim + qk_rope_head_dim, rope_scaling)
        self._rope_scale = rope_scale(rope_scaling)
        self._inv_freq: typing.Dict[torch.device, torch.Tensor] = {}

    def kv_cache_spec(self) -> KVCacheSpec:
        """The latent cache: the normalised ``c`` and ``k_pe`` after rope,
        one of each a layer and a token."""
        c = self.c
        return KVCacheSpec(len(self.layers), ((1, c["kv_lora_rank"]), (1, c["qk_rope_head_dim"])),
                           self.embed.dtype)

    # -- pieces ------------------------------------------------------------
    def _rope(self, pos: torch.Tensor):
        """``(cos, sin)`` ``[*pos.shape, rope]`` float32 at ``pos``."""
        dev = pos.device
        inv = self._inv_freq.get(dev)
        if inv is None:
            inv = self._inv_freq[dev] = yarn_inv_freq(
                self.c["qk_rope_head_dim"], self.c["rope_theta"], self.c["rope_scaling"], dev)
        freqs = pos.float()[..., None] * inv
        emb = torch.cat([freqs, freqs], dim=-1)
        return emb.cos() * self._rope_scale, emb.sin() * self._rope_scale

    def _ffn(self, layer: _Layer, h: torch.Tensor, probe=None, live=None) -> torch.Tensor:
        """``h`` ``[N, D]`` through the layer's MLP or expert layer."""
        if layer.dense:
            return _silu_gate(h @ layer.w13.t(), layer.w2.shape[1]) @ layer.w2.t()
        c = self.c
        weights, experts = route(h, layer.router, c["num_experts_per_tok"],
                                 c["routed_scaling_factor"])
        if probe is not None and live is not None:
            probe.add("moe_routed_rows", live * c["num_experts_per_tok"])
        out = grouped_experts(h, weights, experts, layer.experts_w13, layer.experts_w2,
                              c["n_routed_experts"], probe)
        shared = _silu_gate(h @ layer.shared_w13.t(), layer.shared_w2.shape[1])
        return out + shared @ layer.shared_w2.t()

    def _logits(self, h):
        return _mm_f32(_rms_norm(h, self.norm_gamma, self.eps), self.head.t())

    def _next_token(self, h):
        return torch.argmax(self._logits(h), dim=-1).to(torch.int32)

    # -- prefill -----------------------------------------------------------
    @torch.no_grad()
    def prefill(self, inputs):
        h_last, cs, pes = self._prefill_states(inputs)
        return {"next_token": self._next_token(h_last),
                "k_cache": torch.stack(cs, dim=1)[:, :, :, None],
                "v_cache": torch.stack(pes, dim=1)[:, :, :, None]}

    @torch.no_grad()
    def last_logits(self, inputs):
        """``[B, vocab]`` float32 logits after each row's last prompt
        position (the scores ``prefill`` takes its argmax of)."""
        return self._logits(self._prefill_states(inputs)[0])

    def _prefill_states(self, inputs):
        from torch.nn.attention import SDPBackend, sdpa_kernel

        tokens = inputs["tokens"].long()          # [B, T] padded
        lengths = inputs["lengths"].long()        # [B] true prompt lengths
        b, t = tokens.shape
        c, heads = self.c, self.heads
        nope, rope, vd, rank = (c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"],
                                c["kv_lora_rank"])
        backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION]
        if tokens.device.type != "cuda":
            backends.append(SDPBackend.MATH)
        cos, sin = self._rope(torch.arange(t, device=tokens.device))
        x = self.embed[tokens]
        cs, pes = [], []
        for layer in self.layers:
            h = _rms_norm(x, layer.attn_norm_gamma, self.eps)
            q = (h @ layer.q_proj.t()).view(b, t, heads, nope + rope)
            kv_a = h @ layer.kv_a_proj.t()
            lat = _rms_norm(kv_a[..., :rank], layer.kv_a_norm_gamma, self.eps)
            k_pe = apply_rope(kv_a[..., rank:], cos, sin)                    # [B, T, rope]
            q_pe = apply_rope(q[..., nope:], cos[:, None], sin[:, None])
            kv = (lat @ layer.kv_b_proj.t()).view(b, t, heads, nope + vd)
            qf = torch.cat([q[..., :nope], q_pe], dim=-1).transpose(1, 2)
            kf = torch.cat([kv[..., :nope], k_pe[:, :, None].expand(b, t, heads, rope)],
                           dim=-1).transpose(1, 2)
            with sdpa_kernel(backends):
                o = F.scaled_dot_product_attention(qf, kf, kv[..., nope:].transpose(1, 2),
                                                   is_causal=True, scale=self.scale)
            x = x + o.transpose(1, 2).reshape(b, t, heads * vd) @ layer.o_proj.t()
            h = _rms_norm(x, layer.mlp_norm_gamma, self.eps)
            x = x + self._ffn(layer, h.reshape(b * t, -1)).view(b, t, -1)
            cs.append(lat)
            pes.append(k_pe)
        last = torch.clamp(lengths - 1, 0, t - 1)
        return x[torch.arange(b, device=x.device), last], cs, pes

    # -- decode ------------------------------------------------------------
    @torch.no_grad()
    def decode_step(self, inputs):
        token = inputs["token"].long()            # [B] last emitted token
        lengths = inputs["lengths"].long()        # [B] cache length before it
        lat_cache = inputs["k_cache"]             # [B, L, C, 1, rank], updated in place
        pe_cache = inputs["v_cache"]              # [B, L, C, 1, rope]
        active = inputs.get("active")
        probe = inputs.get("probe")
        b, cap = token.shape[0], lat_cache.shape[2]
        c, heads = self.c, self.heads
        nope, rope, vd, rank = (c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"],
                                c["kv_lora_rank"])
        pos = torch.clamp(lengths, 0, cap - 1)
        write = lengths < cap
        if active is not None:
            write = write & active.to(torch.bool)
        live = None
        if probe is not None:
            on = active.to(torch.bool) if active is not None else torch.ones_like(write)
            live = on.sum()
            probe.add("latent_live_bytes",
                      torch.where(on, lengths + 1, 0).sum()
                      * len(self.layers) * (rank + rope) * lat_cache.element_size())
        rows = torch.arange(b, device=token.device)
        keep = write[:, None]
        # Positions up to and including the one written this step.
        valid = (torch.arange(cap, device=token.device)[None, :]
                 <= torch.clamp(lengths, max=cap - 1)[:, None])
        cos, sin = self._rope(lengths)
        x = self.embed[token]
        for i, layer in enumerate(self.layers):
            h = _rms_norm(x, layer.attn_norm_gamma, self.eps)
            q = (h @ layer.q_proj.t()).view(b, heads, nope + rope)
            kv_a = h @ layer.kv_a_proj.t()
            lat_new = _rms_norm(kv_a[:, :rank], layer.kv_a_norm_gamma, self.eps)
            pe_new = apply_rope(kv_a[:, rank:], cos, sin)
            q_pe = apply_rope(q[..., nope:], cos[:, None], sin[:, None])
            lat = lat_cache[:, i, :, 0]                                  # [B, C, rank] view
            pe = pe_cache[:, i, :, 0]
            with (probe.section("latent_attn_device_s") if probe is not None
                  else contextlib.nullcontext()):
                # Rows that must not be written put their own bytes back,
                # so the scatter needs no host sync to filter them.
                lat[rows, pos] = torch.where(keep, lat_new, lat[rows, pos])
                pe[rows, pos] = torch.where(keep, pe_new, pe[rows, pos])
                w_kvb = layer.kv_b_proj.view(heads, nope + vd, rank)
                q_lat = torch.bmm(q[..., :nope].transpose(0, 1), w_kvb[:, :nope])  # [H, B, rank]
                scores = (_bmm_f32(q_lat.transpose(0, 1), lat.transpose(1, 2))
                          + _bmm_f32(q_pe, pe.transpose(1, 2)))                  # [B, H, C]
                scores = scores.mul_(self.scale).masked_fill_(~valid[:, None], float("-inf"))
                p = torch.softmax(scores, dim=-1).to(lat.dtype)
                o_lat = _bmm_f32(p, lat).to(lat.dtype)                           # [B, H, rank]
                o = torch.bmm(o_lat.transpose(0, 1), w_kvb[:, nope:].transpose(1, 2))
            x = x + o.transpose(0, 1).reshape(b, heads * vd) @ layer.o_proj.t()
            h = _rms_norm(x, layer.mlp_norm_gamma, self.eps)
            with (probe.section("moe_device_s") if probe is not None and not layer.dense
                  else contextlib.nullcontext()):
                x = x + self._ffn(layer, h, probe, live)
        return {"next_token": self._next_token(x), "k_cache": lat_cache, "v_cache": pe_cache}


# -- weights ------------------------------------------------------------------

def init_module(module: nn.Module, seed: int) -> nn.Module:
    """Fill ``module`` in place where it lies: every matrix normal over
    ``sqrt(fan_in)`` from a generator of its own (seeded by ``(seed,
    index)``) on the module's device, drawn in float32 and rounded once;
    norms 1."""
    with torch.no_grad():
        for i, (name, p) in enumerate(module.named_parameters()):
            if p.dim() < 2:
                p.fill_(1.0)
                continue
            gen = torch.Generator(p.device).manual_seed(
                int(np.random.SeedSequence([int(seed), i]).generate_state(1, np.uint64)[0] >> 1))
            draw = torch.randn(p.shape, generator=gen, device=p.device)
            p.copy_(draw.mul_(p.shape[1] ** -0.5))
            del draw
    return module


@register_model_def("deepseek_v2")
def build(**config) -> ModelDef:
    """``config`` takes the published ``config.json``'s keys that
    :class:`DeepSeekV2` names (and ``compute_dtype``); keys that only
    name what this port implements as published are checked."""
    fixed = {"q_lora_rank": None, "scoring_func": "softmax", "topk_method": "greedy",
             "norm_topk_prob": False, "hidden_act": "silu", "moe_layer_freq": 1,
             "n_group": 1, "topk_group": 1, "attention_bias": False,
             "tie_word_embeddings": False}
    for key, value in fixed.items():
        if key in config and config.pop(key) != value:
            raise ValueError(f"deepseek_v2: {key} other than {value!r} is not implemented")
    for key in ("num_key_value_heads", "max_position_embeddings", "model_type", "seq_aux"):
        config.pop(key, None)
    schema = RecordSchema({"tokens": TensorSpec((None,), np.int32)})
    outputs = ("next_token", "k_cache", "v_cache")
    methods = {
        "prefill": ModelMethod(name="prefill", input_schema=schema, output_names=outputs,
                               fn=lambda module, inputs: module.prefill(inputs)),
        "decode_step": ModelMethod(name="decode_step", input_schema=schema,
                                   output_names=outputs,
                                   fn=lambda module, inputs: module.decode_step(inputs)),
    }
    return ModelDef(
        architecture="deepseek_v2",
        config=dict(config),
        module=DeepSeekV2,
        input_schema=schema,
        methods=methods,
        # No host tree: the "params" are the seed, and the module is made
        # and filled in place on the ambient device.
        init_fn=lambda seed: seed,
        load_fn=lambda seed: init_module(DeepSeekV2(**config), seed),
        make_module=lambda: DeepSeekV2(**config),
    )
