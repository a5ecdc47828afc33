"""DeepSeek-V2 (arXiv:2405.04434; DeepSeek-V2-Lite's published
``config.json`` and modeling code), plain PyTorch in float32: the
reference of the ``deepseek-v2-lite`` configuration.

Per layer: RMSNorm, multi-head latent attention with no q compression
(``q_proj`` to ``heads x (nope + rope)``; ``kv_a_proj`` to the latent
``c`` and one shared ``k_pe``; ``c`` RMS-normalised; ``kv_b_proj`` to
``heads x (k_nope + v)``), YaRN rotary positions on the rope dims (the
published table: extrapolated and interpolated frequencies blended over
the ``beta_fast`` to ``beta_slow`` ramp, cos and sin times ``mscale /
mscale_all_dim``; the dims de-interleaved, then rotate-half), softmax
scale ``(nope + rope)^-1/2 * mscale_all_dim'^2``, ``o_proj``; RMSNorm;
then a SiLU-gated MLP (the first ``first_k_dense_replace`` layers) or the
expert layer: softmax router in float32, greedy top-k, weights not
renormalised, times ``routed_scaling_factor``, each expert a SiLU-gated
MLP, plus the shared experts as one MLP ``n_shared_experts`` times as
wide.  Final RMSNorm and an untied head.  Matrices are ``(out, in)``.

Parameter order (``parameters()``): ``embed``, per layer
``attn_norm_gamma``, ``q_proj``, ``kv_a_proj``, ``kv_a_norm_gamma``,
``kv_b_proj``, ``o_proj``, ``mlp_norm_gamma``, then ``w13``, ``w2`` (a
dense layer) or ``router``, ``experts_w13``, ``experts_w2``,
``shared_w13``, ``shared_w2``; then ``norm_gamma``, ``head``.

Departures from the published code, none of them in the arithmetic:

- the gate and up projections of an MLP are one matrix (gate rows, then
  up rows), and each expert layer's experts are stacked into two 2-D
  matrices (``experts_w13`` ``[E * 2F, D]``, ``experts_w2`` ``[E * D,
  F]``), expert ``e`` being rows ``e * 2F ...`` and ``e * D ...``;
- the whole-sequence attention takes its queries in 16 blocks, each
  against the keys up to the block's end (causal, masked within);
- with a ``past`` (the count of a served request's work), the layer keeps
  the latent ``c`` and ``k_pe`` of the positions before and attends in the
  absorbed form the paper gives (section 2.1.2: ``W_UK`` into the query,
  ``W_UV`` after the weighted sum), which is the same function;
- on meta tensors (the count) the routing is not data: each expert takes
  an equal share of the ``tokens x k`` rows.

Every projection goes through ``arith.linear`` (exact float32, or the
fp8 control); the router, the norms, rope and the attention's products
stay in float32.
"""

from __future__ import annotations

import math
import typing

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.arith import Exact

#: Query blocks of the whole-sequence attention.
BLOCKS = 16


def _mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def rope_cos_sin(dim: int, base: float, scaling: typing.Optional[dict], start: int, n: int,
                 device) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """``(cos, sin)`` ``[n, dim]`` of positions ``start .. start + n - 1``."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / base ** exps
    scale = 1.0
    inv = extra
    if scaling:
        factor = scaling["factor"]
        orig = scaling["original_max_position_embeddings"]

        def corr(rot):
            return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

        low = max(math.floor(corr(scaling["beta_fast"])), 0)
        high = min(math.ceil(corr(scaling["beta_slow"])), dim - 1)
        if low == high:
            high += 0.001
        ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
                / (high - low)).clamp(0, 1)
        inv = (extra / factor) * ramp + extra * (1.0 - ramp)
        scale = _mscale(factor, scaling["mscale"]) / _mscale(factor, scaling["mscale_all_dim"])
    t = torch.arange(start, start + n, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos() * scale, emb.sin() * scale


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``x`` ``[..., T, d]`` (cos/sin ``[T, d]``): de-interleave, rotate-half."""
    d = x.shape[-1]
    x = x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(x.shape)
    half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + half * sin


def rms_norm(x, gamma, eps):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * gamma


def mlp(x, w13, w2, arith):
    f = w2.shape[1]
    return arith.linear(F.silu(arith.linear(x, w13[:f], None)) * arith.linear(x, w13[f:], None),
                        w2, None)


class Layer(nn.Module):
    def __init__(self, c: dict, dense: bool):
        super().__init__()
        d, h = c["hidden_size"], c["num_attention_heads"]
        nope, rp, vd, rank = (c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"],
                              c["kv_lora_rank"])
        self.c = c
        self.attn_norm_gamma = nn.Parameter(torch.ones(d))
        self.q_proj = nn.Parameter(torch.zeros(h * (nope + rp), d))
        self.kv_a_proj = nn.Parameter(torch.zeros(rank + rp, d))
        self.kv_a_norm_gamma = nn.Parameter(torch.ones(rank))
        self.kv_b_proj = nn.Parameter(torch.zeros(h * (nope + vd), rank))
        self.o_proj = nn.Parameter(torch.zeros(d, h * vd))
        self.mlp_norm_gamma = nn.Parameter(torch.ones(d))
        self.dense = dense
        if dense:
            f = c["intermediate_size"]
            self.w13 = nn.Parameter(torch.zeros(2 * f, d))
            self.w2 = nn.Parameter(torch.zeros(d, f))
        else:
            e, f = c["n_routed_experts"], c["moe_intermediate_size"]
            fs = f * c["n_shared_experts"]
            self.router = nn.Parameter(torch.zeros(e, d))
            self.experts_w13 = nn.Parameter(torch.zeros(e * 2 * f, d))
            self.experts_w2 = nn.Parameter(torch.zeros(e * d, f))
            self.shared_w13 = nn.Parameter(torch.zeros(2 * fs, d))
            self.shared_w2 = nn.Parameter(torch.zeros(d, fs))

    # -- attention ---------------------------------------------------------
    def attention(self, x, start: int, past, arith):
        c = self.c
        b, t, _ = x.shape
        heads, nope, rp, vd, rank = (c["num_attention_heads"], c["qk_nope_head_dim"],
                                     c["qk_rope_head_dim"], c["v_head_dim"], c["kv_lora_rank"])
        eps = c["rms_norm_eps"]
        sc = c.get("rope_scaling")
        scale = (nope + rp) ** -0.5
        if sc and sc.get("mscale_all_dim"):
            scale *= _mscale(sc["factor"], sc["mscale_all_dim"]) ** 2
        h = rms_norm(x, self.attn_norm_gamma, eps)
        q = arith.linear(h, self.q_proj, None).view(b, t, heads, nope + rp).transpose(1, 2)
        kv_a = arith.linear(h, self.kv_a_proj, None)
        lat = rms_norm(kv_a[..., :rank], self.kv_a_norm_gamma, eps)          # [B, T, rank]
        cos, sin = rope_cos_sin(rp, c["rope_theta"], sc, start, t, x.device)
        q_nope, q_pe = q[..., :nope], rope(q[..., nope:], cos, sin)           # [B, H, T, *]
        k_pe = rope(kv_a[..., rank:], cos, sin)                               # [B, T, rope]
        w_kvb = self.kv_b_proj.view(heads, nope + vd, rank)
        if past is None:
            kv = arith.linear(lat, self.kv_b_proj, None).view(b, t, heads, nope + vd)
            k = torch.cat([kv[..., :nope].transpose(1, 2),
                           k_pe[:, None].expand(b, heads, t, rp)], dim=-1)
            v = kv[..., nope:].transpose(1, 2)
            qs = torch.cat([q_nope, q_pe], dim=-1)
            step = -(-t // BLOCKS)
            outs = []
            for s in range(0, t, step):
                e = min(t, s + step)
                a = torch.einsum("bhqd,bhkd->bhqk", qs[:, :, s:e], k[:, :, :e]) * scale
                later = (torch.arange(e, device=x.device)[None, :]
                         > torch.arange(s, e, device=x.device)[:, None])
                a = torch.softmax(a.masked_fill(later, float("-inf")), dim=-1)
                outs.append(torch.einsum("bhqk,bhkd->bhqd", a, v[:, :, :e]))
            o = torch.cat(outs, dim=2)
            grown = (lat, k_pe)
        else:
            lat_all = torch.cat([past[0], lat], dim=1)
            pe_all = torch.cat([past[1], k_pe], dim=1)
            q_lat = torch.einsum("bhtd,hdr->bhtr", q_nope, w_kvb[:, :nope])
            a = (torch.einsum("bhtr,bkr->bhtk", q_lat, lat_all)
                 + torch.einsum("bhtd,bkd->bhtk", q_pe, pe_all)) * scale
            n = lat_all.shape[1]
            later = (torch.arange(n, device=x.device)[None, :]
                     > torch.arange(n - t, n, device=x.device)[:, None])
            a = torch.softmax(a.masked_fill(later, float("-inf")), dim=-1)
            o_lat = torch.einsum("bhtk,bkr->bhtr", a, lat_all)
            o = torch.einsum("bhtr,hdr->bhtd", o_lat, w_kvb[:, nope:])
            grown = (lat_all, pe_all)
        o = o.transpose(1, 2).reshape(b, t, heads * vd)
        return arith.linear(o, self.o_proj, None), grown

    # -- feed-forward ------------------------------------------------------
    def experts(self, x, arith):
        """``x`` ``[N, D]``: the routed experts' weighted sum."""
        c = self.c
        e, k = c["n_routed_experts"], c["num_experts_per_tok"]
        d, f = c["hidden_size"], c["moe_intermediate_size"]
        scores = torch.softmax(x @ self.router.t(), dim=-1)
        weights, chosen = torch.topk(scores, k, dim=-1)
        weights = weights * c["routed_scaling_factor"]
        out = torch.zeros_like(x)
        n = x.shape[0]
        for i in range(e):
            w13 = self.experts_w13[i * 2 * f:(i + 1) * 2 * f]
            w2 = self.experts_w2[i * d:(i + 1) * d]
            if x.is_meta:   # the count: an equal share of the rows
                rows = n * k // e + (1 if i < n * k % e else 0)
                if rows:
                    mlp(x.new_empty((rows, d)), w13, w2, arith)
                continue
            hit = chosen == i
            token = hit.any(dim=1).nonzero()[:, 0]
            if not len(token):
                continue
            y = mlp(x[token], w13, w2, arith)
            out.index_add_(0, token, y * (weights * hit)[token].sum(dim=1, keepdim=True))
        return out

    def forward(self, x, start: int = 0, past=None, *, arith=None):
        """``x`` ``[B, T, D]`` at positions ``start ..``; ``past``: the
        latent and ``k_pe`` ``[B, start, *]`` before them, or None (the
        whole sequence).  Returns ``(x, grown past)``."""
        arith = arith or Exact()
        o, grown = self.attention(x, start, past, arith)
        x = x + o
        h = rms_norm(x, self.mlp_norm_gamma, self.c["rms_norm_eps"])
        if self.dense:
            return x + mlp(h, self.w13, self.w2, arith), grown
        flat = h.reshape(-1, h.shape[-1])
        y = self.experts(flat, arith) + mlp(flat, self.shared_w13, self.shared_w2, arith)
        return x + y.view(x.shape), grown


class DeepSeekV2(nn.Module):
    def __init__(self, vocab_size: int, hidden_size: int, intermediate_size: int,
                 moe_intermediate_size: int, num_hidden_layers: int, num_attention_heads: int,
                 n_routed_experts: int, n_shared_experts: int, num_experts_per_tok: int,
                 first_k_dense_replace: int, kv_lora_rank: int, qk_nope_head_dim: int,
                 qk_rope_head_dim: int, v_head_dim: int, rms_norm_eps: float, rope_theta: float,
                 rope_scaling: typing.Optional[dict], routed_scaling_factor: float):
        super().__init__()
        c = {k: v for k, v in locals().items() if k not in ("self", "__class__")}
        self.c = c
        self.embed = nn.Parameter(torch.zeros(vocab_size, hidden_size))
        self.layers = nn.ModuleList(Layer(c, i < first_k_dense_replace)
                                    for i in range(num_hidden_layers))
        self.norm_gamma = nn.Parameter(torch.ones(hidden_size))
        self.head = nn.Parameter(torch.zeros(vocab_size, hidden_size))

    def logits(self, x, arith=None):
        arith = arith or Exact()
        return arith.linear(rms_norm(x, self.norm_gamma, self.c["rms_norm_eps"]), self.head, None)

    def forward(self, tokens: torch.Tensor, past: typing.Optional[list] = None, *,
                last: bool = False, arith=None):
        """``tokens`` ``[B, T]`` after ``past``'s positions (per layer the
        latent and ``k_pe`` before them): ``(logits [B, T, vocab], or [B,
        vocab] of the last with last=True; the past grown by T)``."""
        start = 0 if past is None else past[0][0].shape[1]
        x = self.embed[tokens]
        grown = []
        for i, layer in enumerate(self.layers):
            x, kv = layer(x, start, None if past is None else past[i], arith=arith)
            grown.append(kv)
        if last:
            x = x[:, -1]
        return self.logits(x, arith), grown
