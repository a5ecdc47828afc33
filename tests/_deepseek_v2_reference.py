"""A plain DeepSeek-V2 forward for the CPU tests, written from DeepSeek's
published modeling code and independent of the port.

In float64 on the CPU (float32 on the card), one layer at a time, over a
dict of the port's parameters by name (so the
same seeded weights feed both); the whole sequence at once, with causal
attention materialised in the expanded form, the rope table built as the
published ``DeepseekV2YarnRotaryEmbedding`` builds it, the 64 rope dims
de-interleaved by ``view(..., d/2, 2).transpose`` as the published
``apply_rotary_pos_emb`` does, and the routed experts as a loop over the
experts that takes each one's tokens by mask, as the published
``moe_infer`` does.  Nothing here is batched across sequences of other
lengths or cached.  Departure: the weights of each expert layer are read
from the port's stacked 2-D tensors (``experts_w13`` rows ``[e * 2F,
(e + 1) * 2F)``: gate then up; ``experts_w2`` rows ``[e * D, (e + 1) *
D)``), which hold the same matrices.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _yarn_get_mscale(scale=1.0, mscale=1.0):
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def _yarn_find_correction_dim(num_rotations, dim, base, max_position_embeddings):
    return (dim * math.log(max_position_embeddings / (num_rotations * 2 * math.pi))) / (
        2 * math.log(base))


def rope_table(dim, base, scaling, positions):
    """``(cos, sin)`` ``[positions, dim]`` as the published YaRN class."""
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim))
    if not scaling:
        inv_freq, m = freq_extra, 1.0
    else:
        factor = scaling["factor"]
        freq_inter = 1.0 / (factor * base ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim))
        orig = scaling["original_max_position_embeddings"]
        low = max(math.floor(_yarn_find_correction_dim(scaling["beta_fast"], dim, base, orig)), 0)
        high = min(math.ceil(_yarn_find_correction_dim(scaling["beta_slow"], dim, base, orig)),
                   dim - 1)
        if low == high:
            high += 0.001
        ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float64) - low) / (high - low),
                           0, 1)
        mask = 1.0 - ramp
        inv_freq = freq_inter * (1 - mask) + freq_extra * mask
        m = (_yarn_get_mscale(factor, scaling["mscale"])
             / _yarn_get_mscale(factor, scaling["mscale_all_dim"]))
    freqs = torch.outer(torch.arange(positions, dtype=torch.float64), inv_freq)
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos() * m, emb.sin() * m


def _rotate_half(x):
    x1, x2 = x[..., : x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat((-x2, x1), dim=-1)


def _apply_rope(x, cos, sin):
    """``x`` ``[h, s, d]``; cos/sin ``[s, d]``."""
    h, s, d = x.shape
    x = x.view(h, s, d // 2, 2).transpose(3, 2).reshape(h, s, d)
    return x * cos + _rotate_half(x) * sin


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _mlp(x, w13, w2):
    f = w2.shape[1]
    g, u = x @ w13[:f].t(), x @ w13[f:].t()
    return (F.silu(g) * u) @ w2.t()


def experts_loop(x, weights, experts, w13, w2, num_experts):
    """The routed experts' sum, one expert at a time (an expert with no
    token adds nothing)."""
    d, f = x.shape[1], w2.shape[1]
    out = torch.zeros_like(x)
    for e in range(num_experts):
        hit = experts == e                        # [N, k]
        rows = hit.any(dim=1)
        if not rows.any():
            continue
        y = _mlp(x[rows], w13[e * 2 * f:(e + 1) * 2 * f], w2[e * d:(e + 1) * d])
        out[rows] += y * (weights * hit).sum(dim=1)[rows, None]
    return out


def softmax_scale(c):
    scale = (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]) ** -0.5
    sc = c.get("rope_scaling")
    if sc and sc.get("mscale_all_dim"):
        m = _yarn_get_mscale(sc["factor"], sc["mscale_all_dim"])
        scale = scale * m * m
    return scale


def layer(w, c, x, cos, sin):
    """One decoder layer over a whole sequence ``x`` ``[T, D]``; ``w`` the
    layer's parameters by their names in the layer, in ``x``'s dtype."""
    eps = c["rms_norm_eps"]
    heads, nope, rope, vd = (c["num_attention_heads"], c["qk_nope_head_dim"],
                             c["qk_rope_head_dim"], c["v_head_dim"])
    rank = c["kv_lora_rank"]
    t = x.shape[0]
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).triu(1)
    h = _rms(x, w["attn_norm_gamma"], eps)
    q = (h @ w["q_proj"].t()).view(t, heads, nope + rope).transpose(0, 1)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    ckv = h @ w["kv_a_proj"].t()
    comp, k_pe = ckv[:, :rank], ckv[:, rank:].view(1, t, rope)
    kv = (_rms(comp, w["kv_a_norm_gamma"], eps) @ w["kv_b_proj"].t()).view(
        t, heads, nope + vd).transpose(0, 1)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q_pe, k_pe = _apply_rope(q_pe, cos, sin), _apply_rope(k_pe, cos, sin)
    qs = torch.cat([q_nope, q_pe], dim=-1)
    ks = torch.cat([k_nope, k_pe.expand(heads, t, rope)], dim=-1)
    a = (qs @ ks.transpose(1, 2)) * softmax_scale(c)
    a = torch.softmax(a.masked_fill(causal, float("-inf")), dim=-1)
    o = (a @ v).transpose(0, 1).reshape(t, heads * vd)
    x = x + o @ w["o_proj"].t()
    h = _rms(x, w["mlp_norm_gamma"], eps)
    if "w13" in w:
        return x + _mlp(h, w["w13"], w["w2"])
    scores = torch.softmax(h @ w["router"].t(), dim=-1)
    tw, ti = torch.topk(scores, c["num_experts_per_tok"], dim=-1, sorted=False)
    tw = tw * c.get("routed_scaling_factor", 1.0)
    return x + experts_loop(h, tw, ti, w["experts_w13"], w["experts_w2"],
                            c["n_routed_experts"]) + _mlp(h, w["shared_w13"], w["shared_w2"])


def layer_weights(params, i, dtype):
    """Layer ``i``'s parameters from the port's ``named_parameters`` dict,
    widened to ``dtype``."""
    prefix = f"layers.{i}."
    return {k[len(prefix):]: v.detach().to(dtype) for k, v in params.items()
            if k.startswith(prefix)}


def forward(params, c, tokens, dtype=torch.float64):
    """``[T, vocab]`` logits of one sequence ``tokens`` ``[T]``, in
    ``dtype``, one layer at a time; ``params`` the port's parameters by
    name, ``c`` its config."""
    t = tokens.shape[0]
    dev = params["embed"].device
    cos, sin = (u.to(device=dev, dtype=dtype) for u in
                rope_table(c["qk_rope_head_dim"], c["rope_theta"], c.get("rope_scaling"), t))
    x = params["embed"][tokens.long().to(dev)].to(dtype)
    for i in range(c["num_hidden_layers"]):
        x = layer(layer_weights(params, i, dtype), c, x, cos, sin)
    x = _rms(x, params["norm_gamma"].to(dtype), c["rms_norm_eps"])
    return x @ params["head"].to(dtype).t()
