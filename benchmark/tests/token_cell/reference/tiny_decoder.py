"""A small causal decoder, plain PyTorch in float32: the reference of the
token-sequence configuration ``tests/token_cell`` adds to a copy of the
benchmark.

RMSNorm (eps 1e-6) before attention and the MLP, multi-head causal
attention over learned positions, a tanh-GELU MLP, a final RMSNorm and
an untied head; no biases.  Matrices are ``(in, out)``.  Parameter order
(``parameters()``): ``emb``, ``pos``, ``head``, ``norm_gamma``, then per
layer ``ln1_gamma``, ``wq``, ``wk``, ``wv``, ``wo``, ``ln2_gamma``,
``w1``, ``w2``.

``forward(tokens, past)`` runs the positions after ``past`` (the keys
and values of those before, per layer) and returns their logits and the
grown ``past``: the whole sequence at once for the check, or a prefill
and one token a step for the count of a served request's work.
"""

from __future__ import annotations

import math
import typing

import torch
import torch.nn.functional as F
from torch import nn

EPS = 1e-6


def rms_norm(x, gamma):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + EPS) * gamma


class Layer(nn.Module):
    def __init__(self, d: int, mlp: int):
        super().__init__()
        self.ln1_gamma = nn.Parameter(torch.ones(d))
        self.wq = nn.Parameter(torch.zeros(d, d))
        self.wk = nn.Parameter(torch.zeros(d, d))
        self.wv = nn.Parameter(torch.zeros(d, d))
        self.wo = nn.Parameter(torch.zeros(d, d))
        self.ln2_gamma = nn.Parameter(torch.ones(d))
        self.w1 = nn.Parameter(torch.zeros(d, mlp))
        self.w2 = nn.Parameter(torch.zeros(mlp, d))

    def forward(self, x, heads: int, past):
        b, t, d = x.shape
        h = rms_norm(x, self.ln1_gamma)
        q, k, v = ((h @ w).reshape(b, t, heads, d // heads) for w in (self.wq, self.wk, self.wv))
        if past is not None:
            k, v = torch.cat([past[0], k], dim=1), torch.cat([past[1], v], dim=1)
        start = k.shape[1] - t
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d // heads)
        later = (torch.arange(k.shape[1], device=x.device)[None, :]
                 > torch.arange(start, k.shape[1], device=x.device)[:, None])
        attn = torch.softmax(scores.masked_fill(later, float("-inf")), dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, t, d)
        x = x + o @ self.wo
        x = x + F.gelu(rms_norm(x, self.ln2_gamma) @ self.w1, approximate="tanh") @ self.w2
        return x, (k, v)


class TinyDecoder(nn.Module):
    def __init__(self, vocab_size: int, embed_dim: int, num_heads: int, num_layers: int,
                 mlp_ratio: int, capacity: int):
        super().__init__()
        d = embed_dim
        self.heads = num_heads
        self.emb = nn.Parameter(torch.zeros(vocab_size, d))
        self.pos = nn.Parameter(torch.zeros(capacity, d))
        self.head = nn.Parameter(torch.zeros(d, vocab_size))
        self.norm_gamma = nn.Parameter(torch.ones(d))
        self.layers = nn.ModuleList(Layer(d, mlp_ratio * d) for _ in range(num_layers))

    def forward(self, tokens: torch.Tensor, past: typing.Optional[list] = None, *,
                last: bool = False):
        """``tokens`` ``[B, T]`` after ``len(past[0][0])`` positions:
        ``(logits [B, T, vocab], or [B, vocab] of the last with last=True;
        the past grown by T)``."""
        start = 0 if past is None else past[0][0].shape[1]
        x = self.emb[tokens] + self.pos[start:start + tokens.shape[1]]
        grown = []
        for i, layer in enumerate(self.layers):
            x, kv = layer(x, self.heads, None if past is None else past[i])
            grown.append(kv)
        if last:
            x = x[:, -1]
        return rms_norm(x, self.norm_gamma) @ self.head, grown
