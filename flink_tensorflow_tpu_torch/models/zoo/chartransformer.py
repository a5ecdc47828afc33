"""Char-level causal transformer — the serving plane's model.

Port of ``flink_tensorflow_tpu/models/zoo/chartransformer.py``: the same
RMSNorm + MLP blocks, the same two typed methods with the same input and
output dicts:

- ``prefill``: ``{tokens [B, C], lengths [B]}`` -> ``{next_token [B],
  k_cache [B, L, C, H, Dh], v_cache}``.  Attention is the causal flash
  kernel (``ops/flash_attention.py``, K1 on the card).
- ``decode_step``: ``{token [B], lengths [B], k_cache, v_cache[, active
  [B] bool]}`` -> the same outputs.  Unlike the JAX method, which returns
  new caches, this one writes the new position's K/V INTO the given
  caches, and only for rows that are ``active`` (default: all) and whose
  position fits the capacity (the JAX scatter drops out-of-range rows).
  The serving runner passes its pool so it is updated in place; rows it
  masks out keep their bytes.

Greedy argmax runs inside the methods (``torch.argmax`` returns the first
maximum, as ``jnp.argmax`` does).  GELU is the tanh approximation, which
is what ``jax.nn.gelu`` computes by default.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from flink_tensorflow_tpu_torch.models.base import ModelMethod
from flink_tensorflow_tpu_torch.models.zoo.registry import ModelDef, register_model_def
from flink_tensorflow_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_decode,
)
from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, TensorSpec


def _rms_norm(x, scale):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * scale).to(x.dtype)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


class _Block(nn.Module):
    def __init__(self, d: int, mlp: int):
        super().__init__()
        self.ln1 = nn.Parameter(torch.ones(d))
        self.wq = nn.Parameter(torch.zeros(d, d))
        self.wk = nn.Parameter(torch.zeros(d, d))
        self.wv = nn.Parameter(torch.zeros(d, d))
        self.wo = nn.Parameter(torch.zeros(d, d))
        self.ln2 = nn.Parameter(torch.ones(d))
        self.w1 = nn.Parameter(torch.zeros(d, mlp))
        self.w2 = nn.Parameter(torch.zeros(mlp, d))

    def mlp(self, x):
        h = _rms_norm(x, self.ln2)
        return x + _gelu(h @ self.w1) @ self.w2


class CharTransformer(nn.Module):
    """Parameters keep the JAX tree's names and ``(in, out)`` layouts."""

    def __init__(self, vocab_size: int = 96, embed_dim: int = 64, num_heads: int = 4,
                 num_layers: int = 2, mlp_ratio: int = 4, capacity: int = 128):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} must divide num_heads {num_heads}")
        d = embed_dim
        self.heads = num_heads
        self.head_dim = d // num_heads
        self.capacity = capacity
        self.emb = nn.Parameter(torch.zeros(vocab_size, d))
        self.pos = nn.Parameter(torch.zeros(capacity, d))
        self.head = nn.Parameter(torch.zeros(d, vocab_size))
        self.ln_f = nn.Parameter(torch.ones(d))
        self.layers = nn.ModuleList(_Block(d, mlp_ratio * d) for _ in range(num_layers))

    def _logits(self, h):
        return _rms_norm(h, self.ln_f) @ self.head

    def _next_token(self, h):
        return torch.argmax(self._logits(h), dim=-1).to(torch.int32)

    @torch.no_grad()
    def prefill(self, inputs):
        h_last, ks, vs = self._prefill_states(inputs)
        return {"next_token": self._next_token(h_last),
                "k_cache": torch.stack(ks, dim=1),
                "v_cache": torch.stack(vs, dim=1)}

    @torch.no_grad()
    def last_logits(self, inputs):
        """``[B, vocab]`` logits after each row's last prompt position (the
        scores ``prefill`` takes its argmax of)."""
        return self._logits(self._prefill_states(inputs)[0])

    def _prefill_states(self, inputs):
        tokens = inputs["tokens"].long()          # [B, C] padded
        lengths = inputs["lengths"].long()        # [B] true prompt lengths
        b, c = tokens.shape
        heads, hd = self.heads, self.head_dim
        x = self.emb[tokens] + self.pos[None, :c]
        ks, vs = [], []
        for p in self.layers:
            h = _rms_norm(x, p.ln1)
            q = (h @ p.wq).reshape(b, c, heads, hd)
            k = (h @ p.wk).reshape(b, c, heads, hd)
            v = (h @ p.wv).reshape(b, c, heads, hd)
            o = flash_attention(q, k, v, causal=True)
            x = x + o.reshape(b, c, -1) @ p.wo
            x = p.mlp(x)
            ks.append(k)
            vs.append(v)
        last = torch.clamp(lengths - 1, 0, c - 1)
        return x[torch.arange(b, device=x.device), last], ks, vs

    @torch.no_grad()
    def decode_step(self, inputs):
        token = inputs["token"].long()            # [B] last emitted token
        lengths = inputs["lengths"].long()        # [B] cache length before it
        k_cache = inputs["k_cache"]               # [B, L, C, H, Dh], updated in place
        v_cache = inputs["v_cache"]
        active = inputs.get("active")
        b = token.shape[0]
        c = k_cache.shape[2]
        heads, hd = self.heads, self.head_dim
        pos = torch.clamp(lengths, 0, c - 1)
        write = lengths < c
        if active is not None:
            write = write & active.to(torch.bool)
        rows = torch.arange(b, device=token.device)
        x = self.emb[token] + self.pos[pos]
        for i, p in enumerate(self.layers):
            h = _rms_norm(x, p.ln1)
            q = (h @ p.wq).reshape(b, heads, hd)
            k_new = (h @ p.wk).reshape(b, heads, hd)
            v_new = (h @ p.wv).reshape(b, heads, hd)
            # Rows that must not be written put their own bytes back, so
            # the scatter needs no host sync to filter them.
            keep = write[:, None, None]
            k_cache[rows, i, pos] = torch.where(keep, k_new, k_cache[rows, i, pos])
            v_cache[rows, i, pos] = torch.where(keep, v_new, v_cache[rows, i, pos])
            o = flash_attention_decode(q, k_cache[:, i], v_cache[:, i], lengths + 1)
            x = x + o.reshape(b, -1) @ p.wo
            x = p.mlp(x)
        return {"next_token": self._next_token(x),
                "k_cache": k_cache, "v_cache": v_cache}


def init_params(seed: int, vocab_size: int, embed_dim: int, num_layers: int,
                mlp_ratio: int, capacity: int):
    """Random weights as a numpy tree in the JAX package's layout and
    scales (normal / sqrt(fan_in); strong positional scale)."""
    rng = np.random.RandomState(seed)
    d, mlp = embed_dim, mlp_ratio * embed_dim

    def dense(fan_in, shape):
        return (rng.standard_normal(shape) / math.sqrt(fan_in)).astype(np.float32)

    emb = dense(1, (vocab_size, d)) * np.float32(0.5)
    tree = {
        "emb": emb,
        "pos": dense(1, (capacity, d)) * np.float32(0.8),
        "head": np.ascontiguousarray(emb.T),
        "ln_f": np.ones((d,), np.float32),
        "layers": [],
    }
    for _ in range(num_layers):
        tree["layers"].append({
            "ln1": np.ones((d,), np.float32),
            "wq": dense(d, (d, d)), "wk": dense(d, (d, d)),
            "wv": dense(d, (d, d)), "wo": dense(d, (d, d)),
            "ln2": np.ones((d,), np.float32),
            "w1": dense(d, (d, mlp)), "w2": dense(mlp, (mlp, d)),
        })
    return tree


@register_model_def("char_transformer")
def build(vocab_size: int = 96, embed_dim: int = 64, num_heads: int = 4,
          num_layers: int = 2, mlp_ratio: int = 4, capacity: int = 128) -> ModelDef:
    """``capacity`` is the KV-cache length every shape is padded to."""
    if embed_dim % num_heads:
        raise ValueError(f"embed_dim {embed_dim} must divide num_heads {num_heads}")
    config = {"vocab_size": vocab_size, "embed_dim": embed_dim,
              "num_heads": num_heads, "num_layers": num_layers,
              "mlp_ratio": mlp_ratio, "capacity": capacity}
    schema = RecordSchema({"tokens": TensorSpec((None,), np.int32)})
    methods = {
        "prefill": ModelMethod(
            name="prefill", input_schema=schema,
            output_names=("next_token", "k_cache", "v_cache"),
            fn=lambda module, inputs: module.prefill(inputs),
        ),
        "decode_step": ModelMethod(
            name="decode_step", input_schema=schema,
            output_names=("next_token", "k_cache", "v_cache"),
            fn=lambda module, inputs: module.decode_step(inputs),
        ),
    }
    return ModelDef(
        architecture="char_transformer",
        config=config,
        module=CharTransformer,
        input_schema=schema,
        methods=methods,
        init_fn=lambda seed: init_params(seed, vocab_size, embed_dim, num_layers,
                                         mlp_ratio, capacity),
    )
