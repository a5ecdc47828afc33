"""Wide&Deep recommender — the per-key online-training workload.

Port of ``flink_tensorflow_tpu/models/zoo/widedeep.py`` (``:27-107``).
Binary logit = wide + deep: a linear model over the pre-crossed multi-hot
``wide`` vector (f32), plus hashed categorical ids -> a shared embedding
table -> an MLP over ``[embeddings ++ dense features]`` (Cheng et al.
2016).

What is held equal to the flax definition:

- the wide Dense runs in f32;
- the embedding rows are looked up in f32 and cast to ``compute_dtype``
  (flax ``nn.Embed(dtype=bf16)`` casts the whole table, then takes rows:
  the same values).  The gradient differs: flax sums the gradient of
  repeated ids in bf16, the port in f32, so the two agree tightly at f32
  compute and within bf16 rounding at bf16;
- the hidden Dense layers run in ``compute_dtype`` (input, kernel and bias
  cast), the last Dense in f32;
- the loss is ``optax.sigmoid_binary_cross_entropy`` written out, reduced
  by the ``valid``-weighted mean (``_common.weighted_metrics``).

Parameter names (``state_dict``): ``wide.{weight,bias}``,
``embed.weight``, ``hidden.{i}.{weight,bias}``, ``out.{weight,bias}``;
flax ``wide``, ``embed/embedding``, ``Dense_0 .. Dense_{n-1}``,
``Dense_{n}``.
"""

from __future__ import annotations

import typing

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from flink_tensorflow_tpu_torch.models.base import ModelMethod
from flink_tensorflow_tpu_torch.models.zoo._common import lecun_normal_, weighted_metrics
from flink_tensorflow_tpu_torch.models.zoo.registry import ModelDef, register_model_def
from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, spec

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class WideDeep(nn.Module):
    def __init__(self, hash_buckets: int = 100_000, embed_dim: int = 32, num_cat_slots: int = 8,
                 num_dense: int = 13, num_wide: int = 64,
                 hidden: typing.Sequence[int] = (256, 128, 64),
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.wide = nn.Linear(num_wide, 1)
        self.embed = nn.Embedding(hash_buckets, embed_dim)
        widths = [num_cat_slots * embed_dim + num_dense, *hidden]
        self.hidden = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths, widths[1:]))
        self.out = nn.Linear(widths[-1], 1)

    def forward(self, wide: torch.Tensor, dense: torch.Tensor, cat: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        wide_logit = self.wide(wide.float())[..., 0]
        emb = F.embedding(cat.long(), self.embed.weight).to(dt)
        x = torch.cat([emb.reshape(emb.shape[0], -1), dense.to(dt)], dim=-1)
        for layer in self.hidden:
            x = F.relu(F.linear(x, layer.weight.to(dt), layer.bias.to(dt)))
        deep_logit = self.out(x.float())[..., 0]
        return wide_logit + deep_logit


def init_widedeep(module: WideDeep, generator: torch.Generator) -> WideDeep:
    """The port's initialiser: flax's init distributions (lecun-normal
    kernels, zero biases, ``nn.Embed``'s truncated normal of variance
    1/embed_dim) from ``generator``."""
    for layer in (module.wide, *module.hidden, module.out):
        lecun_normal_(layer.weight, layer.in_features, generator)
        with torch.no_grad():
            layer.bias.zero_()
    lecun_normal_(module.embed.weight, module.embed.embedding_dim, generator)
    return module


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy``: ``-y log p - (1-y) log(1-p)``
    through ``log_sigmoid``."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


@register_model_def("widedeep")
def build(hash_buckets: int = 100_000, embed_dim: int = 32, num_cat_slots: int = 8,
          num_dense: int = 13, num_wide: int = 64, hidden=(256, 128, 64),
          compute_dtype: str = "bfloat16") -> ModelDef:
    """``compute_dtype`` is the reference's bf16, or float32 for the plain
    f32 path."""
    dtype = _DTYPES[compute_dtype]
    arch = dict(hash_buckets=hash_buckets, embed_dim=embed_dim, num_cat_slots=num_cat_slots,
                num_dense=num_dense, num_wide=num_wide, hidden=tuple(hidden))
    schema = RecordSchema({
        "wide": spec((num_wide,), np.float32),
        "dense": spec((num_dense,), np.float32),
        "cat": spec((num_cat_slots,), np.int32),
    })

    def make_module() -> WideDeep:
        return WideDeep(**arch, compute_dtype=dtype)

    def serve(module: WideDeep, inputs):
        logit = module(inputs["wide"], inputs["dense"], inputs["cat"])
        return {"logit": logit, "prob": torch.sigmoid(logit)}

    def init_fn(seed) -> WideDeep:
        return init_widedeep(make_module(), torch.Generator().manual_seed(int(seed)))

    def load_fn(params) -> WideDeep:
        if isinstance(params, WideDeep):
            return params
        from flink_tensorflow_tpu_torch.models.convert import widedeep_from_flax

        return widedeep_from_flax(params, make_module())

    def loss_fn(module: WideDeep, batch, generator):
        logit = module(batch["wide"], batch["dense"], batch["cat"])
        label = batch["label"].float()
        per_ex = sigmoid_binary_cross_entropy(logit, label)
        hits = ((logit > 0) == (label > 0.5)).float()
        loss, acc = weighted_metrics(per_ex, hits, batch.get("valid"))
        return loss, ({}, {"loss": loss, "accuracy": acc})

    return ModelDef(
        architecture="widedeep",
        config={**arch, "hidden": list(hidden), "compute_dtype": compute_dtype},
        module=WideDeep,
        input_schema=schema,
        methods={"serve": ModelMethod(name="serve", input_schema=schema,
                                      output_names=("logit", "prob"), fn=serve)},
        init_fn=init_fn,
        load_fn=load_fn,
        loss_fn=loss_fn,
        make_module=make_module,
    )
