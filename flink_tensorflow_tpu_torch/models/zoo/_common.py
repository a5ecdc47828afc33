"""Shared helpers for the zoo model definitions.

Port of ``flink_tensorflow_tpu/models/zoo/_common.py``.
"""

from __future__ import annotations

import math
import typing

import torch


def weighted_metrics(per_example_loss: torch.Tensor, per_example_hit: torch.Tensor,
                     valid: typing.Optional[torch.Tensor]):
    """Batch-pad-aware loss/accuracy reduction shared by all zoo loss_fns
    (``_common.py:8``).

    ``valid`` is the batcher's ``[B]`` 0/1 mask (tensors.batching): pad
    rows replay real records, so without the mask they would bias the
    gradients."""
    if valid is None:
        return per_example_loss.mean(), per_example_hit.mean()
    w = valid.to(per_example_loss.dtype)
    denom = torch.clamp(w.sum(), min=1.0)
    return (per_example_loss * w).sum() / denom, (per_example_hit * w).sum() / denom


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's default kernel init (``lecun_normal``: a normal truncated at
    two standard deviations, variance 1/fan_in), drawn by inverse CDF.
    ``nn.Embed``'s default init is the same distribution with ``fan_in``
    the embedding width."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    u = torch.rand(t.shape, generator=generator, dtype=torch.float64) * (hi - lo) + lo
    z = torch.erfinv(u).mul_(math.sqrt(2)).clamp_(-2.0, 2.0)
    with torch.no_grad():
        t.copy_((z * std).to(t.dtype))
