"""Weight bridge: the JAX package's parameter trees -> torch modules.

Torch cannot replay ``jax.random`` init streams, so the same weights
reach both packages as numpy.

- The char transformer's tree is ``{"emb", "pos", "head", "ln_f",
  "layers": [{"ln1", "wq", ...}, ...]}`` with dense weights in ``(in,
  out)`` layout; the port's module keeps that layout (it computes
  ``h @ w``), so :func:`params_from_jax` only flattens names.  The
  ``head`` leaf is carried as given, never re-tied to ``emb``.
- Inception-v3's flax ``variables`` (``{"params": ..., "batch_stats":
  ...}``) follow flax's auto-naming (``ConvBN_0/Conv_0/kernel``,
  ``ConvBN_0/BatchNorm_0/{scale,bias}``, ``batch_stats/.../{mean,var}``,
  ``InceptionA_0``, ..., ``Dense_0``).  :func:`inception_from_flax`
  carries them into the port's module: conv kernels HWIO -> OIHW, the
  Dense kernel ``(in, out)`` -> ``(out, in)``.
"""

from __future__ import annotations

import typing

import numpy as np
import torch


def params_from_jax(np_tree: typing.Mapping[str, typing.Any]) -> typing.Dict[str, torch.Tensor]:
    """Flatten a (numpy or array-like) parameter tree into dotted
    state_dict names: dict keys join with ``.``, list items by index."""
    out: typing.Dict[str, torch.Tensor] = {}

    def walk(prefix: str, node) -> None:
        if isinstance(node, typing.Mapping):
            for key, child in node.items():
                walk(f"{prefix}{key}.", child)
        elif isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(f"{prefix}{i}.", child)
        else:
            out[prefix[:-1]] = torch.from_numpy(np.array(node, dtype=np.float32))

    walk("", np_tree)
    return out


def _np(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def inception_from_flax(variables: typing.Mapping[str, typing.Any], module):
    """Load flax Inception-v3 ``variables`` (numpy or array-like leaves)
    into ``module`` (a ``models.zoo.inception.InceptionV3``)."""
    params, stats = variables["params"], variables["batch_stats"]
    state: typing.Dict[str, torch.Tensor] = {}

    def conv_bn(prefix: str, p, s) -> None:
        state[f"{prefix}.weight"] = _np(p["Conv_0"]["kernel"]).permute(3, 2, 0, 1).contiguous()
        state[f"{prefix}.scale"] = _np(p["BatchNorm_0"]["scale"])
        state[f"{prefix}.bias"] = _np(p["BatchNorm_0"]["bias"])
        state[f"{prefix}.mean"] = _np(s["BatchNorm_0"]["mean"])
        state[f"{prefix}.var"] = _np(s["BatchNorm_0"]["var"])

    for i in range(len(module.stem)):
        conv_bn(f"stem.{i}", params[f"ConvBN_{i}"], stats[f"ConvBN_{i}"])
    counters: typing.Dict[str, int] = {}
    for b, block in enumerate(module.blocks):
        kind = type(block).__name__
        name = f"{kind}_{counters.get(kind, 0)}"
        counters[kind] = counters.get(kind, 0) + 1
        for c in range(len(block.convs)):
            conv_bn(f"blocks.{b}.convs.{c}", params[name][f"ConvBN_{c}"],
                    stats[name][f"ConvBN_{c}"])
    state["head.weight"] = _np(params["Dense_0"]["kernel"]).T.contiguous()
    state["head.bias"] = _np(params["Dense_0"]["bias"])
    module.load_state_dict(state)
    return module
