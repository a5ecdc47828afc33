"""Weight bridge: the JAX package's parameter trees -> a torch state_dict.

Torch cannot replay ``jax.random`` init streams, so the same weights
reach both packages as numpy.  The char transformer's tree is
``{"emb", "pos", "head", "ln_f", "layers": [{"ln1", "wq", ...}, ...]}``
with dense weights in ``(in, out)`` layout; the port's module keeps that
layout (it computes ``h @ w``), so the bridge only flattens names.  The
``head`` leaf is carried as given, never re-tied to ``emb``.
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
