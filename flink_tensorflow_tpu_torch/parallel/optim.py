"""Optimizers on dicts of tensors — the port's copy of what optax gives
the JAX package (``optax.sgd``, ``optax.adam``).

An optimizer is ``init(params) -> state`` and ``update(grads, state,
params) -> (updates, state)`` on ``{name: tensor}`` dicts, as optax's
``GradientTransformation``; :func:`apply_updates` adds the updates.
``apply_(grads, state, params)`` is the same step done IN PLACE on
``state`` and ``params`` (the port's form of a donated train state).

Why not ``torch.optim``: one shared module trains many independent states
(a model per key), the state must snapshot as a plain dict of tensors,
and an optax state must carry across exactly.  The adam state is
``{"count", "mu", "nu"}``, one to one with optax's ``ScaleByAdamState``
(``optax.adam`` = ``scale_by_adam`` then ``scale_by_learning_rate``), and
the arithmetic follows optax's order: ``mu = (1-b1) g + b1 mu``, ``nu =
(1-b2) g^2 + b2 nu``, bias corrections ``1 - b**count`` in f32, ``mu_hat /
(sqrt(nu_hat) + eps)`` scaled by ``-lr``.  Every step is a handful of
``torch._foreach_*`` launches over all tensors at once, not a loop of
launches per tensor.
"""

from __future__ import annotations

import dataclasses
import typing

import torch

Tree = typing.Dict[str, torch.Tensor]


def _lists(*trees: Tree) -> typing.List[typing.List[torch.Tensor]]:
    names = list(trees[0])
    return [[t[n] for n in names] for t in trees]


def apply_updates(params: Tree, updates: Tree) -> Tree:
    """``params + updates`` as new tensors (``optax.apply_updates``)."""
    names = list(params)
    p, u = _lists(params, updates)
    return dict(zip(names, torch._foreach_add(p, u)))


@dataclasses.dataclass(frozen=True)
class SGD:
    """``optax.sgd(lr)`` without momentum: ``updates = -lr * grads``;
    the state is empty."""

    lr: float

    def init(self, params: Tree) -> dict:
        return {}

    def update(self, grads: Tree, state: dict, params: typing.Optional[Tree] = None):
        names = list(grads)
        (g,) = _lists(grads)
        return dict(zip(names, torch._foreach_mul(g, -self.lr))), {}

    def apply_(self, grads: Tree, state: dict, params: Tree) -> None:
        p, g = _lists(params, grads)
        torch._foreach_add_(p, g, alpha=-self.lr)


@dataclasses.dataclass(frozen=True)
class Adam:
    """``optax.adam(lr, b1, b2, eps, mu_dtype=...)`` (``eps_root = 0``, no
    nesterov).  ``mu_dtype`` is optax's: the first moment is STORED in
    that dtype, and each step computes it in the gradients' dtype from
    the stored value and casts the new moment back (the bias-corrected
    step uses the uncast moment)."""

    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    mu_dtype: typing.Optional[torch.dtype] = None

    def init(self, params: Tree) -> dict:
        any_param = next(iter(params.values()))
        return {
            "count": torch.zeros((), dtype=torch.int32, device=any_param.device),
            "mu": {n: torch.zeros_like(p, dtype=self.mu_dtype) for n, p in params.items()},
            "nu": {n: torch.zeros_like(p) for n, p in params.items()},
        }

    def _direction(self, grads: Tree, state: dict, inplace: bool):
        """Adam's unscaled step ``mu_hat / (sqrt(nu_hat) + eps)`` and the
        new moments; with ``inplace`` the state's own tensors update."""
        g, mu, nu = _lists(grads, state["mu"], state["nu"])
        stored = mu
        cast = any(m.dtype != x.dtype for m, x in zip(mu, g))
        if inplace and not cast:
            torch._foreach_mul_(mu, self.b1)
        elif not cast:
            mu = torch._foreach_mul(mu, self.b1)
        else:
            # As optax: b1 (a weakly typed scalar, so rounded to mu_dtype
            # first) times mu in mu_dtype, the sum in the gradients' dtype;
            # stored back in mu_dtype below.
            b1 = float(torch.tensor(self.b1, dtype=mu[0].dtype))
            mu = [m.to(x.dtype) for m, x in zip(torch._foreach_mul(mu, b1), g)]
        if inplace:
            torch._foreach_mul_(nu, self.b2)
            count = state["count"].add_(1)
        else:
            nu = torch._foreach_mul(nu, self.b2)
            count = state["count"] + 1
        torch._foreach_add_(mu, g, alpha=1 - self.b1)
        torch._foreach_add_(nu, torch._foreach_mul(g, g), alpha=1 - self.b2)
        c = count.to(torch.float32)
        bc1 = 1 - torch.pow(self.b1, c)
        bc2 = 1 - torch.pow(self.b2, c)
        mu_hat = torch._foreach_div(mu, bc1)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(mu_hat, denom)
        if cast:
            if inplace:
                torch._foreach_copy_(stored, mu)
                mu = stored
            else:
                mu = [m.to(s.dtype) for m, s in zip(mu, stored)]
        return mu_hat, mu, nu, count

    def update(self, grads: Tree, state: dict, params: typing.Optional[Tree] = None):
        names = list(grads)
        direction, mu, nu, count = self._direction(grads, state, inplace=False)
        torch._foreach_mul_(direction, -self.lr)
        return dict(zip(names, direction)), {
            "count": count, "mu": dict(zip(names, mu)), "nu": dict(zip(names, nu))}

    def apply_(self, grads: Tree, state: dict, params: Tree) -> None:
        direction, _, _, _ = self._direction(grads, state, inplace=True)
        (p,) = _lists(params)
        torch._foreach_add_(p, direction, alpha=-self.lr)


def sgd(lr: float) -> SGD:
    return SGD(lr)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, *,
         mu_dtype: typing.Optional[torch.dtype] = None) -> Adam:
    return Adam(lr, b1, b2, eps, mu_dtype)
