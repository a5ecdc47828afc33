"""Collectives of the parallel layer, over ``torch.distributed``.

In the JAX package XLA inserts every collective itself: a ``jit`` over a
batch sharded on ``data`` sums the gradients and the batch-norm moments
across the axis, and ``shard_map`` bodies call ``lax.psum`` /
``ppermute`` / ``all_to_all`` / ``all_gather``.  The port spells them out
here, each over an explicit process group (the mesh's group for an axis,
``parallel/mesh.py``):

- :func:`all_reduce_sum` is differentiable (a ``torch.autograd.Function``):
  its forward sums a tensor over the group and its backward sums the
  incoming gradients over the group, which is the adjoint of a sum that
  every rank receives.  Batch norm's global moments rest on it;
- :func:`cross_replica_moments` makes train-mode batch norm
  (``ops/batch_norm.py``) average its per-rank ``E[x]`` and ``E[x^2]``
  over a group for the length of a train step, which is what the JAX
  step computes over its global batch; the fused kernel's backward takes
  its moments' gradients through :func:`moment_grads_`;
- :func:`all_reduce_mean_` averages a list of tensors in place with one
  collective per dtype (the gradients of a step, the state's broadcast).

Each call adds one to ``calls[<op>]``, a plain counter a caller may read
and reset (``all_reduce``, ``broadcast``, ``all_gather``, ``all_to_all``,
``send_recv``).  Under :func:`census` (the plan-time census of
``analysis/shardcheck.py``, over meta tensors) they count in the
census's own counter instead, and communicate nothing: each returns a
tensor of its result's shape.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import typing

import torch
import torch.distributed as dist

#: Collectives issued since the last reset, by kind.
calls: typing.Counter[str] = collections.Counter()

_MOMENTS: contextvars.ContextVar = contextvars.ContextVar("cross_replica_moments", default=None)
_CENSUS: contextvars.ContextVar = contextvars.ContextVar("collective_census", default=None)


@contextlib.contextmanager
def census() -> typing.Iterator[typing.Counter[str]]:
    """While active (on this thread), collectives count in the yielded
    counter (not in :data:`calls`) and move no data: no process group is
    needed."""
    counts: typing.Counter[str] = collections.Counter()
    token = _CENSUS.set(counts)
    try:
        yield counts
    finally:
        _CENSUS.reset(token)


def _count(kind: str) -> bool:
    """Count one collective; True when it must also communicate."""
    counts = _CENSUS.get()
    (calls if counts is None else counts)[kind] += 1
    return counts is None


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (every rank gets the sum)."""
    if _count("all_reduce"):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return all_reduce_(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        # Every rank's output is the same sum, so the gradient with respect
        # to one rank's input is the sum of all ranks' output gradients.
        return all_reduce_(grad.clone(memory_format=torch.contiguous_format), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``sum over the ranks of group of x``, differentiable: the backward
    sums the gradients over the group in turn."""
    return _AllReduceSum.apply(x, group)


@contextlib.contextmanager
def cross_replica_moments(group, size: int):
    """While active (on this thread), :func:`batch_moments` averages
    per-rank moments over ``group`` of ``size`` ranks."""
    token = _MOMENTS.set((group, size))
    try:
        yield
    finally:
        _MOMENTS.reset(token)


def batch_moments(mean: torch.Tensor, mean_sq: torch.Tensor
                  ) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """Per-rank ``E[x]`` and ``E[x^2]`` (f32, per channel) -> the moments of
    the batch the step trains on.  Outside :func:`cross_replica_moments`
    they are returned as they are.  Inside, both ride one differentiable
    all-reduce and are divided by the group's size: with equal rows on
    every rank, the mean of the per-rank means is the global mean.  At
    one rank the sum is a copy and the division by 1 exact, so the step
    keeps its bits."""
    active = _MOMENTS.get()
    if active is None:
        return mean, mean_sq
    group, size = active
    both = all_reduce_sum(torch.stack([mean, mean_sq]), group) / size
    return both[0], both[1]


def moments_group():
    """``(group, size)`` of the active :func:`cross_replica_moments` on
    this thread, or None."""
    return _MOMENTS.get()


def moment_grads_(grads: torch.Tensor, active) -> torch.Tensor:
    """The transpose of :func:`batch_moments` for a kernel that takes its
    own gradient: the per-rank gradients of the averaged moments
    (``grads``, contiguous) summed in place over the group of ``active``
    (:func:`moments_group` at the forward) and divided by its size.  At
    one rank the sum is a copy and the division by 1 exact."""
    group, size = active
    all_reduce_(grads, group)
    return grads.div_(size)


def _by_dtype(tensors: typing.Sequence[torch.Tensor]):
    groups: typing.Dict[torch.dtype, typing.List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return groups.values()


def _coalesced_(tensors: typing.Sequence[torch.Tensor], collective) -> None:
    """Run ``collective(flat)`` on one flat buffer per dtype, then copy
    the result back into each tensor."""
    for idx in _by_dtype(tensors):
        parts = [tensors[i] for i in idx]
        flat = torch.cat([p.reshape(-1) for p in parts])
        collective(flat)
        offset = 0
        for p in parts:
            n = p.numel()
            p.copy_(flat[offset:offset + n].view_as(p))
            offset += n


def all_reduce_mean_(tensors: typing.Sequence[torch.Tensor], group, size: int) -> None:
    """Each tensor replaced by its mean over ``group`` (sum, then divided
    by ``size``): one all-reduce per dtype."""
    def reduce(flat):
        all_reduce_(flat, group)
        flat.div_(size)

    _coalesced_(tensors, reduce)


def broadcast_(tensors: typing.Sequence[torch.Tensor], src: int = 0, group=None) -> None:
    """Every tensor overwritten with rank ``src``'s (a global rank): one
    broadcast per dtype."""
    def bcast(flat):
        if _count("broadcast"):
            dist.broadcast(flat, src=src, group=group)

    _coalesced_(tensors, bcast)


def all_gather(t: torch.Tensor, group=None) -> typing.List[torch.Tensor]:
    """Every rank's ``t`` (same shape), in the group's rank order."""
    t = t.contiguous()
    if not _count("all_gather"):
        return [torch.empty_like(t)]
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return out


def all_to_all(staged: torch.Tensor, group=None) -> torch.Tensor:
    """``staged`` is ``[n, ...]`` with slot j bound for group rank j; the
    result's slot j came from group rank j (``lax.all_to_all`` with
    ``tiled=True``, on a contiguous staging layout)."""
    staged = staged.contiguous()
    out = torch.empty_like(staged)
    if not _count("all_to_all"):
        return out
    dist.all_to_all_single(out, staged, group=group)
    return out


def ring_shift(t: torch.Tensor, group=None) -> torch.Tensor:
    """Send ``t`` to the next rank of the group and receive the previous
    rank's (``lax.ppermute`` with ``j -> j + 1 mod n``): one
    ``batch_isend_irecv`` exchange."""
    if not _count("send_recv"):
        return torch.empty_like(t.contiguous())
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n) if group is not None else (me + 1) % n
    prv = dist.get_global_rank(group, (me - 1) % n) if group is not None else (me - 1) % n
    t = t.contiguous()
    out = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t, nxt, group), dist.P2POp(dist.irecv, out, prv, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out
