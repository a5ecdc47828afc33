"""Ring attention — sequence parallelism over the ``seq`` mesh axis.

Port of ``flink_tensorflow_tpu/parallel/ring_attention.py``:
``_block_attention`` (``:31``), ``_combine_blocks`` (``:57``),
``ring_attention_sharded`` (``:76``), ``_ring_flash`` (``:139``),
``ring_attention`` (``:204``), ``ring_decode_attention`` (``:234``) and
``full_attention`` (``:295``).

Tokens are split ``[B, T/n, H, D]`` over the n processes of the ``seq``
group.  Each process attends its query block to K/V blocks that travel
around the ring: ``lax.ppermute`` becomes one ``batch_isend_irecv``
exchange per hop (``collectives.ring_shift``, K and V stacked into one
message), sent to the next rank and received from the previous one, so
the block in hand at step i came from rank ``(me - i) mod n``.  The
exchange happens at the top of each step after the first: n - 1
exchanges, not n.

The flash body (the default) runs each block through K1
(``ops/flash_attention.py``, the CUDA kernel on a card, its plain version
on the CPU) with ``return_lse=True`` and folds the blocks together by
their log-sum-exps (:func:`_combine_blocks`).  Under a causal mask the
source rank picks the block's kind, as the reference's ``lax.switch``
does: the diagonal block (source = me) runs K1 causal, an earlier rank's
block runs it unmasked, and a later rank's block is skipped (it would
contribute ``lse = -inf``, which the fold leaves as it was).
:func:`ring_flash_block` is that step, with no collective in it.  The
einsum body (``impl="einsum"``) keeps the composed online softmax.
Accumulation is f32 whatever the input dtype.
"""

from __future__ import annotations

import math
import typing

import torch
import torch.distributed as dist

from flink_tensorflow_tpu_torch.ops import flash_attention as fa
from flink_tensorflow_tpu_torch.parallel import collectives
from flink_tensorflow_tpu_torch.parallel.mesh import DATA_AXIS, SEQ_AXIS, Mesh


def _group_geometry(group) -> typing.Tuple[int, int]:
    """(size, this process's rank) of ``group``; (1, 0) off a cohort."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def _block_attention(q, k, v, m, l, o, mask):
    """One online-softmax step: fold a K/V block into the accumulators.

    q: [B, Tq, H, D]; k/v: [B, Tk, H, D]; m, l: [B, H, Tq]; o: [B, Tq, H,
    D] f32; mask: [Tq, Tk] bool (True = attend) or None."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = s.masked_fill(~mask[None, None], float("-inf"))
    m_new = torch.maximum(m, s.amax(dim=-1))
    # exp(-inf - -inf) guard: fully masked rows keep p = 0.
    p = torch.nan_to_num(torch.exp(s - m_new[..., None]), nan=0.0)
    alpha = torch.nan_to_num(torch.exp(m - m_new), nan=0.0)
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha.transpose(1, 2)[..., None] + torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return m_new, l_new, o_new


def _combine_blocks(o_acc, lse_acc, o_blk, lse_blk):
    """Fold one block's normalised output and log-sum-exp into the running
    pair: ``sum_i o_i * exp(lse_i - lse_total)``.  o: [B, T, H, D] f32;
    lse: [B, H, T] f32 (-inf: the block gave that row nothing)."""
    lse_new = torch.logaddexp(lse_acc, lse_blk)
    safe = torch.where(torch.isinf(lse_new), torch.zeros_like(lse_new), lse_new)
    zero = torch.zeros_like(lse_new)
    c_acc = torch.where(torch.isinf(lse_acc), zero, torch.exp(lse_acc - safe))
    c_blk = torch.where(torch.isinf(lse_blk), zero, torch.exp(lse_blk - safe))
    o_new = o_acc * c_acc.transpose(1, 2)[..., None] + o_blk * c_blk.transpose(1, 2)[..., None]
    return o_new, lse_new


def ring_flash_block(q, k_blk, v_blk, o_acc, lse_acc, *, me: int, src: int, causal: bool):
    """One step of the flash ring on the block that came from rank
    ``src``: select its kind, run K1 with ``return_lse=True``, fold it into
    ``(o_acc, lse_acc)``.  No collective: the exchange is the caller's."""
    if causal and src > me:
        return o_acc, lse_acc   # a later rank's keys: every row masked
    o, lse = fa.flash_attention(q, k_blk, v_blk, causal=causal and src == me, return_lse=True)
    return _combine_blocks(o_acc, lse_acc, o.float(), lse)


def _ring_flash(q, k, v, *, group, causal: bool):
    n, me = _group_geometry(group)
    b, t, h, _ = q.shape
    o_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse_acc = torch.full((b, h, t), float("-inf"), device=q.device)
    kv = torch.stack([k, v])
    for step in range(n):
        if step:
            kv = collectives.ring_shift(kv, group)
        o_acc, lse_acc = ring_flash_block(q, kv[0], kv[1], o_acc, lse_acc, me=me,
                                          src=(me - step) % n, causal=causal)
    return o_acc.to(q.dtype)


def ring_attention_sharded(q, k, v, *, group=None, causal: bool = False,
                           impl: str = "flash"):
    """The ring body on this process's shard ``[B, T_local, H, D]`` of q,
    k and v; ``group`` is the ``seq`` axis's process group (None: the
    default group).  Returns this process's output shard, q's dtype."""
    if impl == "flash":
        return _ring_flash(q, k, v, group=group, causal=causal)
    if impl != "einsum":
        raise ValueError(f"impl must be 'flash' or 'einsum', got {impl!r}")
    n, me = _group_geometry(group)
    b, t, h, _ = q.shape
    qf = q.float()
    m = torch.full((b, h, t), float("-inf"), device=q.device)
    l = torch.zeros((b, h, t), device=q.device)
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    rows = torch.arange(t, device=q.device)
    kv = torch.stack([k, v])
    for step in range(n):
        if step:
            kv = collectives.ring_shift(kv, group)
        mask = None
        if causal:
            src = (me - step) % n
            mask = (src * t + rows[None, :]) <= (me * t + rows[:, None])
        m, l, o = _block_attention(qf, kv[0], kv[1], m, l, o, mask)
    denom = torch.where(l == 0.0, torch.ones_like(l), l)
    return (o / denom.transpose(1, 2)[..., None]).to(q.dtype)


def _local(mesh: Mesh, x, *, seq_dim: typing.Optional[int], batch: bool = True):
    """This process's block of a global tensor: rows over ``data`` (when
    the mesh has it and ``batch``), dim ``seq_dim`` over ``seq``."""
    x = torch.as_tensor(x).to(mesh.device)
    if batch and mesh.axis_size(DATA_AXIS) > 1:
        x = x.chunk(mesh.axis_size(DATA_AXIS), dim=0)[mesh.axis_index(DATA_AXIS)]
    if seq_dim is not None and mesh.axis_size(SEQ_AXIS) > 1:
        x = x.chunk(mesh.axis_size(SEQ_AXIS), dim=seq_dim)[mesh.axis_index(SEQ_AXIS)]
    return x.contiguous()


def gather_global(mesh: Mesh, local: torch.Tensor, *, seq_dim: int) -> torch.Tensor:
    """The global tensor from every process's block (rows over ``data``,
    dim ``seq_dim`` over ``seq``): one ``all_gather`` over the mesh."""
    if not mesh.distributed or mesh.size == 1:
        return local
    parts = collectives.all_gather(local)
    a, s = mesh.axis_size(DATA_AXIS), mesh.axis_size(SEQ_AXIS)
    rows = [torch.cat(parts[i * s:(i + 1) * s], dim=seq_dim) for i in range(a)]
    return torch.cat(rows, dim=0)


def ring_attention(mesh: Mesh, q, k, v, *, causal: bool = False, impl: str = "flash"):
    """Ring attention over a mesh with a ``seq`` axis.  q/k/v: the GLOBAL
    ``[B, T, H, D]`` arrays (numpy or tensors, the same on every process);
    T must divide by the seq-axis size (and B by the data axis's, where
    the mesh has one: dp x sp composes).  Each process runs the ring on
    its block; the result is the global ``[B, T, H, D]`` on every
    process."""
    out = ring_attention_sharded(_local(mesh, q, seq_dim=1), _local(mesh, k, seq_dim=1),
                                 _local(mesh, v, seq_dim=1), group=mesh.group(SEQ_AXIS),
                                 causal=causal, impl=impl)
    return gather_global(mesh, out, seq_dim=1)


def ring_decode_attention(mesh: Mesh, q, k, v, lengths):
    """Decode-step attention with the KV cache split over ``seq``: every
    process runs ``flash_attention_decode`` over its own cache block
    (capacity ``C / n``) and the per-block ``(o, lse)`` pairs are gathered
    (one ``all_gather`` each, tiny next to the cache) and folded with
    :func:`_combine_blocks`, in rank order.

    ``q``: global ``[B, 1, H, D]``; ``k``/``v``: global ``[B, C, H, D]``
    with ``C`` divisible by the seq-axis size; ``lengths``: global
    ``[B]``.  Returns the global ``[B, 1, H, D]`` on every process."""
    n = mesh.axis_size(SEQ_AXIS)
    c = k.shape[1]
    if c % n:
        raise ValueError(f"cache capacity {c} must divide the {SEQ_AXIS} axis size {n}")
    c_local = c // n
    group = mesh.group(SEQ_AXIS)
    q_ = _local(mesh, q, seq_dim=None, batch=False)
    k_ = _local(mesh, k, seq_dim=1, batch=False)
    v_ = _local(mesh, v, seq_dim=1, batch=False)
    lengths_ = torch.as_tensor(lengths).to(mesh.device)
    i = mesh.axis_index(SEQ_AXIS)
    local_valid = torch.clamp(lengths_ - i * c_local, 0, c_local)
    o, lse = fa.flash_attention_decode(q_, k_, v_, local_valid, return_lse=True)
    o = o.float()
    if n == 1 or group is None:
        return o.to(q_.dtype)
    os_, lses = collectives.all_gather(o, group), collectives.all_gather(lse, group)
    o_acc, lse_acc = os_[0], lses[0]
    for j in range(1, n):
        o_acc, lse_acc = _combine_blocks(o_acc, lse_acc, os_[j], lses[j])
    return o_acc.to(q_.dtype)


def full_attention(q, k, v, *, causal: bool = False):
    """Unsharded plain attention (the golden baseline of the tests)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        t_q, t_k = s.shape[-2], s.shape[-1]
        mask = torch.arange(t_k, device=s.device)[None, :] <= torch.arange(
            t_q, device=s.device)[:, None]
        s = s.masked_fill(~mask[None, None], float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    out = out / p.sum(dim=-1).transpose(1, 2)[..., None]
    return out.to(q.dtype)
