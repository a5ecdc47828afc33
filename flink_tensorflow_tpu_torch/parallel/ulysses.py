"""Ulysses sequence parallelism — all-to-all over the ``seq`` mesh axis.

Port of ``flink_tensorflow_tpu/parallel/ulysses.py``:
``ulysses_attention_sharded`` (``:33``), ``ulysses_decode_attention``
(``:75``) and ``ulysses_attention`` (``:121``).

Tokens arrive split ``[B, T/n, H, D]`` over the n processes of the
``seq`` group.  One all-to-all re-splits them from sequence to HEADS:
each process then holds the whole sequence for ``H/n`` heads, runs plain
attention on them (K1, one call over its heads at full T; or the einsum
body), and a second all-to-all gives the sequence split back.  The
reference's ``lax.all_to_all(tiled=True)`` becomes
``dist.all_to_all_single`` on a contiguous ``[n, ...]`` staging layout
(slot j goes to rank j).  The heads a process receives are a slice of
the head axis, so they are made contiguous before K1 sees them
(:func:`ulysses_local_attention`).  ``H`` must be divisible by the
axis size.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from flink_tensorflow_tpu_torch.ops import flash_attention as fa
from flink_tensorflow_tpu_torch.parallel import collectives
from flink_tensorflow_tpu_torch.parallel.mesh import SEQ_AXIS, Mesh
from flink_tensorflow_tpu_torch.parallel.ring_attention import (
    _local,
    full_attention,
    gather_global,
)


def _check_heads(h: int, n: int, what: str, alternative: str) -> None:
    if h % n:
        raise ValueError(f"{what} needs heads ({h}) divisible by the seq-axis size ({n}); "
                         f"use {alternative} for head counts that don't split")


def ulysses_local_attention(q_h, k_h, v_h, *, causal: bool = False, impl: str = "flash"):
    """The per-process compute after the exchange: attention over the
    whole sequence for this process's heads ``[B, T, H/n, D]``.  Operands
    are made contiguous first (a head slice is strided)."""
    q_h, k_h, v_h = q_h.contiguous(), k_h.contiguous(), v_h.contiguous()
    if impl == "flash":
        return fa.flash_attention(q_h, k_h, v_h, causal=causal)
    if impl == "einsum":
        return full_attention(q_h, k_h, v_h, causal=causal)
    raise ValueError(f"impl must be 'flash' or 'einsum', got {impl!r}")


def ulysses_attention_sharded(q, k, v, *, group=None, causal: bool = False,
                              impl: str = "flash"):
    """The Ulysses body on this process's shard ``[B, T_local, H, D]``;
    ``group`` is the ``seq`` group (None: the default group).  Returns
    this process's output shard in q's dtype."""
    n = dist.get_world_size(group) if dist.is_initialized() else 1
    b, t, h, d = q.shape
    _check_heads(h, n, "ulysses", "ring attention")

    def seq_to_heads(x):
        # [B, T/n, H, D] -> slot j: my tokens of rank j's heads; receive
        # slot j: rank j's tokens of my heads; concatenate along T.
        if n == 1:
            return x
        staged = x.reshape(b, t, n, h // n, d).permute(2, 0, 1, 3, 4)
        got = collectives.all_to_all(staged, group)
        return got.permute(1, 0, 2, 3, 4).reshape(b, n * t, h // n, d)

    def heads_to_seq(x):
        if n == 1:
            return x
        staged = x.reshape(b, n, t, h // n, d).permute(1, 0, 2, 3, 4)
        got = collectives.all_to_all(staged, group)
        return got.permute(1, 2, 0, 3, 4).reshape(b, t, h, d)

    out_h = ulysses_local_attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v),
                                    causal=causal, impl=impl)
    return heads_to_seq(out_h.to(q.dtype))


def ulysses_attention(mesh: Mesh, q, k, v, *, causal: bool = False, impl: str = "flash"):
    """Ulysses attention over a mesh with a ``seq`` axis: q/k/v are the
    GLOBAL ``[B, T, H, D]`` arrays, T and H divisible by the seq-axis size
    (B by the data axis's, where there is one).  Returns the global output
    on every process."""
    n = mesh.axis_size(SEQ_AXIS)
    _check_heads(q.shape[2], n, "ulysses", "ring attention")
    out = ulysses_attention_sharded(_local(mesh, q, seq_dim=1), _local(mesh, k, seq_dim=1),
                                    _local(mesh, v, seq_dim=1), group=mesh.group(SEQ_AXIS),
                                    causal=causal, impl=impl)
    return gather_global(mesh, out, seq_dim=1)


def ulysses_decode_attention(mesh: Mesh, q, k, v, lengths):
    """Decode-step attention with the KV cache split over HEADS: each
    process runs ``flash_attention_decode`` over its ``H/n`` heads of the
    global q ``[B, 1, H, D]`` and cache ``[B, C, H, D]`` (``lengths``:
    ``[B]``); no collective per step.  The head-split output is gathered
    into the global ``[B, 1, H, D]`` on every process (the reference
    returns it head-sharded and its caller's ``device_get`` gathers it)."""
    n = mesh.axis_size(SEQ_AXIS)
    h = q.shape[2]
    _check_heads(h, n, "ulysses decode", "ring_decode_attention")
    i = mesh.axis_index(SEQ_AXIS)
    heads = slice(i * (h // n), (i + 1) * (h // n))
    q_, k_, v_ = (torch.as_tensor(x).to(mesh.device)[:, :, heads].contiguous()
                  for x in (q, k, v))
    out = fa.flash_attention_decode(q_, k_, v_, torch.as_tensor(lengths).to(mesh.device))
    group = mesh.group(SEQ_AXIS)
    if n == 1 or group is None:
        return out
    return torch.cat(collectives.all_gather(out, group), dim=2)
