"""Paged KV-cache layout ops (block tables, plain PyTorch indexing).

Port of ``flink_tensorflow_tpu/ops/paged_attention.py``.  The paged pool
stores K/V as ``[P, L, page_tokens, H, Dh]`` — P fixed-size pages, each
holding ``page_tokens`` positions of one session's cache — and every
session carries an int32 **block table** of width ``capacity //
page_tokens`` mapping its logical page index to a pool page, or to the
sentinel for unallocated entries.

Layout transforms, not math: the decode and prefill math stays in the
model's methods, and the paged step is gather -> dense step -> scatter.
The gather clamps sentinel entries to the pool's last page (whatever it
holds sits at positions the caller's lengths mask).  The reference's
scatter drops them (``mode="drop"``), which PyTorch lacks: here the pool
carries one scratch page at the sentinel's index, the last page, which no
table reads, and :func:`scatter_pages` writes every entry, sentinel ones
into that page, with no filter and no sync.  So a row whose table is
all-sentinel writes no page a table reads.
"""

from __future__ import annotations

import torch

from flink_tensorflow_tpu_torch.ops.flash_attention import flash_attention_decode


def pages_per_session(capacity: int, page_tokens: int) -> int:
    """Block-table width: logical pages covering one session's capacity."""
    if capacity % page_tokens:
        raise ValueError(
            f"capacity {capacity} must be a multiple of page_tokens "
            f"{page_tokens} — pages tile the cache exactly")
    return capacity // page_tokens


def _swap_axes_1_2(x):
    """Axes 1 and 2 of a 6-D tensor or numpy array swapped (a view)."""
    axes = (0, 2, 1, 3, 4, 5)
    return x.permute(*axes) if isinstance(x, torch.Tensor) else x.transpose(axes)


def dense_to_pages(x, page_tokens: int):
    """``[B, L, C, H, Dh]`` dense caches -> ``[B, C/pt, L, pt, H, Dh]``
    page-major form (the scatter payload: axis 1 indexes the block table).
    Takes a tensor or a numpy array and returns a view of it."""
    b, layers, cap, heads, hd = x.shape
    n = cap // page_tokens
    return _swap_axes_1_2(x.reshape(b, layers, n, page_tokens, heads, hd))


def pages_to_dense(x):
    """Inverse of :func:`dense_to_pages`: ``[B, N, L, pt, H, Dh]`` ->
    ``[B, L, N*pt, H, Dh]`` (a tensor or a numpy array)."""
    b, n, layers, pt, heads, hd = x.shape
    return _swap_axes_1_2(x).reshape(b, layers, n * pt, heads, hd)


def gather_pages(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Materialize dense ``[B, L, C, H, Dh]`` caches from the paged pool,
    as a new contiguous tensor (never a view of the pool).

    ``pool``: ``[P, L, pt, H, Dh]``; ``tables``: ``[B, N]`` integer, with
    entries ``>= P`` clamped to the last page, whose content lands at
    positions the caller's lengths mask."""
    idx = torch.clamp(tables.long(), max=pool.shape[0] - 1)
    return pages_to_dense(pool[idx]).contiguous()


def scatter_pages(pool: torch.Tensor, tables: torch.Tensor, dense: torch.Tensor,
                  page_tokens: int) -> torch.Tensor:
    """Write dense ``[B, L, C, H, Dh]`` caches back through the block
    tables, in place; returns ``pool``.

    Every entry is written: ``pool`` must hold a page at each id the
    tables carry, the sentinel's included (the scratch page).  Duplicate
    page ids (prefix-shared pages gathered by several rows) all write the
    identical gathered bytes, so which write lands last never matters —
    the one page that receives new content each step is exclusively owned
    by the copy-on-write invariant the serving runner enforces before the
    step."""
    ids = tables.reshape(-1).long()
    src = dense_to_pages(dense, page_tokens).reshape(-1, *pool.shape[1:])
    pool.index_copy_(0, ids, src.to(pool.dtype))
    return pool


def paged_attention_decode(q, k_pool, v_pool, tables, lengths):
    """Single-query decode attention straight off the paged pool.

    ``q``: ``[B, H, Dh]``; pools pre-sliced to one layer ``[P, pt, H,
    Dh]``; ``tables``: ``[B, N]``; ``lengths``: ``[B]`` valid positions.
    Composes the gather with the port's plain
    :func:`~flink_tensorflow_tpu_torch.ops.flash_attention.flash_attention_decode`,
    so the paged layout and the dense decode agree by construction."""
    p, pt, heads, hd = k_pool.shape
    idx = torch.clamp(tables.long(), max=p - 1)
    b, n = tables.shape
    k = k_pool[idx].reshape(b, n * pt, heads, hd)
    v = v_pool[idx].reshape(b, n * pt, heads, hd)
    return flash_attention_decode(q, k, v, lengths)
