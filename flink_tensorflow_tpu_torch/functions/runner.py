"""Model runners — own a model's device copy and dispatch its calls.

Port of two runners of ``flink_tensorflow_tpu/functions/runner.py``:

:class:`CompiledMethodRunner` (``:1011``) runs one model method on
micro-batches for the model functions (``functions/model_function.py``):
the module goes to the device once at ``open``; ``dispatch`` assembles a
batch into a pinned staging buffer (``dispatch_batch``, ``:1304``, takes
one assembled elsewhere: the ring's views), ships it (with the ``[B]`` lengths of
dynamic fields, which a ``needs_lengths`` method takes as its third
argument, JAX ``:1157-1162``, ``:1353-1357``) and launches the method on
the runner's compute stream without waiting; a fetch thread waits on each
batch's own event, in dispatch order, and hands per-record results to the
collecting (subtask) thread.  On the card every call runs under
``inference_mode``, and ``warmup`` runs on every dispatch lane, so cuDNN's
algorithm choice and plans are made before the first live window.  With
``emit_device_batches`` (``:1049``) a batch's outputs stay on the device:
the fetch thread waits for the compute only and hands out one
:class:`~flink_tensorflow_tpu_torch.tensors.transfer.DeviceBatch`, and
``dispatch_device`` (``:1411``) feeds an upstream one straight to the
method, with no H2D.  Per batch the runner counts ``h2d_batches`` or
``h2d_elided_batches``, and ``d2h_batches`` or ``fetch_elided_batches``.

:class:`DecodeStepRunner` is the serving plane's decode dispatch (and
what ``_build_decode_calls`` compiled for it):

- the cache POOL (``[S, L, C, H, Dh]`` K/V tensors, one row per
  active-session slot) is allocated on the device at ``open()`` and
  updated IN PLACE: prefill copies the new rows in, each decode step
  writes one position of the active rows only (rows outside the active
  set keep their bytes — a preempted session's slot is never touched);
- the only host->device copy per decode step is the ``[S]`` int32
  token/length vectors and the ``[S]`` mask (counted in
  ``step_h2d_bytes``), and the only device->host copy is ``[S]`` int32
  next tokens — greedy argmax runs inside the model;
- per-session blocks cross the pool boundary only at admission
  (``insert_block``) and extraction (``extract_block``).

With ``padding_buckets`` (the default) the decode step always runs the
full pool ``[S]`` (inactive rows masked) and prefill shapes quantize to
the admit x prompt-length grid; without it every step runs at its own
shape (the active rows only, the exact prompt length).

:class:`PagedDecodeStepRunner` (JAX ``_build_paged_calls`` ``:486`` and
``PagedDecodeStepRunner`` ``:547``) keeps the cache as pages with a block
table per slot; see its docstring.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import copy
import threading
import time
import typing

import numpy as np
import torch

from flink_tensorflow_tpu_torch.models.base import Model
from flink_tensorflow_tpu_torch.ops.paged_attention import (
    dense_to_pages,
    gather_pages,
    pages_per_session,
    pages_to_dense,
    scatter_pages,
)
from flink_tensorflow_tpu_torch.tensors.batching import BucketPolicy
from flink_tensorflow_tpu_torch.tensors.coercion import coerce
from flink_tensorflow_tpu_torch.tensors.batching import Batch
from flink_tensorflow_tpu_torch.tensors.serde import normalize_wire_dtype
from flink_tensorflow_tpu_torch.tensors.transfer import (
    DeviceBatch,
    DeviceTransfer,
    FetchHandle,
    is_scale_key,
    scale_key,
    torch_dtype,
)
from flink_tensorflow_tpu_torch.tensors.value import TensorValue
from flink_tensorflow_tpu_torch.utils.device import resolve_device

if typing.TYPE_CHECKING:
    from flink_tensorflow_tpu_torch.core.runtime_context import RuntimeContext
    from flink_tensorflow_tpu_torch.serving.kv_cache import KVBlock
    from flink_tensorflow_tpu_torch.serving.paged import PagedKVHandle


class DecodeStepRunner:
    """Owns the device copy of the model and the KV pool of one subtask.

    The model contributes two methods (``models/zoo/chartransformer`` is
    the reference instance): ``prefill`` ``{tokens [B, T], lengths [B]}``
    -> ``{next_token [B], k_cache [B, L, T, H, Dh], v_cache}`` and
    ``decode_step`` ``{token, lengths, k_cache, v_cache, active}``, which
    writes the new position into the given caches."""

    def __init__(
        self,
        model: Model,
        *,
        pool_slots: int,
        capacity: int,
        padding_buckets: bool = True,
        prompt_buckets: typing.Optional[typing.Sequence[int]] = None,
        device=None,
    ):
        self.model = model
        self.pool_slots = pool_slots
        self.capacity = capacity
        self.padding_buckets = padding_buckets
        self.prompt_buckets = tuple(prompt_buckets or ())
        self.device = resolve_device(device)
        self._prefill = model.method("prefill")
        self._decode = model.method("decode_step")
        self._module = None
        self._kc: typing.Optional[torch.Tensor] = None   # [S, L, C, H, Dh]
        self._vc: typing.Optional[torch.Tensor] = None
        self._metrics = None
        #: Plain counters (mirrored to the metric group by the operator).
        self.step_h2d_bytes = 0
        self.block_h2d_events = 0     # host block -> pool (admission/restore)
        self.block_d2h_events = 0     # pool -> host block (barrier/preempt)
        self.device_block_moves = 0   # pool <-> DeviceKVBlock (no host touch)

    # -- lifecycle ---------------------------------------------------------
    def open(self, ctx: typing.Optional["RuntimeContext"] = None) -> None:
        if ctx is not None:
            self._metrics = ctx.metrics
        if self.device.type == "cuda":
            # The reference is f32 throughout: keep f32 products off TF32
            # (already PyTorch's default; set so no caller's flag leaks in).
            torch.backends.cuda.matmul.allow_tf32 = False
        self._module = copy.deepcopy(self.model.params).to(self.device)
        self._ensure_pool()

    def _ensure_pool(self) -> None:
        """Allocate the pool, shaped after the model, zero-filled: masked
        positions weigh exactly 0 in the attention, and 0 x NaN from
        uninitialised memory would be NaN."""
        m = self._module
        shape = (self.pool_slots, len(m.layers), self.capacity, m.heads, m.head_dim)
        self._kc = torch.zeros(shape, dtype=m.emb.dtype, device=self.device)
        self._vc = torch.zeros(shape, dtype=m.emb.dtype, device=self.device)

    def close(self) -> None:
        self._module = None
        self._kc = self._vc = None

    def warmup(self, admit_buckets: typing.Sequence[int],
               prompt_buckets: typing.Sequence[int]) -> None:
        """Run every (admit x prompt-length) prefill bucket plus the
        decode step once, so the kernel build and first launches happen
        before the first live session.  Warmup rows go to the
        out-of-range slot (dropped) and the warm decode runs fully masked
        — the pool stays clean.  Counters and metrics are suppressed.
        Without ``padding_buckets`` there is no finite set of shapes to
        warm, and nothing runs."""
        if not self.padding_buckets:
            return
        metrics, self._metrics = self._metrics, None
        saved = (self.step_h2d_bytes, self.block_h2d_events,
                 self.block_d2h_events, self.device_block_moves)
        try:
            for b in admit_buckets:
                for t in prompt_buckets:
                    t = min(t, self.capacity)
                    self.prefill([np.ones((t,), np.int32)], [t],
                                 [self.pool_slots], batch_bucket=b)
            self.decode_step([0] * self.pool_slots, [0] * self.pool_slots, [])
        finally:
            self._metrics = metrics
            (self.step_h2d_bytes, self.block_h2d_events,
             self.block_d2h_events, self.device_block_moves) = saved

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array).to(self.device)

    # -- dispatch ----------------------------------------------------------
    def _bucket_len(self, n: int) -> int:
        if not self.padding_buckets:
            return max(1, n)
        for b in self.prompt_buckets:
            if n <= b:
                return b
        return self.capacity

    def prefill(self, prompts: typing.Sequence, lengths: typing.Sequence[int],
                slots: typing.Sequence[int],
                *, batch_bucket: typing.Optional[int] = None) -> np.ndarray:
        """Prefill newly admitted sessions into their pool slots; returns
        the per-session first generated token (host int32, in order).
        Rows whose slot is ``pool_slots`` (bucket padding, warmup) are
        computed and dropped."""
        n = len(prompts)
        b = batch_bucket or n
        t = self._bucket_len(max(int(x) for x in lengths))
        tokens = np.zeros((b, t), np.int32)
        for i, p in enumerate(prompts):
            tokens[i, :len(p)] = p
        lens = np.zeros((b,), np.int32)
        lens[:n] = np.asarray(lengths, np.int32)
        slot_arr = np.full((b,), self.pool_slots, np.int32)
        slot_arr[:n] = np.asarray(slots, np.int32)
        t0 = time.monotonic()
        out = self._prefill.fn(self._module, {"tokens": self._to_device(tokens),
                                              "lengths": self._to_device(lens)})
        # The JAX scatter drops out-of-range slots; torch indexing would
        # raise, so the rows to keep are chosen on the host.
        rows = np.nonzero(slot_arr < self.pool_slots)[0]
        if len(rows):
            dst = self._to_device(slot_arr[rows].astype(np.int64))
            src = self._to_device(rows.astype(np.int64))
            for pool, new in ((self._kc, out["k_cache"]), (self._vc, out["v_cache"])):
                block = torch.zeros((len(rows), *pool.shape[1:]),
                                    dtype=pool.dtype, device=self.device)
                block[:, :, :t] = new[src]
                pool[dst] = block
        host = out["next_token"].cpu().numpy()[:n]
        t1 = time.monotonic()
        self.step_h2d_bytes += tokens.nbytes + lens.nbytes + slot_arr.nbytes
        if self._metrics is not None:
            self._metrics.histogram("prefill_s").record(t1 - t0)
            self._metrics.counter("prefill_batches").inc()
        return host

    def decode_step(self, tokens_by_slot, lengths_by_slot, active_slots) -> np.ndarray:
        """One decode step over the pool.  ``tokens_by_slot`` /
        ``lengths_by_slot``: ``[S]`` host ints (inactive rows 0);
        ``active_slots``: the slots whose results matter and whose cache
        rows are written.  Returns ``[S]`` next tokens (host int32).

        Without ``padding_buckets`` the step runs on the active rows only:
        they are copied out of the pool, stepped and copied back."""
        if self._kc is None:
            raise RuntimeError("decode_step before open()")
        t0 = time.monotonic()
        toks = np.asarray(tokens_by_slot, np.int32)
        lens = np.asarray(lengths_by_slot, np.int32)
        if self.padding_buckets:
            mask = np.zeros((self.pool_slots,), bool)
            mask[list(active_slots)] = True
            self.step_h2d_bytes += toks.nbytes + lens.nbytes + mask.nbytes
            result = self._decode.fn(self._module, {
                "token": self._to_device(toks), "lengths": self._to_device(lens),
                "k_cache": self._kc, "v_cache": self._vc,
                "active": self._to_device(mask)})
            out = result["next_token"].cpu().numpy()
        else:
            slots = np.asarray(sorted(active_slots), np.int64)
            self.step_h2d_bytes += toks[slots].nbytes + lens[slots].nbytes + slots.nbytes
            rows = self._to_device(slots)
            kc, vc = self._kc[rows], self._vc[rows]
            result = self._decode.fn(self._module, {
                "token": self._to_device(toks[slots]),
                "lengths": self._to_device(lens[slots]), "k_cache": kc, "v_cache": vc})
            self._kc[rows] = kc
            self._vc[rows] = vc
            out = np.zeros((self.pool_slots,), np.int32)
            out[slots] = result["next_token"].cpu().numpy()
        t1 = time.monotonic()
        if self._metrics is not None:
            self._metrics.histogram("decode_step_s").record(t1 - t0)
            self._metrics.counter("decode_steps").inc()
        return out

    # -- block movement (keyed-state residency boundary) -------------------
    def extract_block(self, slot: int, length: int, *, host: bool):
        """One session's cache out of the pool as ``(k, v)``.

        ``host=True`` copies to host numpy (barrier snapshots, host-mode
        preemption); ``host=False`` returns device copies — the pool is
        updated in place, so a block must own its bytes."""
        if not host:
            self.device_block_moves += 1
            return self._kc[slot].clone(), self._vc[slot].clone()
        self.block_d2h_events += 1
        # A copy even when the pool is on the CPU (where ``.cpu()`` returns
        # the pool's own view): a snapshot or a preempted block must not
        # change when the slot is written again.
        return (self._kc[slot].to("cpu", copy=True).numpy(),
                self._vc[slot].to("cpu", copy=True).numpy())

    def insert_block(self, slot: int, k, v) -> None:
        """One session's cache back into the pool.  Host arrays pay the
        h2d here; device tensors copy device-side."""
        is_host = isinstance(k, np.ndarray)
        self._kc[slot] = torch.as_tensor(k).to(self.device)
        self._vc[slot] = torch.as_tensor(v).to(self.device)
        if is_host:
            self.block_h2d_events += 1
        else:
            self.device_block_moves += 1


class PagedDecodeStepRunner(DecodeStepRunner):
    """Paged variant of :class:`DecodeStepRunner`: the device pool is
    ``num_pages`` fixed-size pages ``[P, L, page_tokens, H, Dh]`` and every
    active slot carries a block table instead of owning a contiguous
    ``[L, C, H, Dh]`` row.

    The step is gather -> the model's dense ``decode_step`` -> scatter
    (``ops/paged_attention.py``): the math is the dense step's over a
    materialized dense view, which is what makes paged output
    byte-identical to the dense pool on the same schedule.  The gathered
    view is a new contiguous ``[S, L, C, H, Dh]`` tensor (the dense
    pool's shape and layout), so the step writes into a copy before any
    byte of the pool changes, and the scatter writes every page of every
    table back.  The pool has one page more than ``num_pages``: the
    sentinel id ``num_pages`` names that scratch page, which no table
    reads, so sentinel entries (inactive and bucket-padding rows,
    unallocated and prefix-SHARED pages in a prefill's table) scatter
    into it with no host sync and no mask.  The per-step H2D is the
    ``[S]`` token and length vectors and the ``[S, C/page_tokens]`` block
    tables (``step_h2d_bytes``).

    The host-side policy objects
    (:class:`~flink_tensorflow_tpu_torch.serving.paged.PagedKVPool` free
    list and refcounts, the radix prefix index) live on this runner; the
    serving operator drives them through the block-movement methods
    (park/attach for hot preemption, insert/extract for the warm and cold
    tiers, ``ensure_writable`` for the copy-on-write check before each
    step's write position).  Paged mode requires ``padding_buckets``."""

    def __init__(
        self,
        model: Model,
        *,
        pool_slots: int,
        capacity: int,
        page_tokens: int = 16,
        num_pages: typing.Optional[int] = None,
        prefix_sharing: bool = True,
        padding_buckets: bool = True,
        prompt_buckets: typing.Optional[typing.Sequence[int]] = None,
        device=None,
    ):
        if not padding_buckets:
            raise ValueError(
                "paged KV requires padding_buckets — the paged step has "
                "exactly one [S, C/page_tokens] shape by design")
        super().__init__(model, pool_slots=pool_slots, capacity=capacity,
                         padding_buckets=padding_buckets,
                         prompt_buckets=prompt_buckets, device=device)
        self.page_tokens = page_tokens
        self.table_width = pages_per_session(capacity, page_tokens)
        self.num_pages = (num_pages if num_pages is not None
                          else pool_slots * self.table_width)
        if self.num_pages < self.table_width:
            raise ValueError(
                f"hbm_pages {self.num_pages} cannot seat even one "
                f"full-capacity session ({self.table_width} pages) — "
                "grow the pool or shrink capacity")
        # The serving package owns the pool's bookkeeping; imported here so
        # jobs that never serve do not load it.
        from flink_tensorflow_tpu_torch.serving.paged import PagedKVPool, RadixPrefixIndex

        self.pool = PagedKVPool(self.num_pages, page_tokens)
        self.index = RadixPrefixIndex(self.pool) if prefix_sharing else None
        #: Active slot -> block table (logical page i at position i).
        self._tables: typing.Dict[int, typing.List[int]] = {}

    def close(self) -> None:
        super().close()
        self._tables.clear()

    # -- pool geometry -----------------------------------------------------
    def _ensure_pool(self) -> None:
        """``num_pages`` pages plus the scratch page, zero-filled."""
        m = self._module
        shape = (self.num_pages + 1, len(m.layers), self.page_tokens, m.heads, m.head_dim)
        self._kc = torch.zeros(shape, dtype=m.emb.dtype, device=self.device)
        self._vc = torch.zeros(shape, dtype=m.emb.dtype, device=self.device)

    def page_nbytes(self) -> typing.Optional[int]:
        """K+V bytes of ONE page (None before the pool is built)."""
        if self._kc is None:
            return None
        return 2 * self._kc[0].numel() * self._kc.element_size()

    def _alloc(self, n: int) -> typing.Optional[typing.List[int]]:
        """Allocate ``n`` pages, evicting index-only pages LRU under
        pressure; None when the pool is genuinely out (the caller's tier
        machinery demotes parked sessions and retries)."""
        if n <= 0:
            return []
        got = self.pool.alloc(n)
        if got is None and self.index is not None:
            self.index.evict_until(n)
            got = self.pool.alloc(n)
        return got

    def free_pages_evictable(self) -> int:
        """Free pages plus what index eviction could free — the admission
        gate's optimistic bound."""
        free = self.pool.free_pages
        if self.index is not None:
            free += sum(1 for _, _, node in self.index._leaves()
                        if self.pool.refs[node.page] == 1)
        return free

    # -- dispatch ----------------------------------------------------------
    def prefill(self, prompts: typing.Sequence, lengths: typing.Sequence[int],
                slots: typing.Sequence[int],
                *, batch_bucket: typing.Optional[int] = None) -> np.ndarray:
        """Paged prefill: per session, adopt prefix pages from the radix
        index (refcount bump, no compute), allocate the rest, and scatter
        the freshly computed K/V ONLY into owned pages (the scatter table
        carries the sentinel where pages are shared — the first writer's
        bytes stay authoritative).  Rows whose slot is ``pool_slots``
        (bucket padding, warmup) are all-sentinel."""
        n = len(prompts)
        b = batch_bucket or n
        t = self._bucket_len(max(int(x) for x in lengths))
        tokens = np.zeros((b, t), np.int32)
        for i, p in enumerate(prompts):
            tokens[i, :len(p)] = p
        lens = np.zeros((b,), np.int32)
        lens[:n] = np.asarray(lengths, np.int32)
        scatter = np.full((b, self.table_width), self.num_pages, np.int32)
        for i, (p, ln, slot) in enumerate(zip(prompts, lengths, slots)):
            slot = int(slot)
            if slot >= self.pool_slots:
                continue  # warmup pad row: all-sentinel
            adopted: typing.List[int] = []
            if self.index is not None:
                full, partial = self.index.match(p)
                adopted = full + ([partial] if partial is not None else [])
            own_n = self.pool.pages_for(int(ln)) - len(adopted)
            own = self._alloc(own_n)
            if own is None:
                self.pool.release(adopted)
                raise RuntimeError(
                    f"paged KV pool exhausted at prefill: need {own_n} "
                    f"pages, {self.pool.free_pages} free — the admission "
                    "gate should have held this session back")
            table = adopted + own
            self._tables[slot] = table
            scatter[i, len(adopted):len(table)] = table[len(adopted):]
        t0 = time.monotonic()
        out = self._prefill.fn(self._module, {"tokens": self._to_device(tokens),
                                              "lengths": self._to_device(lens)})
        tables = self._to_device(scatter).long()
        for pool, new in ((self._kc, out["k_cache"]), (self._vc, out["v_cache"])):
            layers, heads, hd = new.shape[1], new.shape[3], new.shape[4]
            dense = torch.zeros((b, layers, self.capacity, heads, hd),
                                dtype=pool.dtype, device=self.device)
            dense[:, :, :t] = new
            scatter_pages(pool, tables, dense, self.page_tokens)
        host = out["next_token"].cpu().numpy()[:n]
        t1 = time.monotonic()
        self.step_h2d_bytes += tokens.nbytes + lens.nbytes + scatter.nbytes
        if self._metrics is not None:
            self._metrics.histogram("prefill_s").record(t1 - t0)
            self._metrics.counter("prefill_batches").inc()
        return host

    def step_tables(self) -> np.ndarray:
        """``[S, C/page_tokens]`` int32 block tables of the next step
        (sentinel ``num_pages`` where a slot has no page)."""
        tables = np.full((self.pool_slots, self.table_width), self.num_pages, np.int32)
        for slot, table in self._tables.items():
            tables[slot, :len(table)] = table
        return tables

    def decode_step(self, tokens_by_slot, lengths_by_slot, active_slots) -> np.ndarray:
        """One paged decode step: the block tables ride the per-step H2D
        beside the token and length vectors; rows without a table
        (inactive, warmup) gather and scatter the scratch page only."""
        if self._kc is None:
            raise RuntimeError("decode_step before open()")
        t0 = time.monotonic()
        tables = self.step_tables()
        toks = np.asarray(tokens_by_slot, np.int32)
        lens = np.asarray(lengths_by_slot, np.int32)
        self.step_h2d_bytes += toks.nbytes + lens.nbytes + tables.nbytes
        tab = self._to_device(tables).long()
        result = self._decode.fn(self._module, {
            "token": self._to_device(toks), "lengths": self._to_device(lens),
            "k_cache": gather_pages(self._kc, tab), "v_cache": gather_pages(self._vc, tab)})
        scatter_pages(self._kc, tab, result["k_cache"], self.page_tokens)
        scatter_pages(self._vc, tab, result["v_cache"], self.page_tokens)
        out = result["next_token"].cpu().numpy()
        t1 = time.monotonic()
        if self._metrics is not None:
            self._metrics.histogram("decode_step_s").record(t1 - t0)
            self._metrics.counter("decode_steps").inc()
        return out

    # -- copy-on-write / growth -------------------------------------------
    def ensure_writable(self, slot: int, length: int) -> bool:
        """Guarantee the page holding write position ``length`` exists and
        is exclusively owned before the step runs.  Allocates the next
        page at a page boundary; splits a shared page (copy-on-write) when
        the write would land in bytes the prefix index or another session
        still references — the copy is queued on the pool's stream ahead
        of the step.  False = the pool is out of pages even after index
        eviction: the operator's tier machinery must free pressure and
        retry."""
        table = self._tables[slot]
        li = length // self.page_tokens
        while len(table) <= li:
            got = self._alloc(1)
            if got is None:
                return False
            table.extend(got)
        pid = table[li]
        if self.pool.is_shared(pid):
            got = self._alloc(1)
            if got is None:
                return False
            self.copy_page(pid, got[0])
            self.pool.decref(pid)
            self.pool.cow_splits += 1
            table[li] = got[0]
        return True

    def copy_page(self, src: int, dst: int) -> None:
        """The copy-on-write split: duplicate one page device-side."""
        self._kc[dst].copy_(self._kc[src])
        self._vc[dst].copy_(self._vc[src])

    # -- block movement (tier-ladder boundary) -----------------------------
    def park(self, slot: int, length: int) -> PagedKVHandle:
        """Hot preemption: the session's pages STAY on the device behind a
        :class:`~flink_tensorflow_tpu_torch.serving.paged.PagedKVHandle`;
        only the block table leaves the step batch.  No traffic."""
        from flink_tensorflow_tpu_torch.serving.paged import PagedKVHandle

        table = self._tables.pop(slot)
        self.device_block_moves += 1
        return PagedKVHandle(table, length)

    def attach(self, slot: int, handle: PagedKVHandle) -> None:
        """Re-admission of a hot-parked session: re-attach the table."""
        self._tables[slot] = list(handle.pages)
        self.device_block_moves += 1

    def _gather_host(self, pages: typing.Sequence[int]):
        """Pages -> dense host ``[L, C, H, Dh]`` K/V, zero-filled beyond
        the given pages (positions past a session's length are masked by
        every consumer).  New host arrays, never views of the pool, even
        when the pool is on the CPU: the pages are written again."""
        ids = torch.as_tensor(list(pages), dtype=torch.long).to(self.device)
        out = []
        for pool in (self._kc, self._vc):
            got = pool.index_select(0, ids).cpu().numpy()      # a new tensor
            dense = np.zeros((pool.shape[1], self.capacity, *pool.shape[3:]), got.dtype)
            dense[:, :len(pages) * self.page_tokens] = pages_to_dense(got[None])[0]
            out.append(dense)
        return out[0], out[1]

    def snapshot_block(self, slot: int, length: int):
        """Barrier copy of an ACTIVE session: dense host K/V, pages
        untouched (the pool stays authoritative)."""
        k, v = self._gather_host(self._tables[slot])
        self.block_d2h_events += 1
        return k, v

    def extract_host(self, slot: int, length: int):
        """Demotion of an ACTIVE session (pressure preemption to the warm
        tier): dense host K/V out, pages released."""
        table = self._tables.pop(slot)
        k, v = self._gather_host(table)
        self.pool.release(table)
        self.block_d2h_events += 1
        return k, v

    def demote_handle(self, handle: PagedKVHandle) -> KVBlock:
        """Hot -> warm: a PARKED session's pages gather D2H into a host
        :class:`~flink_tensorflow_tpu_torch.serving.kv_cache.KVBlock` and
        free."""
        from flink_tensorflow_tpu_torch.serving.kv_cache import KVBlock

        k, v = self._gather_host(handle.pages)
        self.pool.release(handle.pages)
        self.block_d2h_events += 1
        return KVBlock(k, v, handle.length)

    def insert_block(self, slot: int, k, v, length: typing.Optional[int] = None) -> None:
        """Warm/cold revival: a host block's exact bytes back into freshly
        allocated pages (the admission gate reserved them).  ``length``
        bounds the pages allocated — a full-capacity scatter would waste
        pages on masked positions."""
        if length is None:
            length = k.shape[1]
        n = self.pool.pages_for(int(length))
        got = self._alloc(n)
        if got is None:
            raise RuntimeError(
                f"paged KV pool exhausted at re-admission: need {n} "
                f"pages, {self.pool.free_pages} free — the admission "
                "gate should have held this session back")
        self._tables[slot] = got
        ids = torch.as_tensor(got, dtype=torch.long).to(self.device)
        for pool, block in ((self._kc, k), (self._vc, v)):
            pages = dense_to_pages(np.asarray(block)[None], self.page_tokens)[0][:n]
            pool.index_copy_(0, ids, torch.from_numpy(np.ascontiguousarray(pages))
                             .to(device=self.device, dtype=pool.dtype))
        self.block_h2d_events += 1

    def release_finished(self, slot: int, cached_tokens, length: int) -> None:
        """A finished session leaves the pool: its FULL pages publish to
        the prefix index (keyed by the token sequence that produced them),
        everything else frees."""
        table = self._tables.pop(slot)
        if self.index is not None:
            self.index.publish(cached_tokens, table)
        self.pool.release(table)

    def extract_block(self, slot: int, length: int, *, host: bool):
        """The dense runner's extraction maps onto pages as a snapshot
        (host copy, pages kept): the barrier hook's call.  A device
        extraction is a dense-pool notion; paged preemption parks."""
        if not host:
            raise RuntimeError(
                "paged preemption parks pages (park()/attach()); "
                "device-resident extract_block is a dense-pool concept")
        return self.snapshot_block(slot, length)


#: Dispatch lane threads of a :class:`CompiledMethodRunner` at the least:
#: with one transfer lane the runner still double-buffers on two, as the
#: reference does (JAX ``:1169-1185``).
LANES = 2
#: Seconds ``close()`` lets in-flight batches drain through the fetch
#: thread, then waits for the thread to end (JAX ``:1239-1280``).
CLOSE_DRAIN_S = 60.0
FETCH_JOIN_S = 10.0

_cudnn_lock = threading.Lock()
_cudnn_holders = 0
_cudnn_saved_benchmark = False


def hold_cudnn_heuristics() -> None:
    """Turn cuDNN's timed algorithm search (``cudnn.benchmark``) off while
    any runner on the card is open.  PyTorch keeps the timed choices per
    THREAD, so two dispatch lanes (or a direct call) could run one batch
    with different algorithms and round it differently; the heuristic
    choice is the same on every thread.  The flag is process-wide, so the
    caller's value is saved by the first holder and restored by the last
    :func:`release_cudnn_heuristics`.  TF32 and every other numeric flag
    stay the caller's choice."""
    global _cudnn_holders, _cudnn_saved_benchmark
    with _cudnn_lock:
        if _cudnn_holders == 0:
            _cudnn_saved_benchmark = torch.backends.cudnn.benchmark
        _cudnn_holders += 1
        torch.backends.cudnn.benchmark = False


def release_cudnn_heuristics() -> None:
    global _cudnn_holders
    with _cudnn_lock:
        _cudnn_holders -= 1
        if _cudnn_holders == 0:
            torch.backends.cudnn.benchmark = _cudnn_saved_benchmark


def _on_device(t: torch.Tensor, device: torch.device) -> bool:
    """Whether ``t`` lies on ``device``; a device without an index
    (``cuda``) stands for the card tensors land on by default."""
    if t.device.type != device.type:
        return False
    return device.index is None or t.device.index == device.index


class _FetchError:
    """Completed-queue marker for a batch whose lane work or fetch failed;
    the exception re-raises on the collecting thread."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class CompiledMethodRunner:
    """Executes one model method on one device, on bucketed micro-batches.

    ``output_names`` selects the outputs the job consumes: the others are
    dropped on the device, so the D2H moves only these.  Assemble + H2D +
    launch run on ``max(LANES, dispatch_lanes)`` lane threads, so the host
    work of batch N+1 overlaps batch N and the subtask thread never pays
    it; results still leave in dispatch order.  ``wire_dtype`` narrows
    float fields on the H2D, and the call widens them back (``x.to(the
    declared dtype)``, then ``* scale`` for int8) before the method runs.
    With ``stamp_stages`` each result carries ``meta["__stages__"]``: the
    reference's stage boundaries of its batch (``t0`` dispatch call,
    ``t_lane_start`` a lane took it and assembled it, ``t_dispatched``
    H2D and launch enqueued, ``t_fetch_start`` the fetch thread reached
    it, ``t_done`` results on the host; ``lane_wait_s``, ``assemble_s``,
    ``dispatch_s``, ``batch_n``).  ``service_ewma_s`` is the EWMA of
    dispatch -> results per batch, which latency-budget triggers reserve.

    :meth:`dispatch_batch` ships a batch assembled elsewhere (the ring's
    views) with no assemble copy; its ``on_done`` runs when the batch's
    results are collected, on the collecting thread, in dispatch order,
    after the batch's H2D event has completed."""

    def __init__(
        self,
        model: Model,
        method_name: str = "serve",
        *,
        policy: typing.Optional[BucketPolicy] = None,
        device=None,
        output_names: typing.Optional[typing.Sequence[str]] = None,
        dispatch_lanes: int = 1,
        wire_dtype: typing.Optional[str] = None,
    ):
        if dispatch_lanes < 1:
            raise ValueError("dispatch_lanes must be >= 1")
        self.model = model
        self.method = model.method(method_name)
        self.policy = policy or BucketPolicy()
        self.device = device
        self.output_names = tuple(output_names) if output_names is not None else None
        self.dispatch_lanes = dispatch_lanes
        #: Lane threads: at least LANES, so one transfer lane still overlaps.
        self.lanes = max(LANES, dispatch_lanes)
        self.wire_dtype = normalize_wire_dtype(wire_dtype)
        #: Leave each batch's outputs on the device as one DeviceBatch
        #: (no D2H); set by the model function at open().
        self.emit_device_batches = False
        self.stamp_stages = False
        self.service_ewma_s: typing.Optional[float] = None
        #: The fetch thread, when ``close()`` gave up joining it: memory
        #: its batches read must outlive it (``wedged_fetcher.join()``).
        self.wedged_fetcher: typing.Optional[threading.Thread] = None
        self._module = None
        self._call = None
        self._stream: typing.Optional[torch.cuda.Stream] = None
        self._transfer: typing.Optional[DeviceTransfer] = None
        self._pool: typing.Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._holds_cudnn = False
        self._metrics = None
        #: In-flight batches, ``(lane future, on_done)`` in dispatch order;
        #: appended by the dispatching thread, consumed FIFO by the fetch
        #: thread; guarded by ``_lock``.
        self._pending: collections.deque = collections.deque()
        #: Fetched batches waiting for the collecting thread: ``(results,
        #: on_done, H2D event)`` or a :class:`_FetchError`.
        self._completed: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._work_cv = threading.Condition(self._lock)
        self._done_cv = threading.Condition(self._lock)
        self._fetcher: typing.Optional[threading.Thread] = None
        self._fetch_stop = False
        #: Zero-arg callback fired (from the fetch thread) when a batch's
        #: results land — the subtask gate's ``wake``.
        self.on_results_ready: typing.Optional[typing.Callable[[], None]] = None

    # -- lifecycle ---------------------------------------------------------
    def open(self, ctx=None) -> None:
        device = self.device
        if device is None and ctx is not None:
            device = ctx.device
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            if not self._holds_cudnn:
                hold_cudnn_heuristics()
                self._holds_cudnn = True
            self._stream = torch.cuda.Stream(self.device)
        # Params to the device once.
        self._module = copy.deepcopy(self.model.params).to(self.device).eval()
        self._transfer = DeviceTransfer(self.device, slots=self.lanes + 2,
                                        wire_dtype=self.wire_dtype)

        method = self.method
        select = self.output_names
        schema = method.input_schema
        restore = {n: torch_dtype(schema[n].dtype) for n in schema.names}

        def widen(inputs):
            # A field that arrives in another dtype (narrowed on the wire,
            # or an upstream device batch's) is cast back to the schema's
            # as the first step; an int8 one also takes its scale back.
            out = {}
            for k, v in inputs.items():
                if is_scale_key(k):
                    continue
                want = restore.get(k)
                if want is not None and v.dtype != want:
                    v = v.to(want)
                    scale = inputs.get(scale_key(k))
                    if scale is not None:
                        v = v * scale
                out[k] = v
            return out

        def call(inputs, lengths):
            inputs = widen(inputs)
            if method.needs_lengths:
                outputs = method.fn(self._module, inputs, lengths)
            else:
                outputs = method.fn(self._module, inputs)
            if select is None:
                return outputs
            missing = set(select) - set(outputs)
            if missing:
                raise KeyError(f"method {method.name!r} has no outputs {missing}")
            return {k: outputs[k] for k in select}

        self._call = call
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=self.lanes, thread_name_prefix=f"{self.model.name}-dispatch")
        if self._fetcher is None:
            self._fetch_stop = False
            self._fetcher = threading.Thread(target=self._fetch_loop,
                                             name=f"{self.model.name}-fetch", daemon=True)
            self._fetcher.start()
        if ctx is not None:
            self._metrics = ctx.metrics

    def warmup(self, batch_sizes: typing.Iterable[int], length_bucket: int = 128) -> None:
        """Run each batch bucket on every dispatch lane, and through every
        staging slot, before the first live window: the first calls'
        one-time costs (cuDNN's algorithm choice and plans, which PyTorch
        keeps per thread; allocator growth; pinned staging buffers, sized
        here by the largest bucket and ``length_bucket``) stay out of the
        live windows, the metrics and the service-time EWMA."""
        schema = self.method.input_schema
        shapes = schema.resolve_dynamic(length_bucket)
        metrics, self._metrics = self._metrics, None
        lanes = self.lanes
        # Each lane task waits for all the others, so every lane thread
        # takes exactly one of them; as many rounds as it takes for the
        # staging slots (taken in turn) to all be used.
        barrier = threading.Barrier(lanes)
        rounds = max(1, -(-self._transfer.slots // lanes))

        def on_each_lane(records, t0):
            barrier.wait(timeout=600)
            return self._dispatch_work(records, t0)

        t0 = time.monotonic()
        try:
            for b in batch_sizes:
                fields = {n: np.zeros(shapes[n], schema[n].dtype) for n in schema.names}
                records = [TensorValue(fields)] * b
                for _ in range(rounds * lanes):
                    self._enqueue(self._pool.submit(on_each_lane, records, time.monotonic()))
                self.flush()
        finally:
            self._metrics = metrics
            self.service_ewma_s = None
        if metrics is not None:
            metrics.histogram("warmup_s").record(time.monotonic() - t0)

    def close(self) -> None:
        """Drain dispatched work through the fetch thread (running the
        ``on_done`` of every batch it completes, on this thread), then stop
        the threads.  If the fetch thread does not end within
        ``FETCH_JOIN_S`` it is left in ``wedged_fetcher``: the caller must
        not free memory its batches read until it has ended."""
        deadline = time.monotonic() + CLOSE_DRAIN_S
        while True:
            with self._lock:
                entries = list(self._completed)
                self._completed.clear()
                if not entries:
                    fetching = (self._pending and self._fetcher is not None
                                and self._fetcher.is_alive())
                    if fetching and time.monotonic() < deadline:
                        self._done_cv.wait(timeout=0.5)
                        continue
            for e in entries:
                try:
                    self._consume(e)
                except Exception:  # noqa: BLE001 - errors are moot at teardown
                    pass
            if not entries:
                break
        with self._lock:
            self._fetch_stop = True
            self._pending.clear()
            self._completed.clear()
            self._work_cv.notify_all()
        if self._fetcher is not None:
            self._fetcher.join(timeout=FETCH_JOIN_S)
            if self._fetcher.is_alive():
                self.wedged_fetcher = self._fetcher
            self._fetcher = None
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
        if self._holds_cudnn:
            release_cudnn_heuristics()
            self._holds_cudnn = False
        self._module = None
        self._call = None

    # -- execution ---------------------------------------------------------
    def dispatch(self, records: typing.Sequence[typing.Any]) -> None:
        """Assemble + transfer + launch one micro-batch WITHOUT waiting for
        the device.  Results are collected in dispatch order by
        :meth:`collect_ready` / :meth:`collect_available` / :meth:`flush`."""
        if self._call is None:
            raise RuntimeError("runner not opened")
        self._enqueue(self._pool.submit(self._dispatch_work, list(records), time.monotonic()))

    def dispatch_batch(self, batch: Batch, *, assemble_s: float = 0.0,
                       on_done: typing.Optional[typing.Callable[[], None]] = None,
                       ready: typing.Optional[typing.Callable[[], None]] = None) -> None:
        """Transfer + launch a batch assembled elsewhere (JAX ``:1304-1330``),
        from where its arrays lie: no assemble copy.  ``ready`` runs on the
        lane first (the ring's wait for the batch's rows).  ``on_done``
        runs when the batch's results are collected, on the collecting
        thread and in dispatch order, once the batch's H2D has completed:
        the ring releases the batch's slots there."""
        if self._call is None:
            raise RuntimeError("runner not opened")
        self._enqueue(self._pool.submit(self._launch_batch, batch, time.monotonic(),
                                        assemble_s, ready), on_done)

    def _enqueue(self, item, on_done=None) -> None:
        with self._lock:
            self._pending.append((item, on_done))
            self._work_cv.notify()

    def _dispatch_work(self, records, t0: float):
        """Assemble, H2D, launch, enqueue the D2H (on a lane thread);
        returns ``(batch, fetch handle, timings, H2D event)``."""
        records = [r if isinstance(r, TensorValue) else coerce(r, self.method.input_schema)
                   for r in records]
        stream = (torch.cuda.stream(self._stream) if self._stream is not None
                  else contextlib.nullcontext())
        t_b = time.monotonic()
        with stream, torch.inference_mode():
            shipped = self._transfer.assemble_and_ship(
                records, self.method.input_schema, self.policy)
            t_h2d = time.monotonic()
            handle = self._finish_launch(self._call(shipped.inputs, shipped.lengths))
        # As the reference's stamps: the lane's wait includes the assembly.
        return self._launched(shipped, handle, t0, t_b + shipped.assemble_s, t_h2d,
                              shipped.assemble_s)

    def _launch_batch(self, batch: Batch, t0: float, assemble_s: float, ready):
        """The lane work of :meth:`dispatch_batch`: H2D and launch."""
        stream = (torch.cuda.stream(self._stream) if self._stream is not None
                  else contextlib.nullcontext())
        t_b = time.monotonic()
        if ready is not None:
            ready()
        with stream, torch.inference_mode():
            shipped = self._transfer.ship_batch(batch)
            t_h2d = time.monotonic()
            handle = self._finish_launch(self._call(shipped.inputs, shipped.lengths))
        return self._launched(shipped, handle, t0, t_b, t_h2d, assemble_s)

    @staticmethod
    def _launched(shipped, handle: FetchHandle, t0: float, t_lane_start: float,
                  t_h2d: float, assemble_s: float):
        t_c = time.monotonic()
        timings = {
            "t0": t0,
            "assemble_s": assemble_s,
            # Host seconds from the assembled batch to the launched call
            # and its queued D2H (staging wait + H2D enqueue + launches).
            "dispatch_s": t_c - t_lane_start,
            "h2d_s": t_h2d - t_lane_start,
            "h2d_bytes": shipped.h2d_bytes,
            "wire_saved": shipped.wire_saved,
            "pinned_allocations": shipped.pinned_allocations,
            "t_lane_start": t_lane_start,
            "t_dispatched": t_c,
        }
        return shipped.batch, handle, timings, shipped.copied

    def _finish_launch(self, outputs) -> FetchHandle:
        if self.emit_device_batches:
            return self._transfer.keep_on_device(outputs)
        return self._transfer.start_fetch(outputs)

    # -- device-resident input ---------------------------------------------
    def can_accept_device(self, dbatch: DeviceBatch) -> bool:
        """Whether an upstream DeviceBatch can feed the method as it is:
        every schema field among its tensors, on this runner's device,
        with the schema's static trailing shape.  A dtype may differ (the
        call casts it first).  A method that takes per-record lengths
        stays on the host path."""
        if self.method.needs_lengths:
            return False
        schema = self.method.input_schema
        for name in schema.names:
            t = dbatch.tensors.get(name)
            if t is None or not _on_device(t, self.device):
                return False
            want = schema[name].shape
            got = tuple(t.shape[1:])
            if len(got) != len(want) or any(d is not None and d != g
                                            for d, g in zip(want, got)):
                return False
        return True

    def dispatch_device(self, dbatch: DeviceBatch) -> bool:
        """Launch the method on an upstream DeviceBatch with no H2D.
        Returns False, and counts ``device_batch_host_fallbacks``, when
        the batch does not fit the schema: the caller then materializes
        it and takes the host path."""
        if self._call is None:
            raise RuntimeError("runner not opened")
        if not self.can_accept_device(dbatch):
            if self._metrics is not None:
                self._metrics.counter("device_batch_host_fallbacks").inc()
            return False
        self._enqueue(self._pool.submit(self._launch_device, dbatch, time.monotonic()))
        return True

    def _launch_device(self, dbatch: DeviceBatch, t0: float):
        """The lane work of :meth:`dispatch_device`: the compute stream
        waits for the producer, then the method runs on its tensors."""
        stream = (torch.cuda.stream(self._stream) if self._stream is not None
                  else contextlib.nullcontext())
        t_b = time.monotonic()
        with stream, torch.inference_mode():
            dbatch.wait_on(self._stream)
            inputs = {n: dbatch.tensors[n] for n in self.method.input_schema.names}
            handle = self._finish_launch(self._call(inputs, {}))
        t_c = time.monotonic()
        timings = {
            "t0": t0, "assemble_s": 0.0, "dispatch_s": t_c - t_b,
            "h2d_s": 0.0, "h2d_bytes": 0, "wire_saved": 0, "pinned_allocations": 0,
            "h2d_elided": True, "t_lane_start": t_b, "t_dispatched": t_c,
        }
        shell = Batch(arrays={}, valid=dbatch.valid, lengths={}, metas=dbatch.metas)
        return shell, handle, timings, None

    # -- background fetch ---------------------------------------------------
    def _fetch_loop(self) -> None:
        """Resolve the oldest in-flight batch, wait for its own event, and
        hand its per-record results to the completed queue (FIFO)."""
        while True:
            with self._lock:
                while not self._pending and not self._fetch_stop:
                    self._work_cv.wait()
                if not self._pending:
                    return  # stop requested and queue drained
                item, on_done = self._pending[0]
            try:
                results, copied = self._process_item(item)
                entry = (results, on_done, copied)
            except BaseException as exc:  # noqa: BLE001 - re-raised on collect
                entry = _FetchError(exc)
            with self._lock:
                if self._pending:
                    self._pending.popleft()
                if not self._fetch_stop:
                    self._completed.append(entry)
                self._done_cv.notify_all()
            cb = self.on_results_ready
            if cb is not None:
                cb()

    def _process_item(self, item: concurrent.futures.Future):
        batch, handle, timings, copied = item.result()  # re-raises lane failures here
        # After the lane's future: a wait for the lane belongs before it.
        t_fetch = time.monotonic()
        if handle.on_device:
            # The compute's event is the pipeline-depth barrier the D2H
            # gave; the outputs leave as one batch, still on the device.
            if handle.done is not None:
                handle.done.synchronize()
            results = [DeviceBatch(handle.host, batch.valid, batch.metas,
                                   ready=handle.done, metrics=self._metrics)]
            d2h_bytes = None
        else:
            host = self._transfer.finish_fetch(handle)   # this batch's event only
            results = batch.unbatch(host)
            d2h_bytes = sum(a.nbytes for a in host.values())
        t_done = time.monotonic()
        dt = t_done - timings["t0"]
        self.service_ewma_s = dt if self.service_ewma_s is None else (
            0.75 * self.service_ewma_s + 0.25 * dt)
        if self.stamp_stages and d2h_bytes is not None:
            stages = {
                "t0": timings["t0"],
                "lane_wait_s": timings["t_lane_start"] - timings["t0"],
                "assemble_s": timings["assemble_s"],
                "dispatch_s": timings["dispatch_s"],
                "t_lane_start": timings["t_lane_start"],
                "t_dispatched": timings["t_dispatched"],
                "t_fetch_start": t_fetch,
                "t_done": t_done,
                "batch_n": len(results),
            }
            for r in results:
                r.meta["__stages__"] = dict(stages)   # each record its own copy
        m = self._metrics
        if m is not None:
            if timings.get("h2d_elided"):
                m.counter("h2d_elided_batches").inc()
            else:
                m.counter("h2d_batches").inc()
            if d2h_bytes is None:
                m.counter("fetch_elided_batches").inc()
            else:
                m.counter("d2h_batches").inc()
                m.counter("d2h_bytes").inc(d2h_bytes)
            n = batch.num_records
            m.meter("records").mark(n)
            m.histogram("batch_latency_s").record(dt)
            m.histogram("record_latency_s").record(dt / max(1, n))
            m.histogram("assemble_s").record(timings["assemble_s"])
            m.histogram("dispatch_s").record(timings["dispatch_s"])
            m.histogram("h2d_s").record(timings["h2d_s"])
            # Compute wait + D2H: the fetch thread's wait on the event.
            m.histogram("fetch_wait_s").record(t_done - t_fetch)
            m.counter("h2d_bytes").inc(timings["h2d_bytes"])
            if timings["wire_saved"]:
                m.counter("wire_bytes_saved").inc(timings["wire_saved"])
            m.counter("pinned_allocations").inc(timings["pinned_allocations"])
            m.counter("batches").inc()
            m.counter("padded_records").inc(batch.padded_size - batch.num_records)
        return results, copied

    def _consume(self, entry) -> typing.List[TensorValue]:
        if isinstance(entry, _FetchError):
            raise entry.exc
        results, on_done, copied = entry
        if on_done is not None:
            if copied is not None and not copied.query():
                # Counted: the fetch waits on the compute, which waited on
                # this copy, so a wait here means that order broke.
                if self._metrics is not None:
                    self._metrics.counter("release_h2d_waits").inc()
                copied.synchronize()
            on_done()
        return results

    def has_completed(self) -> bool:
        return bool(self._completed)

    @property
    def in_flight(self) -> int:
        """Batches dispatched and not yet fetched."""
        return len(self._pending)

    def collect_ready(self, max_in_flight: int = 1) -> typing.List[TensorValue]:
        """Drain completed batches until <= ``max_in_flight`` remain in
        flight, waiting as needed."""
        max_in_flight = max(0, max_in_flight)
        out: typing.List[TensorValue] = []
        while True:
            with self._lock:
                entries = list(self._completed)
                self._completed.clear()
                done = len(self._pending) <= max_in_flight
                if not entries and not done:
                    self._done_cv.wait(timeout=0.2)
                    if (self._fetcher is None or not self._fetcher.is_alive()) \
                            and self._pending and not self._completed:
                        raise RuntimeError("fetch thread died with batches in flight")
                    continue
            for e in entries:
                out.extend(self._consume(e))
            if done:
                return out

    def collect_available(self) -> typing.List[TensorValue]:
        """Drain every batch already fetched; never waits on the device."""
        out: typing.List[TensorValue] = []
        while True:
            with self._lock:
                if not self._completed:
                    return out
                entry = self._completed.popleft()
            out.extend(self._consume(entry))

    def collect_progress(self, max_in_flight: int) -> typing.List[TensorValue]:
        """Everything already fetched, then wait only as far as the
        pipeline-depth bound requires."""
        out = self.collect_available()
        out.extend(self.collect_ready(max_in_flight))
        return out

    def flush(self) -> typing.List[TensorValue]:
        """Wait for every in-flight batch (end of input / pre-snapshot)."""
        return self.collect_ready(0)
