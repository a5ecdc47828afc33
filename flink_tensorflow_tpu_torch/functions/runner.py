"""DecodeStepRunner — autoregressive decode dispatch for the serving plane.

Port of ``flink_tensorflow_tpu/functions/runner.py:DecodeStepRunner`` (and
of what ``_build_decode_calls`` compiled for it):

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

The decode step always runs the full pool ``[S]`` (inactive rows
masked), and prefill shapes quantize to the admit x prompt-length grid.
"""

from __future__ import annotations

import copy
import time
import typing

import numpy as np
import torch

from flink_tensorflow_tpu_torch.models.base import Model
from flink_tensorflow_tpu_torch.utils.device import resolve_device

if typing.TYPE_CHECKING:
    from flink_tensorflow_tpu_torch.core.runtime_context import RuntimeContext


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
        prompt_buckets: typing.Optional[typing.Sequence[int]] = None,
        device=None,
    ):
        self.model = model
        self.pool_slots = pool_slots
        self.capacity = capacity
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
        m = self._module
        shape = (self.pool_slots, len(m.layers), self.capacity, m.heads, m.head_dim)
        dtype = m.emb.dtype
        self._kc = torch.zeros(shape, dtype=dtype, device=self.device)
        self._vc = torch.zeros(shape, dtype=dtype, device=self.device)

    def close(self) -> None:
        self._module = None
        self._kc = self._vc = None

    def warmup(self, admit_buckets: typing.Sequence[int],
               prompt_buckets: typing.Sequence[int]) -> None:
        """Run every (admit x prompt-length) prefill bucket plus the
        decode step once, so the kernel build and first launches happen
        before the first live session.  Warmup rows go to the
        out-of-range slot (dropped) and the warm decode runs fully masked
        — the pool stays clean.  Counters and metrics are suppressed."""
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
        rows are written.  Returns ``[S]`` next tokens (host int32)."""
        if self._kc is None:
            raise RuntimeError("decode_step before open()")
        t0 = time.monotonic()
        mask = np.zeros((self.pool_slots,), bool)
        mask[list(active_slots)] = True
        toks = np.asarray(tokens_by_slot, np.int32)
        lens = np.asarray(lengths_by_slot, np.int32)
        self.step_h2d_bytes += toks.nbytes + lens.nbytes + mask.nbytes
        result = self._decode.fn(self._module, {
            "token": self._to_device(toks), "lengths": self._to_device(lens),
            "k_cache": self._kc, "v_cache": self._vc,
            "active": self._to_device(mask)})
        out = result["next_token"].cpu().numpy()
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
        return self._kc[slot].cpu().numpy(), self._vc[slot].cpu().numpy()

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
