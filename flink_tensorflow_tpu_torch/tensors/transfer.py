"""Host <-> device transfer of assembled batches.

Port of ``flink_tensorflow_tpu/tensors/transfer.py:DeviceTransfer``
(``:83``).  The reference ships a batch with one ``jax.device_put`` and
fetches with one ``jax.device_get``; on a CUDA card the same contract is
kept with explicit streams and events:

- one **pinned staging slot per in-flight batch**: ``assemble`` writes the
  records (and the ``[B]`` lengths of dynamic fields) straight into the
  slot's page-locked buffers (``alloc``), so the stacking copy is the only
  host copy; a slot's buffers grow to the largest batch and are reused
  as views, so length buckets allocate nothing in the steady state;
- one ``non_blocking`` H2D per field, on the transfer's own **side
  stream**, followed by an event; the compute stream waits on that event
  (the host never blocks on the copy), and the device tensors are marked
  with ``record_stream`` so the caching allocator cannot hand their
  memory out again before the compute stream is done with them;
- a slot is reused only after its previous H2D has finished (its event is
  synchronized first), so a pinned buffer is never overwritten under a
  copy that still reads it;
- the D2H moves only the outputs the job selected, into pinned host
  buffers, on the compute stream, followed by a per-batch event that the
  fetch thread waits on; it never synchronizes the whole device.

On the CPU (a provider that returns ``cpu``) the same calls run the
plain path: the staging buffers are ordinary numpy arrays shared with the
tensors, and the fetch is a conversion.

:class:`DeviceBatch` (JAX ``:192-300``) is a batch of outputs left on the
device for the next fused operator (``JobConfig.device_resident``): its
consumer waits on the producer's event and marks the tensors as used on
its own stream before it launches, and the first host-only consumer
materializes it, once.
"""

from __future__ import annotations

import threading
import time
import typing

import numpy as np
import torch

from flink_tensorflow_tpu_torch.tensors.batching import Batch, BucketPolicy, assemble, length_key
from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema
from flink_tensorflow_tpu_torch.tensors.value import TensorValue


def torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty((0,), dtype=dtype)).dtype


class StagingSlot:
    """Pinned host buffers for one in-flight batch, the event of the H2D
    copy that last read them, and the lock its user holds from assembly
    until that copy is enqueued.

    Each field keeps one flat pinned buffer, grown to the largest batch
    seen, and a batch takes a view of its front: length buckets change a
    batch's shape on most windows, and a pinned allocation per new shape
    would stay in the steady state.  ``allocations`` counts the pinned
    allocations made."""

    __slots__ = ("buffers", "tensors", "copied", "lock", "allocations")

    def __init__(self) -> None:
        self.buffers: typing.Dict[str, torch.Tensor] = {}
        #: The current batch's views of ``buffers``, by field.
        self.tensors: typing.Dict[str, torch.Tensor] = {}
        self.copied: typing.Optional[torch.cuda.Event] = None
        self.lock = threading.Lock()
        self.allocations = 0

    def alloc(self, name: str, shape, dtype) -> np.ndarray:
        """``assemble``'s allocator: a numpy view, of this shape and dtype,
        of the field's pinned buffer (grown when it is too small)."""
        shape = tuple(shape)
        tdt = torch_dtype(dtype)
        numel = int(np.prod(shape))
        buf = self.buffers.get(name)
        if buf is None or buf.dtype != tdt or buf.numel() < numel:
            buf = torch.empty((numel,), dtype=tdt, pin_memory=True)
            self.buffers[name] = buf
            self.allocations += 1
        view = buf[:numel].view(shape)
        self.tensors[name] = view
        return view.numpy()


class Shipped(typing.NamedTuple):
    """One batch on its way to the device."""

    batch: Batch
    inputs: typing.Dict[str, torch.Tensor]
    #: ``[B]`` int32 true lengths per dynamic field, on the device.
    lengths: typing.Dict[str, torch.Tensor]
    h2d_bytes: int
    assemble_s: float
    #: Pinned staging buffers this batch had to allocate (grow).
    pinned_allocations: int


class FetchHandle:
    """Outputs on their way to the host: pinned buffers and the event
    recorded after their copies (None on the CPU).  With ``on_device``
    the tensors are the outputs themselves, left on the device, and the
    event marks the end of the computation that wrote them."""

    __slots__ = ("host", "done", "on_device")

    def __init__(self, host: typing.Dict[str, torch.Tensor],
                 done: typing.Optional[torch.cuda.Event], on_device: bool = False):
        self.host = host
        self.done = done
        self.on_device = on_device


class DeviceBatch:
    """A micro-batch of outputs left on the producer's device, riding the
    chain as one record.

    ``tensors`` are ``[B, ...]`` tensors written on the producer's stream;
    ``ready`` is the event recorded after that work (None on the CPU).
    ``valid`` and ``metas`` are the batch's bookkeeping: pad rows and each
    record's metadata.  A fused operator that declares
    ``accepts_device_batches`` consumes the tensors in place: it calls
    :meth:`wait_on` with its own stream first, so its kernels run after
    the producer's and the caching allocator keeps the blocks until its
    own work on them is done.  Any other consumer gets host records: the
    runtime calls :meth:`materialize` at the boundary, and the D2H runs
    there once (counted as ``d2h_batches`` / ``d2h_bytes`` in ``metrics``,
    the producing operator's metric group).  Pickling raises: a channel
    or a checkpoint is a host boundary and materializes first."""

    #: Marker the runtime tests (no import of this module needed).
    is_device_batch = True

    __slots__ = ("tensors", "valid", "metas", "timestamp", "ready", "_metrics",
                 "_host", "_lock")

    def __init__(self, tensors: typing.Mapping[str, torch.Tensor], valid: np.ndarray,
                 metas: typing.Sequence[typing.Mapping[str, typing.Any]], *,
                 timestamp: typing.Optional[float] = None,
                 ready: typing.Optional[torch.cuda.Event] = None, metrics=None):
        self.tensors = dict(tensors)
        self.valid = valid
        self.metas = list(metas)
        #: Timestamp shared by the batch's records.
        self.timestamp = timestamp
        self.ready = ready
        self._metrics = metrics
        self._host: typing.Optional[typing.List[TensorValue]] = None
        self._lock = threading.Lock()

    @property
    def num_records(self) -> int:
        return int(self.valid.sum())

    @property
    def padded_size(self) -> int:
        return int(self.valid.shape[0])

    @property
    def materialized(self) -> bool:
        return self._host is not None

    def wait_on(self, stream: typing.Optional[torch.cuda.Stream]) -> None:
        """Make ``stream`` (a consumer's) wait for the producer's work, and
        keep the tensors' blocks from reuse until ``stream``'s work that
        is queued when they are freed has run."""
        if stream is None:
            return
        if self.ready is not None:
            stream.wait_event(self.ready)
        for t in self.tensors.values():
            t.record_stream(stream)

    def materialize(self) -> typing.List[TensorValue]:
        """The host records, fetched on the first call only: the D2H waits
        for the producer's event, then copies every tensor to the host."""
        with self._lock:
            if self._host is None:
                if self.ready is not None:
                    self.ready.synchronize()
                host = {}
                for n, t in self.tensors.items():
                    a = t.detach().cpu().numpy()
                    a.setflags(write=False)
                    host[n] = a
                if self._metrics is not None:
                    self._metrics.counter("d2h_batches").inc()
                    self._metrics.counter("d2h_bytes").inc(sum(a.nbytes for a in host.values()))
                records = []
                for i in range(self.padded_size):
                    if self.valid[i]:
                        records.append(TensorValue({n: a[i] for n, a in host.items()},
                                                   self.metas[len(records)]))
                self._host = records
            return self._host

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}: {tuple(t.shape)}/{t.dtype}" for k, t in self.tensors.items())
        state = "materialized" if self._host is not None else "device"
        return f"DeviceBatch({inner}; n={self.num_records}, {state})"

    def __reduce__(self):
        raise TypeError(
            "DeviceBatch is device-resident and never crosses a pickle boundary: "
            "the runtime materializes it at channels and checkpoints; call "
            "materialize() for host records")


class DeviceTransfer:
    """Per-operator-subtask transfer helper bound to one device.

    ``slots`` is the number of pinned staging slots: a slot is busy from
    its batch's assembly until that batch's H2D copy has run, so a few
    more than the dispatch lanes keep assembly from waiting (the runner
    takes lanes + 2)."""

    def __init__(self, device: torch.device, slots: int = 2):
        self.device = device
        self.cuda = device.type == "cuda"
        self._stream = torch.cuda.Stream(device) if self.cuda else None
        self._slots = [StagingSlot() for _ in range(max(1, slots))] if self.cuda else []
        self._next = 0
        self._lock = threading.Lock()

    def _acquire(self) -> typing.Optional[StagingSlot]:
        """The next staging slot, locked; waits for the H2D copy that last
        read it.  None on the CPU."""
        if not self.cuda:
            return None
        with self._lock:
            slot = self._slots[self._next]
            self._next = (self._next + 1) % len(self._slots)
        slot.lock.acquire()
        if slot.copied is not None:
            slot.copied.synchronize()
        return slot

    @property
    def slots(self) -> int:
        """Pinned staging slots (0 on the CPU)."""
        return len(self._slots)

    @property
    def pinned_allocations(self) -> int:
        """Pinned staging buffers allocated so far (all slots)."""
        return sum(slot.allocations for slot in self._slots)

    def assemble_and_ship(self, records: typing.Sequence[TensorValue], schema: RecordSchema,
                          policy: BucketPolicy) -> Shipped:
        """Assemble ``records`` straight into a staging slot and ship it.
        The lengths (``[B]`` int32 per dynamic field) ride the same slot
        and copy stream as the fields, and count in ``h2d_bytes``."""
        slot = self._acquire()
        try:
            allocations = slot.allocations if slot else 0
            t0 = time.monotonic()
            batch = assemble(records, schema, policy, alloc=slot.alloc if slot else None)
            assemble_s = time.monotonic() - t0
            dev, lengths, nbytes = self._ship(batch, slot)
            allocations = (slot.allocations if slot else 0) - allocations
        finally:
            if slot is not None:
                slot.lock.release()
        return Shipped(batch, dev, lengths, nbytes, assemble_s, allocations)

    def _ship(self, batch: Batch, slot: typing.Optional[StagingSlot]):
        """The H2D of a batch assembled into ``slot``, on the side stream;
        the CALLER's current stream (the compute stream) waits for it.
        Returns ``(device tensors, device lengths, bytes)``."""
        nbytes = sum(a.nbytes for a in batch.arrays.values())
        nbytes += sum(a.nbytes for a in batch.lengths.values())
        if slot is None:
            return ({n: torch.from_numpy(a) for n, a in batch.arrays.items()},
                    {n: torch.from_numpy(a) for n, a in batch.lengths.items()}, nbytes)
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._stream):
            dev = {n: slot.tensors[n].to(self.device, non_blocking=True) for n in batch.arrays}
            lengths = {n: slot.tensors[length_key(n)].to(self.device, non_blocking=True)
                       for n in batch.lengths}
            copied = torch.cuda.Event()
            copied.record(self._stream)
        slot.copied = copied
        compute.wait_event(copied)
        for t in (*dev.values(), *lengths.values()):
            t.record_stream(compute)
        return dev, lengths, nbytes

    def start_fetch(self, outputs: typing.Mapping[str, torch.Tensor]) -> FetchHandle:
        """Enqueue the D2H of ``outputs`` on the caller's current stream,
        into pinned host buffers, and record the batch's event."""
        if not self.cuda:
            return FetchHandle({n: t.detach() for n, t in outputs.items()}, None)
        host = {}
        for n, t in outputs.items():
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            host[n] = h
        # A blocking-sync event: the fetch thread sleeps in the wait
        # instead of spinning a core the dispatch lanes need.
        done = torch.cuda.Event(blocking=True)
        done.record(torch.cuda.current_stream(self.device))
        return FetchHandle(host, done)

    def keep_on_device(self, outputs: typing.Mapping[str, torch.Tensor]) -> FetchHandle:
        """No D2H: record the event after the work queued on the caller's
        current stream (the computation of ``outputs``)."""
        done = None
        if self.cuda:
            done = torch.cuda.Event(blocking=True)
            done.record(torch.cuda.current_stream(self.device))
        return FetchHandle(dict(outputs), done, on_device=True)

    @staticmethod
    def finish_fetch(handle: FetchHandle) -> typing.Dict[str, np.ndarray]:
        """Wait for this batch's D2H only, and return read-only numpy views
        (``Batch.unbatch`` row views are then shared, not copied)."""
        if handle.done is not None:
            handle.done.synchronize()
        out = {}
        for n, t in handle.host.items():
            a = t.numpy()
            a.setflags(write=False)
            out[n] = a
        return out
