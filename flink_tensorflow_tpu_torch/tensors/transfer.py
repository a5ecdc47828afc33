"""Host <-> device transfer of assembled batches.

Port of ``flink_tensorflow_tpu/tensors/transfer.py`` (``:46-135``,
``DeviceTransfer`` ``:83``).  The reference ships a batch with one
``jax.device_put`` and fetches with one ``jax.device_get``; on a CUDA card
the same contract is kept with explicit streams and events:

- one **pinned staging slot per in-flight batch**: ``assemble`` writes the
  records (and the ``[B]`` lengths of dynamic fields) straight into the
  slot's page-locked buffers (``alloc``), so the stacking copy is the only
  host copy; a slot's buffers grow to the largest batch and are reused
  as views, so length buckets allocate nothing in the steady state;
- a batch assembled elsewhere (``ship_batch``: the ring's claimed views,
  page-locked already) is copied to the card from where it lies, with no
  staging copy;
- one ``non_blocking`` H2D per field, on the transfer's own **side
  stream**, followed by an event; the compute stream waits on that event
  (the host never blocks on the copy), and the device tensors are marked
  with ``record_stream`` so the caching allocator cannot hand their
  memory out again before the compute stream is done with them;
- a slot is reused only after its previous H2D has finished (its event is
  synchronized first), so a pinned buffer is never overwritten under a
  copy that still reads it; the event is returned (``Shipped.copied``)
  for the owner of a pre-assembled batch's memory to wait on likewise;
- the D2H moves only the outputs the job selected, into pinned host
  buffers, on the compute stream, followed by a per-batch event that the
  fetch thread waits on; it never synchronizes the whole device.

**Wire narrowing** (``wire_dtype``): each float field wider than the wire
dtype is narrowed host-side straight into the slot's pinned buffer
(``bf16``/``f16``: a cast, rounding to nearest even; ``int8``: absmax /
127, ``rint``, clip to ±127, and the scale as an f32 scalar under
:func:`scale_key`), so the H2D moves the narrow bytes; the model runner
widens back to the declared dtype as the first step of its call.
``h2d_bytes`` counts what crossed, ``wire_saved`` the gain.

On the CPU (a provider that returns ``cpu``) the same calls run the
plain path: the assembled arrays become the tensors, a pre-assembled
batch is copied (its memory is the caller's to reuse), and the fetch is a
conversion.

:class:`DeviceBatch` (JAX ``:192-300``) is a batch of outputs left on the
device for the next fused operator (``JobConfig.device_resident``, or
``FLINK_TPU_DEVICE_RESIDENT=1``): its consumer waits on the producer's
event and marks the tensors as used on its own stream before it launches,
and the first host-only consumer materializes it, once.
"""

from __future__ import annotations

import os
import threading
import time
import typing

import numpy as np
import torch

from flink_tensorflow_tpu_torch.tensors.batching import Batch, BucketPolicy, assemble, length_key
from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema
from flink_tensorflow_tpu_torch.tensors.serde import normalize_wire_dtype, to_bf16, wire_itemsize
from flink_tensorflow_tpu_torch.tensors.value import TensorValue

_TRUTHY = ("1", "true", "on", "yes")


def env_device_resident() -> bool:
    """Whether ``FLINK_TPU_DEVICE_RESIDENT`` turns device-resident
    handoff on for the whole job."""
    return os.environ.get("FLINK_TPU_DEVICE_RESIDENT", "").lower() in _TRUTHY


def env_wire_dtype() -> typing.Optional[str]:
    """The job-wide wire dtype of ``FLINK_TPU_WIRE_DTYPE`` (f32: none)."""
    return normalize_wire_dtype(os.environ.get("FLINK_TPU_WIRE_DTYPE") or None)


_SCALE_PREFIX = "__scale__"


def scale_key(name: str) -> str:
    """The input that carries an int8-narrowed field's scale into the call."""
    return _SCALE_PREFIX + name


def is_scale_key(name: str) -> bool:
    return name.startswith(_SCALE_PREFIX)


_WIRE_TORCH = {"bf16": torch.bfloat16, "f16": torch.float16, "int8": torch.int8}


def torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty((0,), dtype=dtype)).dtype


def narrows(dtype: np.dtype, wire: typing.Optional[str]) -> bool:
    """Whether a field of ``dtype`` ships narrowed on ``wire``: floats
    wider than the wire dtype (JAX ``_narrow_arrays``)."""
    return wire is not None and dtype.kind == "f" and dtype.itemsize > wire_itemsize(wire)


def narrow_field(a: np.ndarray, wire: str, out: typing.Optional[torch.Tensor] = None):
    """``a`` narrowed to ``wire`` into ``out`` (a CPU tensor of the wire
    dtype and ``a``'s shape; a new one when None).  Returns ``(tensor,
    scale)``, the scale an ``np.float32`` for int8 and None otherwise.
    Bytes equal the JAX package's ``DeviceTransfer._narrow_arrays``: bf16
    as ``ml_dtypes`` rounds (to nearest even, through f32, a NaN to the
    quiet NaN of its sign), f16 and int8 by the same numpy operations."""
    if out is None:
        out = torch.empty(a.shape, dtype=_WIRE_TORCH[wire])
    if wire == "int8":
        absmax = float(np.max(np.abs(a))) if a.size else 0.0
        scale = absmax / 127.0 if absmax > 0.0 else 1.0
        q = np.clip(np.rint(a.astype(np.float32) / scale), -127, 127)
        np.copyto(out.numpy(), q, casting="unsafe")
        return out, np.float32(scale)
    if wire == "f16":
        np.copyto(out.numpy(), a, casting="unsafe")
        return out, None
    return to_bf16(a, out), None


class StagingSlot:
    """Pinned host buffers for one in-flight batch, the event of the H2D
    copy that last read them, and the lock its user holds from assembly
    until that copy is enqueued.

    Each field keeps one flat pinned buffer, grown to the largest batch
    seen, and a batch takes a view of its front: length buckets change a
    batch's shape on most windows, and a pinned allocation per new shape
    would stay in the steady state.  ``allocations`` counts the pinned
    allocations made.  A field that narrows is assembled into a plain
    host buffer first (``host``) and narrowed into its pinned one."""

    __slots__ = ("buffers", "tensors", "host", "copied", "lock", "allocations")

    def __init__(self) -> None:
        self.buffers: typing.Dict[str, torch.Tensor] = {}
        #: The current batch's views of ``buffers``, by field.
        self.tensors: typing.Dict[str, torch.Tensor] = {}
        self.host: typing.Dict[str, np.ndarray] = {}
        self.copied: typing.Optional[torch.cuda.Event] = None
        self.lock = threading.Lock()
        self.allocations = 0

    def alloc_tensor(self, name: str, shape, tdt: torch.dtype) -> torch.Tensor:
        """A view, of this shape and dtype, of the field's pinned buffer
        (grown when it is too small)."""
        shape = tuple(shape)
        numel = int(np.prod(shape))
        buf = self.buffers.get(name)
        if buf is None or buf.dtype != tdt or buf.numel() < numel:
            buf = torch.empty((max(numel, 1),), dtype=tdt, pin_memory=True)
            self.buffers[name] = buf
            self.allocations += 1
        view = buf[:numel].view(shape)
        self.tensors[name] = view
        return view

    def alloc(self, name: str, shape, dtype) -> np.ndarray:
        """``assemble``'s allocator: a numpy view of the pinned buffer."""
        return self.alloc_tensor(name, shape, torch_dtype(dtype)).numpy()

    def alloc_host(self, name: str, shape, dtype) -> np.ndarray:
        """``assemble``'s allocator for a field that narrows: a view of a
        plain host buffer, grown like the pinned ones."""
        shape = tuple(shape)
        numel = int(np.prod(shape))
        buf = self.host.get(name)
        if buf is None or buf.dtype != np.dtype(dtype) or buf.size < numel:
            buf = np.empty((numel,), dtype)
            self.host[name] = buf
        return buf[:numel].reshape(shape)


class Shipped(typing.NamedTuple):
    """One batch on its way to the device."""

    batch: Batch
    inputs: typing.Dict[str, torch.Tensor]
    #: ``[B]`` int32 true lengths per dynamic field, on the device.
    lengths: typing.Dict[str, torch.Tensor]
    #: Bytes that crossed (narrowed, scales included).
    h2d_bytes: int
    #: Bytes the narrowing saved.
    wire_saved: int
    assemble_s: float
    #: Pinned staging buffers this batch had to allocate (grow).
    pinned_allocations: int
    #: The event after the batch's H2D (None on the CPU).
    copied: typing.Optional[torch.cuda.Event]


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
    takes lanes + 2).  ``wire_dtype`` narrows float fields host-side."""

    def __init__(self, device: torch.device, slots: int = 2,
                 wire_dtype: typing.Optional[str] = None):
        self.device = device
        self.cuda = device.type == "cuda"
        self.wire_dtype = normalize_wire_dtype(wire_dtype)
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

    def _narrow_arrays(self, arrays: typing.Mapping[str, np.ndarray]
                       ) -> typing.Tuple[typing.Dict[str, np.ndarray], int]:
        """The JAX package's ``_narrow_arrays`` (``:102``): ``(arrays,
        bytes saved)`` with every narrowing field in the wire dtype (bf16
        as its uint16 bits) and each int8 field's scale under
        :func:`scale_key`.  The bytes equal the JAX package's."""
        out: typing.Dict[str, np.ndarray] = {}
        saved = 0
        for n, a in arrays.items():
            if not narrows(a.dtype, self.wire_dtype):
                out[n] = a
                continue
            saved += a.size * (a.dtype.itemsize - wire_itemsize(self.wire_dtype))
            t, scale = narrow_field(a, self.wire_dtype)
            out[n] = (t.view(torch.int16).numpy().view(np.uint16)
                      if t.dtype == torch.bfloat16 else t.numpy())
            if scale is not None:
                out[scale_key(n)] = scale
        return out, saved

    def assemble_and_ship(self, records: typing.Sequence[TensorValue], schema: RecordSchema,
                          policy: BucketPolicy) -> Shipped:
        """Assemble ``records`` straight into a staging slot and ship it.
        The lengths (``[B]`` int32 per dynamic field) ride the same slot
        and copy stream as the fields, and count in ``h2d_bytes``."""
        slot = self._acquire()
        try:
            allocations = slot.allocations if slot else 0
            t0 = time.monotonic()
            alloc = None
            if slot is not None:
                wire = self.wire_dtype
                alloc = (slot.alloc if wire is None else
                         lambda name, shape, dtype: (slot.alloc_host if narrows(np.dtype(dtype), wire)
                                                     else slot.alloc)(name, shape, dtype))
            batch = assemble(records, schema, policy, alloc=alloc)
            assemble_s = time.monotonic() - t0
            shipped = self._ship(batch, slot, assembled=True)
            allocations = (slot.allocations if slot else 0) - allocations
        finally:
            if slot is not None:
                slot.lock.release()
        return shipped._replace(assemble_s=assemble_s, pinned_allocations=allocations)

    def ship_batch(self, batch: Batch) -> Shipped:
        """Ship a batch assembled elsewhere (the ring's views, page-locked
        on the card route) from where it lies; only fields that narrow go
        through a staging slot.  The caller reuses the batch's memory only
        after ``Shipped.copied`` has completed."""
        narrowing = any(narrows(a.dtype, self.wire_dtype) for a in batch.arrays.values())
        slot = self._acquire() if narrowing else None
        try:
            allocations = slot.allocations if slot else 0
            shipped = self._ship(batch, slot, assembled=False)
            allocations = (slot.allocations if slot else 0) - allocations
        finally:
            if slot is not None:
                slot.lock.release()
        return shipped._replace(pinned_allocations=allocations)

    def _host_tensors(self, batch: Batch, slot: typing.Optional[StagingSlot], assembled: bool):
        """The host tensors to copy, by input name: narrowed into the slot
        (or new tensors on the CPU), the slot's views of what was
        assembled there, else the batch's own arrays (copied on the CPU,
        so a result never aliases the caller's memory)."""
        wire = self.wire_dtype
        host: typing.Dict[str, torch.Tensor] = {}
        saved = 0
        for n, a in batch.arrays.items():
            if narrows(a.dtype, wire):
                out = (slot.alloc_tensor(n, a.shape, _WIRE_TORCH[wire])
                       if slot is not None else None)
                host[n], scale = narrow_field(a, wire, out)
                saved += a.size * (a.dtype.itemsize - wire_itemsize(wire))
                if scale is not None:
                    key = scale_key(n)
                    s = (slot.alloc_tensor(key, (), torch.float32) if slot is not None
                         else torch.empty((), dtype=torch.float32))
                    s.fill_(float(scale))
                    host[key] = s
            elif assembled and slot is not None:
                host[n] = slot.tensors[n]
            else:
                t = torch.from_numpy(a)
                host[n] = t if (assembled or self.cuda) else t.clone()
        lengths = {n: (slot.tensors[length_key(n)] if assembled and slot is not None
                       else torch.from_numpy(a)) for n, a in batch.lengths.items()}
        return host, lengths, saved

    def _ship(self, batch: Batch, slot: typing.Optional[StagingSlot], *, assembled: bool):
        """The H2D of a batch on the side stream; the CALLER's current
        stream (the compute stream) waits for it."""
        host, host_lengths, saved = self._host_tensors(batch, slot, assembled)
        nbytes = sum(t.numel() * t.element_size() for t in host.values())
        nbytes += sum(t.numel() * t.element_size() for t in host_lengths.values())
        if not self.cuda:
            return Shipped(batch, host, host_lengths, nbytes, saved, 0.0, 0, None)
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._stream):
            dev = {n: t.to(self.device, non_blocking=True) for n, t in host.items()}
            lengths = {n: t.to(self.device, non_blocking=True) for n, t in host_lengths.items()}
            copied = torch.cuda.Event()
            copied.record(self._stream)
        if slot is not None:
            slot.copied = copied
        compute.wait_event(copied)
        for t in (*dev.values(), *lengths.values()):
            t.record_stream(compute)
        return Shipped(batch, dev, lengths, nbytes, saved, 0.0, 0, copied)

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
