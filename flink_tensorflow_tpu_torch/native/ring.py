"""TensorRing — a schema-typed record ring with zero-copy batch views.

Port of ``flink_tensorflow_tpu/native/ring.py`` (``_soa_layout`` ``:80``,
``_PyRing`` ``:99``, ``_NativeRing`` ``:139``, ``TensorRing``
``:401-512``).  One producer puts each record into a slot at arrival;
the consumer claims N contiguous slots and gets the batch as ``[N, ...]``
numpy views onto the arena, with no stacking copy.

The arena is laid out **SoA**: each field owns a contiguous ``[capacity,
*shape]`` region (region starts 64-byte aligned), so a claimed batch is a
plain C-contiguous slice of each region, and the offsets equal the JAX
package's.  The arena is the port's own tensor: page-locked with
``pinned=True`` (the card route), so a claimed slice copies to the card
in place with ``non_blocking=True``; plain host memory otherwise.

The native ring is ``csrc/spsc_ring.cpp`` (built with the host compiler
at first use, ``ops/_build.py``).  Unlike the reference's, its producer
only submits a record's row pointers: a copier thread the ring owns
copies the rows into the arena, off the interpreter lock, so ingestion
on a subtask thread never holds up the dispatch lanes with copies (the
reference writes each field from Python).  The ring keeps each submitted
record's arrays alive until they are copied, and a claim waits for its
slots' copies before the views are read (:meth:`TensorRing.claim_batch`,
or :meth:`TensorRing.wait_copied` where the reader is another thread).
Its calls keep the interpreter lock (``ctypes.PyDLL``: each is a few
atomics), except the wait, which gives it up.  ``native=False`` asks for
the Python ring, the plain version: the reference's field-by-field
writes under a mutex.  A native ring that fails to build or load raises:
unlike the reference (``:20-22``, ``:412-415``) nothing falls back to
the Python ring silently.

Claims may overlap (several claimed batches in flight); releases free the
oldest claimed slots first, and both run on the one consumer thread.  A
slot's bytes may be overwritten only after the batch that claimed it has
been released, and its owner releases only once the batch's H2D is done.

:class:`ShmByteRing` (JAX ``:180-400``, kept byte for byte so a ring of
either package attaches to the other's file) is the cross-process
sibling: opaque frames over a shared ``mmap`` in :func:`shm_dir`, the
same-host transport of the record plane (``core/shuffle.py``).
"""

from __future__ import annotations

import collections
import ctypes
import mmap
import os
import struct
import tempfile
import threading
import typing

import numpy as np
import torch

from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema

RING_SOURCE = "spsc_ring.cpp"


def _load_lib(hold_gil: bool) -> ctypes.CDLL:
    """The built C++ ring (building it now if needed); raises on failure.
    ``hold_gil``: its calls keep the interpreter lock."""
    from flink_tensorflow_tpu_torch.ops._build import load_library

    lib = load_library(RING_SOURCE, hold_gil=hold_gil)
    u64, ptr = ctypes.c_uint64, ctypes.c_void_p
    lib.ring_create.restype = ptr
    lib.ring_create.argtypes = [u64, ptr, u64, ptr, ptr]
    lib.ring_destroy.argtypes = [ptr]
    lib.ring_capacity.restype = u64
    lib.ring_capacity.argtypes = [ptr]
    lib.ring_submit.restype = ctypes.c_int64
    lib.ring_submit.argtypes = [ptr, ptr]
    for name in ("ring_copied", "ring_poppable"):
        getattr(lib, name).restype = u64
        getattr(lib, name).argtypes = [ptr]
    lib.ring_wait_copied.argtypes = [ptr, u64]
    lib.ring_pop_release.argtypes = [ptr, u64]
    return lib


def _soa_layout(schema: RecordSchema, length_bucket: int, capacity: int):
    """Per field ``(region offset, shape, dtype, row bytes)``, each region
    ``capacity`` tightly packed rows starting 64-byte aligned; returns
    ``(layout, total arena bytes)``."""
    layout = {}
    offset = 0
    shapes = schema.resolve_dynamic(length_bucket)
    for name in schema.names:
        shape = shapes[name]
        dtype = np.dtype(schema[name].dtype)
        row = int(np.prod(shape)) * dtype.itemsize if shape else dtype.itemsize
        layout[name] = (offset, shape, dtype, row)
        offset += (capacity * row + 63) & ~63
    return layout, offset


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class _PyRing:
    """The plain version: the SPSC counters under a mutex; the producer
    writes the rows itself (:meth:`TensorRing._write_fields`)."""

    def __init__(self, n_slots: int):
        self.n_slots = _pow2(n_slots)
        self.head = 0
        self.tail = 0
        self._lock = threading.Lock()

    def push_reserve(self) -> int:
        with self._lock:
            if self.tail - self.head >= self.n_slots:
                return -1
            return self.tail & (self.n_slots - 1)

    def push_commit(self) -> None:
        with self._lock:
            self.tail += 1

    def poppable(self) -> int:
        with self._lock:
            return self.tail - self.head

    def pop_release(self, count: int) -> None:
        with self._lock:
            self.head += count

    def destroy(self) -> None:
        pass


class _NativeRing:
    """The C++ ring over the caller's arena, and its copier thread."""

    def __init__(self, n_slots: int, arena_ptr: int, layout):
        self._lib = _load_lib(hold_gil=True)
        self._waiting = _load_lib(hold_gil=False)   # ring_wait_copied gives the lock up
        n = len(layout)
        offsets = (ctypes.c_uint64 * n)(*(v[0] for v in layout.values()))
        rows = (ctypes.c_uint64 * n)(*(v[3] for v in layout.values()))
        self._ptr = self._lib.ring_create(n_slots, arena_ptr, n, offsets, rows)
        if not self._ptr:
            raise MemoryError("ring_create failed")
        self.n_slots = self._lib.ring_capacity(self._ptr)
        self._src = ctypes.c_void_p * n

    def submit(self, rows: typing.Sequence[int]) -> int:
        return self._lib.ring_submit(self._ptr, self._src(*rows))

    def copied(self) -> int:
        return self._lib.ring_copied(self._ptr)

    def wait_copied(self, upto: int) -> None:
        # Checked first under the lock: giving it up costs a lane a wait
        # behind the others to take it back, even when nothing is pending.
        if self._lib.ring_copied(self._ptr) < upto:
            self._waiting.ring_wait_copied(self._ptr, upto)

    def poppable(self) -> int:
        return self._lib.ring_poppable(self._ptr)

    def pop_release(self, count: int) -> None:
        self._lib.ring_pop_release(self._ptr, count)

    def destroy(self) -> None:
        if self._ptr:
            self._lib.ring_destroy(self._ptr)
            self._ptr = None


class TensorRing:
    """Schema-typed SPSC record ring with zero-copy batch views.

    ``capacity`` rounds up to a power of two.  ``pinned`` page-locks the
    arena (needs CUDA); ``pinned_bytes`` reports it.  ``native=False``
    takes the Python ring."""

    def __init__(self, schema: RecordSchema, capacity: int = 256, *,
                 length_bucket: int = 128, native: bool = True, pinned: bool = False):
        self.schema = schema
        self.is_native = bool(native)
        pow2 = _pow2(capacity)
        self.layout, total_bytes = _soa_layout(schema, length_bucket, pow2)
        # Sized as the reference sizes it: whole slots of 64-byte multiples.
        slot_size = ((total_bytes + pow2 - 1) // pow2 + 63) & ~63
        self.arena: typing.Optional[torch.Tensor] = torch.empty(
            (slot_size * pow2,), dtype=torch.uint8, pin_memory=pinned)
        self.pinned_bytes = self.arena.numel() if pinned else 0
        arena = self.arena.numpy()
        #: Per field, the ``[capacity, *shape]`` view of its region.
        self._regions = {
            name: arena[offset:offset + pow2 * row].view(dtype).reshape((pow2, *shape))
            for name, (offset, shape, dtype, row) in self.layout.items()}
        self._ring = (_NativeRing(pow2, self.arena.data_ptr(), self.layout)
                      if self.is_native else _PyRing(pow2))
        self.capacity = int(self._ring.n_slots)
        assert self.capacity == pow2, (self.capacity, pow2)
        #: Slots claimed and not yet released, the next slot to claim, and
        #: the records claimed so far: the counters' head moves only on
        #: release, so overlapping claims are sequenced here (consumer
        #: thread only).
        self._claim_ahead = 0
        self._claim_idx = 0
        self._claimed = 0
        #: Submitted records' arrays, ``(index, arrays)``, until copied.
        self._sources: typing.Deque[typing.Tuple[int, list]] = collections.deque()
        self._submitted = 0
        self.closed = False

    # -- producer ----------------------------------------------------------
    def try_push(self, record: typing.Mapping[str, np.ndarray]) -> bool:
        """Put one record into the ring; False when it is full.  Raises
        ValueError, before taking a slot, when a dynamic field exceeds its
        resolved bucket."""
        for name, (_, shape, _, _) in self.layout.items():
            src_shape = np.shape(record[name])
            if src_shape != tuple(shape) and any(s > d for s, d in zip(src_shape, shape)):
                raise ValueError(f"field {name!r} shape {src_shape} exceeds the ring's "
                                 f"slot shape {tuple(shape)} (length_bucket too small)")
        if not self.is_native:
            return self._write_fields(record)
        arrays = []
        for name, (_, shape, dtype, _) in self.layout.items():
            a = record[name]
            if not (type(a) is np.ndarray and a.shape == tuple(shape) and a.dtype == dtype
                    and a.flags.c_contiguous):
                row = np.zeros(shape, dtype)   # a dynamic field: the prefix, zero-padded
                row[tuple(slice(0, s) for s in np.shape(a))] = a
                a = row
            arrays.append(a)
        if self._ring.submit([a.ctypes.data for a in arrays]) < 0:
            return False
        self._sources.append((self._submitted, arrays))
        self._submitted += 1
        copied = self._ring.copied()
        while self._sources and self._sources[0][0] < copied:
            self._sources.popleft()
        return True

    def _write_fields(self, record) -> bool:
        """The plain version's push: reserve, write each field, commit."""
        slot = self._ring.push_reserve()
        if slot < 0:
            return False
        for name, (_, shape, _, _) in self.layout.items():
            dst = self._regions[name][slot:slot + 1].reshape(shape)
            src = np.asarray(record[name])
            if src.shape != tuple(shape):  # a dynamic field: the prefix, zero-padded
                dst.fill(0)
                dst[tuple(slice(0, s) for s in src.shape)] = src
            else:
                dst[...] = src
        self._ring.push_commit()
        return True

    # -- consumer ----------------------------------------------------------
    def poppable(self) -> int:
        return self._ring.poppable()

    def claim_batch(self, max_n: int, *, wait: bool = True
                    ) -> typing.Tuple[typing.Dict[str, np.ndarray], int]:
        """Claim up to ``max_n`` contiguous records: ``({field: C-contiguous
        [n, ...] view}, n)``; fewer at the arena's end.  :meth:`release`
        frees them.  ``wait=False`` returns before their copies are done:
        the reader calls ``wait_copied(ring.claimed)``, as it stands after
        this claim, before it reads them."""
        ready = self._ring.poppable() - self._claim_ahead
        if ready <= 0:
            return {}, 0
        start = self._claim_idx
        n = min(max_n, ready, self.capacity - start)
        self._claim_ahead += n
        self._claim_idx = (start + n) % self.capacity
        self._claimed += n
        if wait:
            self.wait_copied(self._claimed)
        return {name: region[start:start + n] for name, region in self._regions.items()}, n

    @property
    def claimed(self) -> int:
        """Records claimed so far (a count over the ring's life)."""
        return self._claimed

    def wait_copied(self, upto: int) -> None:
        """Wait until the first ``upto`` records' rows are in the arena
        (the plain version writes them at the push)."""
        if self.is_native:
            self._ring.wait_copied(upto)

    def release(self, count: int) -> None:
        """Free the oldest ``count`` claimed slots (read, and copied)."""
        self._ring.pop_release(count)
        self._claim_ahead -= count

    def close(self) -> None:
        """Stop the copier (after it copies what was submitted), free the
        counters and drop the arena.  The caller makes sure no copy to the
        card still reads it (``ModelWindowFunction.close``)."""
        if self.closed:
            return
        self.closed = True
        self._ring.destroy()
        self._sources.clear()
        self._regions = {}
        self.arena = None

    def __del__(self):
        # A ring dropped without close(): its copier must finish before the
        # arena and the submitted arrays go.
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


def shm_dir() -> str:
    """Where shared ring files live: tmpfs (``/dev/shm``) when the
    platform has it — a page-cache-backed temp dir otherwise (still
    mmap-shareable, just not guaranteed RAM-only)."""
    return "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()


class ShmByteRing:
    """Cross-process SPSC byte-frame ring — TensorRing's sibling for the
    same-host record plane.

    Where :class:`TensorRing` is schema-typed and intra-process (its
    arena is private memory), this ring carries OPAQUE variable-length
    frames over a shared ``mmap`` so two processes on one host exchange
    record-plane frames without touching the kernel TCP stack: the
    producer writes ``[u32 len][payload]`` frames at ``tail``, the
    consumer drains at ``head``, and both cursors live in the mapping
    itself (one writer each — the SPSC contract the TensorRing layouts
    already rely on; cursors sit on separate cache lines).  Publication
    order is payload-then-cursor, so a reader never observes a frame
    before its bytes.

    The file lives in :func:`shm_dir` (tmpfs on Linux).  The CREATING
    side owns the name; the attaching side maps it read-write.  Either
    side may :meth:`close`; ``unlink=True`` removes the file (guarded —
    first unlinker wins, crashes leave at most one small file behind).
    """

    _CURSOR = struct.Struct("<Q")
    _FRAME = struct.Struct("<I")
    _HEAD_OFF, _TAIL_OFF, _CAP_OFF, _DATA_OFF = 0, 64, 128, 192
    #: Consumer-parked doorbell flag (shares the read-mostly capacity
    #: cache line; written by the consumer, cleared by the producer).
    _PARK_OFF = 136
    #: Cumulative credit grants (record-plane flow control): the
    #: CONSUMER is the only writer — it adds the initial window at
    #: attach and one credit per frame its gate drained; the producer
    #: compares against its own spent-frames count before each write.
    #: Cumulative u64 counters keep the cell SPSC-safe exactly like the
    #: head/tail cursors (no read-modify-write races across processes).
    _CREDIT_OFF = 144

    def __init__(self, path: str, mm: mmap.mmap, capacity: int, *,
                 created: bool):
        self.path = path
        self._mm = mm
        self.capacity = capacity
        self._created = created
        self._view = memoryview(mm)
        self._closed = False

    # -- construction ----------------------------------------------------
    @classmethod
    def create(cls, path: str, capacity: int = 1 << 20) -> "ShmByteRing":
        pow2 = 1
        while pow2 < capacity:
            pow2 *= 2
        size = cls._DATA_OFF + pow2
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
        try:
            os.ftruncate(fd, size)
            mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        ring = cls(path, mm, pow2, created=True)
        ring._store(cls._HEAD_OFF, 0)
        ring._store(cls._TAIL_OFF, 0)
        ring._store(cls._CAP_OFF, pow2)
        ring._store(cls._PARK_OFF, 0)
        ring._store(cls._CREDIT_OFF, 0)
        return ring

    @classmethod
    def attach(cls, path: str) -> "ShmByteRing":
        fd = os.open(path, os.O_RDWR)
        try:
            size = os.fstat(fd).st_size
            mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        (capacity,) = cls._CURSOR.unpack_from(mm, cls._CAP_OFF)
        if cls._DATA_OFF + capacity != size:
            raise ValueError(f"shm ring {path!r} header/size mismatch")
        return cls(path, mm, capacity, created=False)

    # -- cursors ---------------------------------------------------------
    def _load(self, off: int) -> int:
        return self._CURSOR.unpack_from(self._mm, off)[0]

    def _store(self, off: int, value: int) -> None:
        self._CURSOR.pack_into(self._mm, off, value)

    # -- producer --------------------------------------------------------
    def free_bytes(self) -> int:
        return self.capacity - (self._load(self._TAIL_OFF)
                                - self._load(self._HEAD_OFF))

    def try_write(self, payload: typing.Union[bytes, bytearray, memoryview]
                  ) -> bool:
        """Write one frame; False when the ring lacks space (the caller
        backs off — ring-full IS the backpressure signal)."""
        need = self._FRAME.size + len(payload)
        if need > self.capacity:
            raise ValueError(
                f"frame of {len(payload)} bytes exceeds the shm ring "
                f"capacity {self.capacity} — raise the ring size or "
                "lower wire_flush_bytes"
            )
        tail = self._load(self._TAIL_OFF)
        if need > self.capacity - (tail - self._load(self._HEAD_OFF)):
            return False
        self._put_bytes(tail, self._FRAME.pack(len(payload)))
        self._put_bytes(tail + self._FRAME.size, payload)
        # Publish AFTER the payload is in the mapping.
        self._store(self._TAIL_OFF, tail + need)
        return True

    def try_write_parts(self, parts: typing.Sequence[typing.Any],
                        total: int) -> bool:
        """Scatter-gather :meth:`try_write`: writes ``parts`` (whose
        lengths sum to ``total``) as ONE frame without concatenating
        them first — the zero-copy send path for multi-part wire frames."""
        need = self._FRAME.size + total
        if need > self.capacity:
            raise ValueError(
                f"frame of {total} bytes exceeds the shm ring "
                f"capacity {self.capacity} — raise the ring size or "
                "lower wire_flush_bytes"
            )
        tail = self._load(self._TAIL_OFF)
        if need > self.capacity - (tail - self._load(self._HEAD_OFF)):
            return False
        self._put_bytes(tail, self._FRAME.pack(total))
        pos = tail + self._FRAME.size
        for p in parts:
            self._put_bytes(pos, p)
            pos += len(p) if not isinstance(p, memoryview) else p.nbytes
        self._store(self._TAIL_OFF, tail + need)
        return True

    def _put_bytes(self, pos: int, data) -> None:
        cap = self.capacity
        off = pos & (cap - 1)
        data = memoryview(data).cast("B") if not isinstance(data, bytes) else data
        n = len(data)
        first = min(n, cap - off)
        base = self._DATA_OFF
        self._view[base + off:base + off + first] = data[:first]
        if first < n:  # wrap
            self._view[base:base + n - first] = data[first:]

    # -- doorbell --------------------------------------------------------
    # The consumer parks before sleeping; the producer sends its (socket)
    # notify ONLY when it observes the parked flag, clearing it first so
    # back-to-back frames ring the doorbell once.  mmap stores carry no
    # memory fence, so a publish racing a park can — very rarely — leave
    # the consumer asleep with data in the ring; the consumer side MUST
    # therefore keep a bounded re-poll while parked (the reactor's ring
    # poller).  Suppression is a throughput optimisation, never the sole
    # wakeup path.

    def consumer_parked(self) -> bool:
        return self._load(self._PARK_OFF) != 0

    def set_consumer_parked(self, parked: bool) -> None:
        self._store(self._PARK_OFF, 1 if parked else 0)

    # -- flow control ----------------------------------------------------
    def credits_granted(self) -> int:
        """Cumulative credits the consumer has granted over the ring's
        lifetime (producer side compares with its own spent total)."""
        return self._load(self._CREDIT_OFF)

    def add_credits(self, n: int) -> None:
        """Grant ``n`` more frame credits (CONSUMER only — single
        writer, like the head cursor)."""
        self._store(self._CREDIT_OFF, self._load(self._CREDIT_OFF) + n)

    # -- consumer --------------------------------------------------------
    def readable(self) -> bool:
        return self._load(self._TAIL_OFF) != self._load(self._HEAD_OFF)

    def read(self) -> typing.Optional[bytearray]:
        """Pop one frame as a WRITABLE standalone buffer; None if empty."""
        head = self._load(self._HEAD_OFF)
        if self._load(self._TAIL_OFF) == head:
            return None
        (length,) = self._FRAME.unpack(
            bytes(self._get_bytes(head, self._FRAME.size)))
        payload = self._get_bytes(head + self._FRAME.size, length)
        self._store(self._HEAD_OFF, head + self._FRAME.size + length)
        return payload

    def _get_bytes(self, pos: int, n: int) -> bytearray:
        cap = self.capacity
        off = pos & (cap - 1)
        out = bytearray(n)
        first = min(n, cap - off)
        base = self._DATA_OFF
        out[:first] = self._view[base + off:base + off + first]
        if first < n:  # wrap
            out[first:] = self._view[base:base + n - first]
        return out

    # -- lifecycle -------------------------------------------------------
    def close(self, unlink: bool = False) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._view.release()
            self._mm.close()
        except (BufferError, ValueError, OSError):
            pass
        if unlink:
            try:
                os.unlink(self.path)
            except OSError:
                pass
