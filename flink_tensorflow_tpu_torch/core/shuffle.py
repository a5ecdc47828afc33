"""Cross-process record plane — the Netty-shuffle equivalent.

Port of ``flink_tensorflow_tpu/core/shuffle.py``.  Flink's keyed edges
span TaskManagers through its credit-based network shuffle, and
checkpoint barriers flow through the same channels, so alignment and
exactly-once hold cluster-wide.  This module is that plane for the
port's host-side record traffic:

- **Frame coalescing** — :class:`RemoteChannelWriter` buffers records
  and flushes one multi-record frame at ``flush_bytes`` of estimated
  payload or ``flush_ms`` after the first buffered record (the shared
  :class:`~flink_tensorflow_tpu_torch.core.reactor.FlushScheduler`).
  Barriers, watermarks and end-of-partition flush what is buffered ahead
  of them and ship at once, so stream order and alignment are those of a
  frame-per-record wire.
- **Columnar fast path** — a flushed run of homogeneous ``TensorValue``\\ s
  encodes as one ``tensors/serde.encode_batch`` frame (narrowed to the
  job's wire dtype when one is set); any other run pickles as one list.
- **One event loop** — :class:`ShuffleServer` runs every connection on a
  :class:`~flink_tensorflow_tpu_torch.core.reactor.Reactor` thread.  A full
  ``InputGate`` pauses that connection's reads (the kernel's TCP window
  closes and the sender blocks) until the gate's space listener resumes
  it.
- **Credit flow control** — with ``flow_control`` the receiver grants a
  window of frame credits in the handshake (:func:`credit_window` of the
  gate's capacity) and one more per data frame once the gate drains below
  its low-water mark; the sender parks at zero.  Lone control elements
  spend no credit, and data flushed ahead of a barrier or end-of-partition
  may overdraw by ``CREDIT_OVERFLOW_FRAMES``, so alignment never wedges on
  a zero-credit edge.
- **Shared-memory same-host edges** — a writer whose peer is on this host
  (:func:`_is_local_host`) sends its frames through a
  :class:`~flink_tensorflow_tpu_torch.native.ring.ShmByteRing` in
  ``/dev/shm``; the socket stays as handshake, doorbell and liveness
  channel, and credits ride the ring's grant cell.  The receiver removes
  the ring file's name as soon as it has attached.
- **Restart-epoch fence** — the handshake carries the sender's cohort
  restart epoch; a server of a newer epoch drops every frame of an older
  sender (a zombie of a failed attempt) and counts it.

Framing: ``[u32 pickle_len][u16 nbuf][pickle][per buffer: u64 len +
bytes]``, pickle protocol 5 with out-of-band buffers, so numpy payloads
travel as raw buffer views.  A tensor on a device crosses as the
reference's ``jax.Array`` does when pickled: as its host bytes.  The
receiver rebuilds it as a CPU tensor and never touches a device (the
reference's receiver ``device_put``\\ s it on its default device; a port
process that owns no card must not create a CUDA context for a record).

Left out until their slices (``ROADMAP.md`` items 3 and 4): the writer's
tracer spans and per-frame fault hook, and the sanitizer's
happens-before hooks on both ends.
"""

from __future__ import annotations

import collections
import copyreg
import io
import logging
import os
import pickle
import socket
import struct
import threading
import time
import typing

import numpy as np
import torch

from flink_tensorflow_tpu_torch.core import elements as el
from flink_tensorflow_tpu_torch.core.reactor import (
    Connection,
    FlushScheduler,
    Reactor,
    ShuffleFrameParser,
)
from flink_tensorflow_tpu_torch.native.ring import ShmByteRing, shm_dir
from flink_tensorflow_tpu_torch.tensors.serde import (
    batch_signature,
    decode_batch,
    encode_batch,
    normalize_wire_dtype,
)
from flink_tensorflow_tpu_torch.tensors.value import TensorValue

if typing.TYPE_CHECKING:
    from flink_tensorflow_tpu_torch.core.channels import InputGate

logger = logging.getLogger(__name__)

_FRAME_HDR = struct.Struct("<IH")  # pickle byte length, out-of-band buffer count
_BUF_HDR = struct.Struct("<Q")
_SMALL_FRAME = 1 << 16

#: Defaults of the coalescing knobs (``JobConfig.wire_flush_bytes`` /
#: ``wire_flush_ms`` per job; ``FLINK_TPU_WIRE_FLUSH_*`` per process).
DEFAULT_FLUSH_BYTES = 64 << 10
DEFAULT_FLUSH_MS = 5.0

#: The frame that tells an shm-mode receiver "the ring has frames".
RING_NOTIFY = "__ring_notify__"

#: Credit grant marker: the receiver sends ``(CREDIT_GRANT, n)`` frames
#: back on the data socket (shm edges use the ring's grant cell).
CREDIT_GRANT = "__credit__"

#: Frames that data flushed ahead of a barrier or end-of-partition may
#: overdraw the credit window by (the control element itself spends none).
CREDIT_OVERFLOW_FRAMES = 4


def credit_window(channel_capacity: int) -> int:
    """Per-edge credit window in frames, from the receiving gate's
    capacity in elements."""
    return max(2, min(32, channel_capacity // 32))


def env_flush_bytes() -> typing.Optional[int]:
    v = os.environ.get("FLINK_TPU_WIRE_FLUSH_BYTES")
    return int(v) if v else None


def env_flush_ms() -> typing.Optional[float]:
    v = os.environ.get("FLINK_TPU_WIRE_FLUSH_MS")
    return float(v) if v else None


def _env_flag(name: str) -> typing.Optional[bool]:
    v = os.environ.get(name)
    if v is None or v == "":
        return None
    return v.lower() in ("1", "true", "on", "yes")


def env_shm_enabled() -> typing.Optional[bool]:
    return _env_flag("FLINK_TPU_SHM")


def env_flow_control_enabled() -> typing.Optional[bool]:
    return _env_flag("FLINK_TPU_FLOW_CONTROL")


def connect_with_retry(host: str, port: int, timeout_s: float, *,
                       aborted: typing.Optional[typing.Callable[[], bool]] = None
                       ) -> socket.socket:
    """TCP connect with bounded exponential backoff until ``timeout_s``
    (cohort processes start in any order; a restarted peer's listener
    comes back within the window).  ``aborted()`` cuts the loop at once.
    Raises TimeoutError past the deadline."""
    deadline = time.monotonic() + timeout_s
    backoff = 0.05
    while True:
        if aborted is not None and aborted():
            raise TimeoutError(f"connect to {host}:{port} aborted during retry loop")
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TimeoutError(f"peer {host}:{port} unreachable within {timeout_s}s")
        try:
            # Capped attempts, so the loop re-polls ``aborted``.
            sock = socket.create_connection((host, port), timeout=min(remaining, 5.0))
        except OSError:
            time.sleep(min(backoff, max(0.0, deadline - time.monotonic())))
            backoff = min(backoff * 2.0, 1.0)
            continue
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock


class ColumnarFrame:
    """A coalesced homogeneous run on the wire: the ``encode_batch`` bytes
    ride as one out-of-band buffer (wrapped as uint8), timestamps as a
    per-record list (None when every record has none)."""

    __slots__ = ("payload", "timestamps")

    def __init__(self, payload, timestamps):
        self.payload = payload
        self.timestamps = timestamps

    def __getstate__(self):
        return (self.payload, self.timestamps)

    def __setstate__(self, state):
        self.payload, self.timestamps = state

    def records(self) -> typing.List[el.StreamRecord]:
        values = decode_batch(memoryview(self.payload))
        ts = self.timestamps
        return [el.StreamRecord(v, None if ts is None else ts[i]) for i, v in enumerate(values)]


def expand_message(obj) -> typing.List[typing.Any]:
    """One decoded frame -> the elements it carries (one element, a
    pickled list, or a columnar batch)."""
    if type(obj) is list:
        return obj
    if type(obj) is ColumnarFrame:
        return obj.records()
    return [obj]


def _host_tensor(t: torch.Tensor) -> torch.Tensor:
    return t


def _reduce_tensor(t: torch.Tensor):
    """A device tensor pickles as its host copy (rebuilt on the CPU); a
    CPU tensor as torch pickles it."""
    if t.device.type != "cpu":
        return _host_tensor, (t.detach().cpu(),)
    return t.__reduce_ex__(pickle.HIGHEST_PROTOCOL)


_DISPATCH = {**copyreg.dispatch_table, torch.Tensor: _reduce_tensor,
             torch.nn.Parameter: _reduce_tensor}


def _dumps(obj: typing.Any, buffer_callback=None) -> bytes:
    buf = io.BytesIO()
    pickler = pickle.Pickler(buf, protocol=5, buffer_callback=buffer_callback)
    pickler.dispatch_table = _DISPATCH
    pickler.dump(obj)
    return buf.getvalue()


def encode_obj_frame(obj: typing.Any) -> typing.Tuple[typing.List[typing.Any], int]:
    """One frame's wire parts and its payload bytes (pickle plus buffers,
    headers excluded, as the receiver counts them).  Out-of-band buffers
    travel as raw views; a buffer that is not contiguous falls back to
    in-band pickling."""
    bufs: typing.List[pickle.PickleBuffer] = []
    try:
        data = _dumps(obj, bufs.append)
        raws = [b.raw() for b in bufs]
    except BufferError:
        data = _dumps(obj)
        raws = []
    parts: typing.List[typing.Any] = [_FRAME_HDR.pack(len(data), len(raws)), data]
    total = len(data)
    for raw in raws:
        parts.append(_BUF_HDR.pack(raw.nbytes))
        parts.append(raw)
        total += raw.nbytes
    return parts, total


_RING_NOTIFY_WIRE: typing.Optional[bytes] = None


def _ring_notify_wire() -> bytes:
    """The doorbell frame's bytes, encoded once."""
    global _RING_NOTIFY_WIRE
    if _RING_NOTIFY_WIRE is None:
        parts, _ = encode_obj_frame(RING_NOTIFY)
        _RING_NOTIFY_WIRE = b"".join(bytes(p) for p in parts)
    return _RING_NOTIFY_WIRE


def _sendall_parts(sock: socket.socket, parts: typing.Sequence[typing.Any]) -> None:
    """Send a multi-part frame with one ``sendmsg`` per call, looping on
    partial sends."""
    views = [p if isinstance(p, memoryview) else memoryview(p) for p in parts]
    views = [v.cast("B") if v.format != "B" or v.ndim != 1 else v for v in views]
    while views:
        sent = sock.sendmsg(views)
        while sent:
            head = views[0]
            if sent >= head.nbytes:
                sent -= head.nbytes
                views.pop(0)
            else:
                views[0] = head[sent:]
                sent = 0


def _send_obj(conn: socket.socket, obj: typing.Any) -> int:
    """Blocking single-frame send (handshakes); returns payload bytes."""
    parts, total = encode_obj_frame(obj)
    if total < _SMALL_FRAME:
        conn.sendall(b"".join(parts))
    else:
        for p in parts:
            conn.sendall(p)
    return total


class _ServerRoute:
    """One connection's receive state machine on the server's reactor: the
    handshake, the backlog a full gate could not take yet, the shm ring,
    credit grants, the epoch fence and the EOP / truncation bookkeeping.
    Every method runs on the reactor thread."""

    def __init__(self, server: "ShuffleServer", sock: socket.socket):
        self.server = server
        self.route = "<handshake>"
        self.task: typing.Optional[str] = None
        self.subtask_index = -1
        self.channel_idx = -1
        self.gate: typing.Optional["InputGate"] = None
        self.is_control = False
        #: A sender of an older restart epoch: its frames are dropped.
        self.stale = False
        self.pending: typing.Deque[typing.Any] = collections.deque()
        self.ring: typing.Optional[ShmByteRing] = None
        self._ring_parser = ShuffleFrameParser()
        #: Credits: the window granted, and data frames delivered but not
        #: yet replenished.
        self.fc = False
        self._fc_window = 0
        self._fc_unacked = 0
        self._credit_grants = None
        self.saw_eop = False
        self.eof_clean: typing.Optional[bool] = None
        self.done = False
        self._records = self._bytes = None
        self._gate_paused = None
        self.conn = Connection(server.reactor, sock, parser=ShuffleFrameParser(),
                               on_message=self._on_message, on_resume=self._drain,
                               on_eof=self._on_eof, on_error=self._on_io_error)
        server.reactor.add_connection(self.conn)

    # -- frames ------------------------------------------------------------------
    def _on_message(self, item) -> bool:
        obj, nbytes = item
        if self.task is None:
            return self._handshake(obj)
        if self.stale:
            self.server.count_stale_frame()
            return True
        if self.is_control:
            if self.server.on_control is not None:
                self.server.on_control(self.subtask_index, obj)
            return True
        if obj == RING_NOTIFY:
            return self._drain()
        self._count_credit(obj)
        self._ingest(obj, nbytes)
        return self._drain()

    def _count_credit(self, obj) -> None:
        """A data frame earns a replenishment; a lone control element spent
        no credit at the sender, so it earns none."""
        if self.fc and not isinstance(
                obj, (el.CheckpointBarrier, el.Watermark, el.EndOfPartition)):
            self._fc_unacked += 1

    def _handshake(self, hello) -> bool:
        self.task, self.subtask_index, self.channel_idx = hello[0], hello[1], hello[2]
        self.route = f"{self.task}.{self.subtask_index}[ch{self.channel_idx}]"
        opts = hello[3] if len(hello) > 3 and isinstance(hello[3], dict) else {}
        peer_epoch = opts.get("epoch", 0)
        if peer_epoch < self.server.epoch:
            # A zombie of an earlier attempt: the connection stays open (a
            # raise would read as this process's failure) but nothing it
            # sends reaches a gate, and its disconnect is no error.
            self.stale = True
            self.route += f"[stale-epoch-{peer_epoch}]"
            logger.warning("fencing zombie sender %s: handshake epoch %d < server epoch %d",
                           self.route, peer_epoch, self.server.epoch)
            self.server.count_stale_frame()
            return True
        if self.task == ShuffleServer.CONTROL_TASK:
            # Control channel: subtask_index is the sending process.
            self.is_control = True
            return True
        gate = self.server._gates.get((self.task, self.subtask_index))
        if gate is None:
            raise ConnectionError(f"no local gate for route {self.route} — placement mismatch "
                                  "(peers must build the identical job graph)")
        self.gate = gate
        reactor = self.server.reactor
        gate.add_space_listener(lambda: reactor.submit(self._kick))
        if "shm" in opts:
            # Frames arrive through the ring; the socket is the doorbell and
            # the liveness channel.  The 5 ms poller backstops a doorbell
            # lost to the fence-free park/publish race.
            self.ring = ShmByteRing.attach(opts["shm"])
            # Both ends hold their mappings now: the name can go, so no
            # file outlives a pair of processes killed together (the
            # reference unlinks at close, which a SIGTERM skips).
            try:
                os.unlink(opts["shm"])
            except OSError:
                pass
            self.route += "[shm]"
            reactor.add_poller(self._ring_poll, 0.005)
        group = None
        if self.server.metrics is not None:
            group = self.server.metrics.group(
                f"shuffle.in.{self.task}.{self.subtask_index}.ch{self.channel_idx}")
            self._records = group.counter("records")
            self._bytes = group.counter("bytes")
            self._gate_paused = group.counter("gate_paused")
        if opts.get("fc"):
            self.fc = True
            self._fc_window = credit_window(gate.capacity)
            if group is not None:
                self._credit_grants = group.counter("credit_grants")
            gate.add_drain_listener(lambda: reactor.submit(self._fc_kick))
            self._grant(self._fc_window)
        return True

    def _ingest(self, obj, nbytes: int) -> None:
        elements = expand_message(obj)
        if self._records is not None:
            n = sum(1 for e in elements if isinstance(e, el.StreamRecord))
            if n:
                self._records.inc(n)
                self._bytes.inc(nbytes)
        self.pending.extend(elements)

    def _drain(self) -> bool:
        """Deliver the backlog (and in shm mode the ring) into the gate;
        False when stalled on a full gate (the connection pauses)."""
        while True:
            while self.pending:
                batch = list(self.pending)
                taken = self.gate.try_put_batch(self.channel_idx, batch)
                for element in batch[:taken]:
                    self.pending.popleft()
                    if type(element) is el.EndOfPartition:
                        self.saw_eop = True
                if taken < len(batch):
                    if self._gate_paused is not None:
                        self._gate_paused.inc()
                    return False
            if self.ring is None:
                self._maybe_grant()
                return True
            frame = self.ring.read()
            if frame is None:
                # Park, then look once more: a frame published between
                # the read and the park would wait on a suppressed doorbell.
                self.ring.set_consumer_parked(True)
                frame = self.ring.read()
                if frame is None:
                    self._maybe_grant()
                    return True
                self.ring.set_consumer_parked(False)
            for obj, nbytes in self._ring_parser.feed(frame):
                if obj == RING_NOTIFY:
                    continue
                self._count_credit(obj)
                self._ingest(obj, nbytes)

    # -- flow control ------------------------------------------------------------
    def _grant(self, n: int) -> None:
        """``n`` more credits to the sender: the ring's grant cell in shm
        mode, a ``(CREDIT_GRANT, n)`` frame on the socket otherwise."""
        if self.ring is not None:
            self.ring.add_credits(n)
        elif not self.conn.closed:
            parts, _ = encode_obj_frame((CREDIT_GRANT, n))
            self.conn.send(parts, block=False)
        if self._credit_grants is not None:
            self._credit_grants.inc(n)

    def _maybe_grant(self) -> None:
        """Replenish the frames whose elements all reached the gate, but
        only while the gate is below its low-water mark (granting into a
        backed-up gate would only move the sender's queue here)."""
        if not self.fc or self._fc_unacked <= 0 or self.pending or self.done:
            return
        gate = self.gate
        if gate is not None and len(gate._queue) >= gate._low_water:
            return
        n, self._fc_unacked = self._fc_unacked, 0
        self._grant(n)

    def _fc_kick(self) -> None:
        if not self.done:
            self._maybe_grant()

    def _kick(self) -> None:
        """The gate has space: resume a paused connection, or finish a
        delivery that outlived the connection."""
        if self.done:
            return
        if not self.conn.closed:
            self.conn._do_resume()
            if self.pending:
                # A ring route can stall in _ring_poll's _drain with the
                # connection never paused: deliver now.
                self._drain()
            return
        if self._drain():
            self._finish()

    def _ring_poll(self) -> None:
        """Reactor poller of a ring route: frames whose doorbell was lost,
        and a backlog stranded by a full gate."""
        if self.done or self.ring is None or (not self.ring.readable() and not self.pending):
            return
        self.ring.set_consumer_parked(False)
        if self.conn.closed:
            if self._drain():
                self._finish()
        elif self.conn._paused:
            self.conn._do_resume()
        else:
            self._drain()

    # -- teardown ----------------------------------------------------------------
    def _on_eof(self, clean: bool) -> None:
        self.eof_clean = clean
        if self.stale:
            self.done = True
            return
        if not clean:
            self._fail(ConnectionError(f"peer for {self.route} closed mid-frame "
                                       "(stream truncated)"))
            return
        if self.is_control or self.gate is None:
            self.done = True
            return
        if self._drain():
            self._finish()
        # else: the gate's space listener completes the backlog.

    def _finish(self) -> None:
        if self.done:
            return
        self.done = True
        if self.ring is not None:
            self.server.reactor.remove_poller(self._ring_poll)
            if self._ring_parser.buffered:
                self._fail(ConnectionError(f"peer for {self.route} died mid-ring-frame "
                                           "(stream truncated)"), force=True)
                return
            self.ring.close(unlink=True)
        if not self.saw_eop and not self.server._stop.is_set():
            self._fail(ConnectionError(f"peer for {self.route} disconnected before "
                                       "EndOfPartition (upstream process lost)"), force=True)

    def _on_io_error(self, exc: BaseException) -> None:
        if self.stale:
            self.done = True
            self.conn.close()
            return
        self._fail(exc)

    def _fail(self, exc: BaseException, force: bool = False) -> None:
        if self.done and not force:
            return
        self.done = True
        if self.ring is not None:
            self.server.reactor.remove_poller(self._ring_poll)
            self.ring.close(unlink=True)
        if not self.server._stop.is_set():
            logger.error("shuffle reader %s failed", self.route, exc_info=exc)
            if self.server.on_error is not None:
                self.server.on_error(exc)
        self.conn.close()

    def close(self) -> None:
        self.done = True
        self.conn.close()
        if self.ring is not None:
            self.server.reactor.remove_poller(self._ring_poll)
            self.ring.close(unlink=True)


class ShuffleServer:
    """The receiving endpoint of one process.

    Construct (binds at once, so the advertised port is owned before peers
    connect; ``port=0`` picks a free one, read back as :attr:`port`) ->
    :meth:`register_gate` for every local subtask -> :meth:`start` ->
    :meth:`close`.  Every connection runs on one reactor thread (its own,
    or the executor's).  A connection that ends before delivering
    EndOfPartition reports through ``on_error``: upstream process loss
    fails the job, never truncates its stream silently."""

    #: Handshake task of the control channel (checkpoint durability
    #: announcements, heartbeats): no gate, no EOP.
    CONTROL_TASK = "__control__"

    def __init__(self, bind: str = "0.0.0.0", port: int = 0, *,
                 on_error: typing.Optional[typing.Callable[[BaseException], None]] = None,
                 on_control: typing.Optional[typing.Callable[[int, typing.Any], None]] = None,
                 metrics: typing.Optional[typing.Any] = None,
                 reactor: typing.Optional[Reactor] = None,
                 epoch: int = 0):
        #: Senders whose handshake carries an older epoch are fenced.
        self.epoch = epoch
        self._stale_frames = None
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._listener.bind((bind, port))
            self._listener.listen(128)
        except OSError:
            self._listener.close()
            raise
        self.port: int = self._listener.getsockname()[1]
        self.on_error = on_error
        self.on_control = on_control
        #: Registry of the ingress counters; the reactor is their one writer.
        self.metrics = metrics
        self.reactor = reactor if reactor is not None else Reactor(
            name=f"shuffle-reactor:{self.port}")
        self._own_reactor = reactor is None
        self._gates: typing.Dict[typing.Tuple[str, int], "InputGate"] = {}
        self._routes: typing.List[_ServerRoute] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()

    def register_gate(self, task: str, subtask_index: int, gate: "InputGate") -> None:
        self._gates[(task, subtask_index)] = gate

    def count_stale_frame(self) -> None:
        """One dropped frame of a fenced sender (reactor thread)."""
        if self.metrics is None:
            return
        if self._stale_frames is None:
            self._stale_frames = self.metrics.group("recovery").counter("stale_epoch_frames")
        self._stale_frames.inc()

    def start(self) -> None:
        self.reactor.start()
        self.reactor.add_acceptor(self._listener, self._on_accept)
        if self.metrics is not None:
            group = self.metrics.group("reactor")
            reactor = self.reactor
            group.gauge("poll_to_dispatch_s", lambda: reactor.poll_to_dispatch_s)
            group.gauge("max_poll_to_dispatch_s", lambda: reactor.max_poll_to_dispatch_s)
            group.gauge("dispatches", lambda: reactor.dispatches)
            group.gauge("connections", lambda: len(self._routes))

    def _on_accept(self, conn: socket.socket) -> None:
        if self._stop.is_set():
            conn.close()
            return
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        route = _ServerRoute(self, conn)
        with self._lock:
            self._routes.append(route)

    def close(self, join: bool = True) -> None:
        """``join=False`` when closing from a reactor callback (the error
        path), where joining the reactor would deadlock."""
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            routes, self._routes = self._routes, []
        for route in routes:
            route.close()
        if self._own_reactor:
            self.reactor.close(join=join)


def _is_local_host(host: str) -> bool:
    """Whether ``host`` names this machine: the shm upgrade's eligibility
    test.  Unknown names stay on TCP."""
    if host in ("127.0.0.1", "localhost", "::1", "0.0.0.0"):
        return True
    try:
        return host == socket.gethostname()
    except OSError:
        return False


def _estimate_record_bytes(value: typing.Any) -> int:
    """A cheap payload estimate for the size-threshold flush."""
    if isinstance(value, TensorValue):
        return sum(a.nbytes for a in value.fields.values()) + 64
    nbytes = getattr(value, "nbytes", None)
    if isinstance(nbytes, int):
        return nbytes + 64
    return 256


class RemoteChannelWriter:
    """The ChannelWriter contract over TCP (or a same-host shm ring) to a
    peer's :class:`ShuffleServer`.

    One connection per (upstream subtask, downstream subtask, edge), so
    each channel is FIFO.  It connects on the first write, retrying for
    ``connect_timeout_s``; after :meth:`close` writes are dropped, as an
    in-process gate drops them after close.

    Coalescing: records buffer until ``flush_bytes`` of estimated payload
    or ``flush_ms`` after the first buffered one; control elements flush
    the buffer ahead of themselves and ship at once.  ``flush_bytes=0`` is
    a frame per record, ``flush_ms=0`` flushes every record.  With a
    ``reactor`` sends queue on the connection's bounded send queue (the
    writing thread pays no syscall); without one they are blocking
    ``sendmsg`` calls.  With ``shm=True`` and a peer on this host, frames
    go through a :class:`ShmByteRing`.  ``flow_control`` needs a grant
    lane (a reactor, or the ring); a blocking writer stays credit-free.

    A transport error retries connect and handshake with backoff for
    ``reconnect_timeout_s`` and resends the frame in flight (frames are
    encoded whole before any byte leaves, so a break between frames loses
    nothing; a break inside one truncates the receiver's parser, which
    fails the peer loudly)."""

    def __init__(self, host: str, port: int, task: str, subtask_index: int,
                 channel_idx: int, *, connect_timeout_s: float = 60.0,
                 metrics: typing.Optional[typing.Any] = None,
                 flush_bytes: typing.Optional[int] = None,
                 flush_ms: typing.Optional[float] = None,
                 columnar: bool = True,
                 wire_dtype: typing.Optional[str] = None,
                 reactor: typing.Optional[Reactor] = None,
                 shm: bool = False,
                 shm_ring_bytes: int = 8 << 20,
                 epoch: int = 0,
                 reconnect_timeout_s: float = 5.0,
                 flow_control: bool = False):
        self.host = host
        self.port = port
        self.task = task
        self.subtask_index = subtask_index
        self.channel_idx = channel_idx
        self.connect_timeout_s = connect_timeout_s
        self.epoch = epoch
        self.reconnect_timeout_s = reconnect_timeout_s
        self.flow_control = flow_control
        self._fc_cv = threading.Condition()
        self._fc_credits = 0        # TCP grants available (may overdraw)
        self._fc_ring_spent = 0     # frames spent against the ring's grant cell
        self._fc_gen = 0            # transport generation: fences stale grants
        self._fc_active = False     # this transport negotiated credits
        self._fc_starved_s = 0.0    # seconds parked at zero credit
        env_b, env_ms = env_flush_bytes(), env_flush_ms()
        self.flush_bytes = (env_b if env_b is not None
                            else flush_bytes if flush_bytes is not None else DEFAULT_FLUSH_BYTES)
        self.flush_ms = (env_ms if env_ms is not None
                         else flush_ms if flush_ms is not None else DEFAULT_FLUSH_MS)
        self.columnar = columnar
        self.wire_dtype = normalize_wire_dtype(wire_dtype)
        self.shm = shm and _is_local_host(host)
        self.shm_ring_bytes = shm_ring_bytes
        self._reactor = reactor
        self._sock: typing.Optional[socket.socket] = None
        self._conn: typing.Optional[Connection] = None
        self._ring: typing.Optional[ShmByteRing] = None
        self._closed = False
        #: EndOfPartition went out: the receiver unlinks the ring file
        #: after its clean EOF.  Otherwise (a cancel) close() unlinks it.
        self._eop_sent = False
        self._lock = threading.RLock()
        #: A flush that failed on the timer thread parks its error here;
        #: the next write() raises it on the owning subtask.
        self._error: typing.Optional[BaseException] = None
        self._buf: typing.List[el.StreamRecord] = []
        self._buf_bytes = 0
        self._buf_t0 = 0.0
        self._timer_armed = False
        self._records = self._bytes = None
        self._flush_counters = None
        self._frame_records = self._frame_bytes = None
        self._flush_total = None
        self._reconnects = None
        self._edge_reconnects = None
        if metrics is not None:
            group = metrics.group(f"shuffle.out.{task}.{subtask_index}.ch{channel_idx}")
            self._records = group.counter("records")
            self._bytes = group.counter("bytes")
            self._flush_counters = {reason: group.counter(f"flush_{reason}")
                                    for reason in ("size", "timeout", "barrier", "close")}
            self._frame_records = group.histogram("frame_records")
            self._frame_bytes = group.histogram("frame_bytes")
            self._flush_total = metrics.group("wire").meter("flush_total")
            self._reconnects = group.counter("reconnects")
            self._edge_reconnects = metrics.group("recovery").meter("edge_reconnects")
            group.gauge("send_queue_depth",
                        lambda: 0 if self._conn is None else self._conn.send_queue_depth)
            group.gauge("send_queue_bytes",
                        lambda: 0 if self._conn is None else self._conn.send_queue_bytes)
            group.gauge("peak_send_queue_bytes",
                        lambda: 0 if self._conn is None else self._conn.peak_send_queue_bytes)
            group.gauge("credits_available", self._fc_credits_now)
            group.gauge("credit_starved_s", lambda: self._fc_starved_s)

    # -- connection ----------------------------------------------------------------
    def _connect(self, timeout_s: typing.Optional[float] = None) -> None:
        self._sock = connect_with_retry(
            self.host, self.port, self.connect_timeout_s if timeout_s is None else timeout_s,
            aborted=lambda: self._closed)
        opts: typing.Dict[str, typing.Any] = {"epoch": self.epoch}
        if self.shm:
            path = os.path.join(
                shm_dir(),
                f"ftt-ring-{self.port}-{os.getpid()}-"
                f"{abs(hash((self.task, self.subtask_index, self.channel_idx))) % (1 << 32):08x}")
            self._ring = ShmByteRing.create(path, self.shm_ring_bytes)
            opts.update({"shm": path, "capacity": self._ring.capacity})
        fc = self.flow_control and (self._ring is not None or self._reactor is not None)
        if fc:
            opts["fc"] = True
        _send_obj(self._sock, (self.task, self.subtask_index, self.channel_idx, opts))
        with self._fc_cv:
            # A new transport generation: credits restart at zero and wait
            # for the new route's grant; grants of an older generation are
            # dropped on arrival.
            self._fc_gen += 1
            self._fc_credits = 0
            self._fc_ring_spent = 0
            self._fc_active = fc
            gen = self._fc_gen
            self._fc_cv.notify_all()
        if self._reactor is not None and self._ring is None:
            if fc:
                # Grant frames arrive on this socket.
                self._conn = Connection(
                    self._reactor, self._sock, parser=ShuffleFrameParser(),
                    on_message=lambda item, _g=gen: self._on_grant(item, _g),
                    on_eof=lambda clean: self._fc_wake(),
                    on_error=lambda exc: self._fc_wake())
            else:
                self._conn = Connection(self._reactor, self._sock)
            self._reactor.add_connection(self._conn)

    # -- write path ----------------------------------------------------------------
    def write(self, element: el.StreamElement) -> None:
        if self._closed:
            return
        with self._lock:
            if self._closed:
                return
            if self._error is not None:
                exc, self._error = self._error, None
                raise exc
            if self._sock is None:
                # On the writing thread: a cohort-startup retry must not
                # stall the shared flush timer.
                self._connect()
            if type(element) is el.StreamRecord and self.flush_bytes > 0:
                self._buf.append(element)
                self._buf_bytes += _estimate_record_bytes(element.value)
                if len(self._buf) == 1:
                    self._buf_t0 = time.monotonic()
                    if self.flush_ms > 0 and not self._timer_armed:
                        # One pending deadline per writer, re-armed from the
                        # timer thread.
                        self._timer_armed = True
                        FlushScheduler.shared().schedule(self._buf_t0 + self.flush_ms / 1e3,
                                                         self._timer_fire)
                if self._buf_bytes >= self.flush_bytes:
                    self._flush_locked("size")
                elif self.flush_ms <= 0:
                    self._flush_locked("timeout")
                return
            if isinstance(element, (el.CheckpointBarrier, el.Watermark)):
                self._flush_locked("barrier")
            else:
                self._flush_locked("close" if isinstance(element, el.EndOfPartition) else "size")
            self._send_one(element)
            if isinstance(element, el.EndOfPartition):
                self._eop_sent = True

    def _timer_fire(self) -> None:
        """Buffer timeout (FlushScheduler thread): re-arms toward the
        current buffer's deadline, disarms when the writer idles."""
        if not self._lock.acquire(blocking=False):
            # The writing thread holds the lock, maybe parked at zero
            # credit: the shared timer must not wait on one edge.
            FlushScheduler.shared().schedule(time.monotonic() + max(self.flush_ms, 5.0) / 1e3,
                                             self._timer_fire)
            return
        try:
            if self._closed or not self._buf:
                self._timer_armed = False
                return
            due = self._buf_t0 + self.flush_ms / 1e3
            if time.monotonic() + 1e-4 < due:
                FlushScheduler.shared().schedule(due, self._timer_fire)
                return
            self._timer_armed = False
            try:
                self._flush_locked("timeout")
            except (OSError, ConnectionError, TimeoutError) as exc:
                self._error = exc  # raised by the owning subtask's next write
        finally:
            self._lock.release()

    def _flush_locked(self, reason: str) -> None:
        buf = self._buf
        if not buf:
            return
        if (reason == "timeout" and self.flush_ms > 0 and self._fc_active
                and not self._fc_available()):
            # A latency flush at zero credit keeps buffering and re-arms:
            # the shared timer thread never parks behind one edge.
            if not self._timer_armed:
                self._timer_armed = True
                FlushScheduler.shared().schedule(time.monotonic() + self.flush_ms / 1e3,
                                                 self._timer_fire)
            return
        self._buf = []
        self._buf_bytes = 0
        n = len(buf)
        obj: typing.Any = buf[0] if n == 1 else self._coalesce(buf)
        parts, payload_bytes = encode_obj_frame(obj)
        self._send_parts(parts, fc="align" if reason in ("barrier", "close") else "data")
        if self._records is not None:
            self._records.inc(n)
            self._bytes.inc(payload_bytes)
            self._flush_counters[reason].inc()
            self._frame_records.record(n)
            self._frame_bytes.record(payload_bytes)
            self._flush_total.mark()

    def _coalesce(self, buf: typing.List[el.StreamRecord]) -> typing.Any:
        """Columnar when every record is a homogeneous TensorValue, else the
        element list."""
        if self.columnar:
            sig = batch_signature(buf[0].value)
            if sig is not None and all(batch_signature(r.value) == sig for r in buf[1:]):
                payload = encode_batch([r.value for r in buf], self.wire_dtype)
                timestamps = ([r.timestamp for r in buf]
                              if any(r.timestamp is not None for r in buf) else None)
                return ColumnarFrame(np.frombuffer(payload, np.uint8), timestamps)
        return buf

    def _send_one(self, element: typing.Any) -> None:
        parts, payload_bytes = encode_obj_frame(element)
        # A lone control element bypasses credit: a zero-credit edge must
        # still align and end.
        self._send_parts(parts, fc="bypass")
        if self._records is not None and isinstance(element, el.StreamRecord):
            self._records.inc()
            self._bytes.inc(payload_bytes)

    def _send_parts(self, parts, fc: str = "data") -> None:
        try:
            if self._sock is None:
                self._connect()
            self._fc_acquire(fc)
            self._transmit(parts)
        except (OSError, ConnectionError):
            # Drop the dead transport, so a later write reconnects.
            self._teardown_transport()
            if self._closed:
                return
            if self._reconnect_and_resend(parts):
                return
            raise  # peer loss is this subtask's failure, hence the job's

    def _transmit(self, parts) -> None:
        if self._ring is not None:
            total = sum(p.nbytes if isinstance(p, memoryview) else len(p) for p in parts)
            while not self._ring.try_write_parts(parts, total):
                # A full ring is same-host backpressure.
                if self._closed:
                    return
                time.sleep(0.0001)
            # Ring the socket only for a parked consumer.
            if self._ring.consumer_parked():
                self._ring.set_consumer_parked(False)
                self._sock.sendall(_ring_notify_wire())
        elif self._conn is not None:
            self._conn.send(parts)
        else:
            _sendall_parts(self._sock, parts)

    # -- flow control --------------------------------------------------------------
    def _fc_available(self) -> bool:
        """Credit peek (writer lock held; only this writer spends)."""
        ring = self._ring
        if ring is not None:
            try:
                return self._fc_ring_spent < ring.credits_granted()
            except (ValueError, OSError):
                return True  # ring torn down: let the send fail loudly
        return self._fc_credits > 0

    def _fc_credits_now(self) -> int:
        ring = self._ring
        if ring is not None and self._fc_active:
            try:
                return max(0, ring.credits_granted() - self._fc_ring_spent)
            except (ValueError, OSError):
                return 0
        return self._fc_credits

    def _on_grant(self, item, gen: int) -> bool:
        """A grant frame (reactor thread).  One bound to a retired
        transport generation is dropped."""
        obj = item[0]
        if isinstance(obj, tuple) and len(obj) == 2 and obj[0] == CREDIT_GRANT:
            with self._fc_cv:
                if gen == self._fc_gen:
                    self._fc_credits += int(obj[1])
                    self._fc_cv.notify_all()
        return True

    def _fc_wake(self) -> None:
        with self._fc_cv:
            self._fc_cv.notify_all()

    def _fc_acquire(self, fc: str) -> None:
        """Spend one credit, parking while the window is exhausted (close,
        transport loss and reconnect break the wait).  ``"data"`` parks at
        zero, ``"align"`` may overdraw by CREDIT_OVERFLOW_FRAMES,
        ``"bypass"`` spends nothing.  Parking here, under the writer lock,
        is what throttles the producer."""
        if not self._fc_active or fc == "bypass":
            return
        floor = -CREDIT_OVERFLOW_FRAMES if fc == "align" else 0
        if self._ring is not None:
            self._fc_acquire_ring(floor)
            return
        t0 = None
        with self._fc_cv:
            gen = self._fc_gen
            while (self._fc_credits <= floor and not self._closed and self._fc_gen == gen
                   and self._conn is not None and not self._conn.closed):
                if t0 is None:
                    t0 = time.monotonic()
                self._fc_cv.wait(0.05)
            if t0 is not None:
                self._fc_starved_s += time.monotonic() - t0
            self._fc_credits -= 1

    def _fc_acquire_ring(self, floor: int) -> None:
        """Ring-mode spend: our cumulative spends against the consumer's
        cumulative grants (both monotonic, the ring cursors' SPSC rule)."""
        t0 = None
        while not self._closed:
            ring = self._ring
            if ring is None:
                break
            try:
                granted = ring.credits_granted()
            except (ValueError, OSError):
                break
            if self._fc_ring_spent < granted - floor:
                self._fc_ring_spent += 1
                break
            if t0 is None:
                t0 = time.monotonic()
            time.sleep(0.0005)
        if t0 is not None:
            self._fc_starved_s += time.monotonic() - t0

    def _reconnect_and_resend(self, parts) -> bool:
        """Reconnect with backoff and resend the frame in flight; True on
        success.  A restarted peer fences this writer by epoch if the
        cohort moved on."""
        budget = self.reconnect_timeout_s
        if budget <= 0:
            return False
        deadline = time.monotonic() + budget
        backoff = 0.05
        attempt = 0
        while not self._closed and time.monotonic() < deadline:
            attempt += 1
            time.sleep(min(backoff, max(0.0, deadline - time.monotonic())))
            backoff = min(backoff * 2.0, 1.0)
            try:
                self._connect(timeout_s=max(0.05, deadline - time.monotonic()))
                self._transmit(parts)
            except (OSError, ConnectionError, TimeoutError):
                self._teardown_transport()
                continue
            if self._reconnects is not None:
                self._reconnects.inc()
                self._edge_reconnects.mark()
            logger.warning("edge to %s.%d[ch%d] at %s:%d re-established after %d attempt(s); "
                           "in-flight frame resent", self.task, self.subtask_index,
                           self.channel_idx, self.host, self.port, attempt)
            return True
        return False

    def _teardown_transport(self) -> None:
        with self._fc_cv:
            # Retire the generation: stale grants become no-ops, a parked
            # sender wakes to see the dead connection.
            self._fc_gen += 1
            self._fc_active = False
            self._fc_credits = 0
            self._fc_cv.notify_all()
        if self._conn is not None:
            self._conn.close()
            self._conn = None
        if self._ring is not None:
            self._ring.close(unlink=True)
            self._ring = None
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        self._closed = True
        with self._fc_cv:
            self._fc_cv.notify_all()  # break a credit park now
        # What is still buffered belongs to a cancelled job (a clean stream
        # ends with EndOfPartition, which flushed everything ahead of it).
        acquired = self._lock.acquire(timeout=2.0)
        try:
            self._buf = []
            self._buf_bytes = 0
        finally:
            if acquired:
                self._lock.release()
        if self._conn is not None:
            self._conn.drain(timeout=2.0)
            self._conn.close()
            self._conn = None
        if self._ring is not None:
            self._ring.close(unlink=not self._eop_sent)
            self._ring = None
        if self._sock is not None:
            try:
                self._sock.shutdown(socket.SHUT_WR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
