"""The job-to-job pipe: stream records between processes over TCP.

Port of ``flink_tensorflow_tpu/io/remote.py``.  ``RemoteSink`` streams
length-prefixed codec frames (``tensors/serde.py``) to a peer;
``RemoteSource`` accepts connections and yields the records.  A TCP
source cannot rewind, so a job that replays after a failure re-reads
nothing from it: delivery through the pipe is at-least-once unless a
durable log fronts it, as Flink treats raw socket sources.

**Coalescing** (Flink's buffer timeout): the sink buffers records and
flushes one burst at ``flush_bytes`` (default
``JobConfig.wire_flush_bytes``) or ``flush_ms`` after the first buffered
record (default ``JobConfig.wire_flush_ms``); ``close()`` flushes what is
left.  A homogeneous burst encodes columnar (``encode_batch``: one header
and one contiguous buffer per field), any other as per-record frames in
one send.  ``flush_bytes=0`` is a frame per record.

**Credits**: a sink that wants them sends an 8-byte hello frame after
each connect; a source that understands it grants a window of
``credit_window(queue_capacity)`` frames as raw little-endian u64
increments on the sink-bound half of the socket, and one more per frame
once the frame's records were consumed.  A sink that sees no grant within
the probe grace sends credit-free.

**Reconnect**: a burst whose send fails reconnects with exponential
backoff within ``reconnect_timeout_s`` and is sent again whole; the
source holds the peer's fan-in slot open for ``reconnect_grace_s``.  A
zero-length frame marks a clean end of stream; any other drop is a
reconnect candidate.

**One event loop**: ``RemoteSource`` multiplexes its ``fan_in`` peers on
one ``selectors`` loop inside the source generator, and decodes only as
fast as the pipeline consumes.

The sink takes its coalescing defaults, its flow-control default, the
sanitizer, the tracer and its edge fault hook (``sever``, ``blackhole``,
``delay`` from ``core/faults.py``) from the runtime context at
``open()``.

**Spans** (JAX ``:355-380``, ``:483-492``, ``:657-712``, ``:900-910``):
a traced sink records ``wire.flush``, ``serde`` and ``wire`` per burst
and ``wire.credit_wait`` per park longer than 1 ms, and stamps each
traced record's metadata with ``__trace__ = (trace id, pid, send
time)``, so the receiving job continues the same trace.  A traced
source records ``serde`` per frame and, once the cohort's clock sync
knows the sender's offset, the one-way ``edge.wire_latency_s`` of each
frame's first record beside its error bound ``edge.wire_latency_err_s``.
"""

from __future__ import annotations

import collections
import logging
import os
import select
import selectors
import socket
import struct
import threading
import time
import typing

from flink_tensorflow_tpu_torch.core import functions as fn
from flink_tensorflow_tpu_torch.core.elements import SOURCE_IDLE
from flink_tensorflow_tpu_torch.core.reactor import FlushScheduler, LengthPrefixedParser
from flink_tensorflow_tpu_torch.core.shuffle import (
    CREDIT_OVERFLOW_FRAMES,
    DEFAULT_FLUSH_BYTES,
    DEFAULT_FLUSH_MS,
    _sendall_parts,
    connect_with_retry,
    credit_window,
    env_flush_bytes,
    env_flush_ms,
)
from flink_tensorflow_tpu_torch.tensors.serde import (
    batch_signature,
    decode_frame,
    encode_batch,
    encode_record,
    normalize_wire_dtype,
    wire_bytes_saved,
)
from flink_tensorflow_tpu_torch.tensors.value import TensorValue

_LEN = struct.Struct("<Q")

#: Credit flow-control handshake on the job-to-job pipe: a sink that
#: wants credits ships this 8-byte payload as an ordinary
#: length-prefixed frame right after connecting (and after every
#: reconnect).  A RemoteSource that understands it replies with credit
#: grants — raw little-endian u64 *increments* on the sink-bound half
#: of the same socket (the only bytes that ever flow that direction) —
#: starting with an initial window of ``credit_window(queue_capacity)``
#: frames.  Sinks that see no grant within the probe grace downgrade
#: permanently to the classic credit-free wire, so raw TCP readers and
#: pre-credit peers keep working unchanged.
_FC_MAGIC = b"\xffFLOWCTL"
_FC_PROBE_GRACE_S = 2.0
_GRANT = struct.Struct("<Q")
#: How long a closing sink keeps reading (and discarding) what its peer
#: still sends after the end-of-stream marker, until the peer closes its
#: side.  A socket closed with unread bytes (credit grants that arrived
#: after the last burst) is reset instead of shut down, and the reset
#: makes the peer's kernel drop what the peer had not read yet: the last
#: bursts and the marker, so the source took a clean end for a drop.
_CLOSE_DRAIN_S = 5.0

#: Origin pid of the cross-process trace stamps (the tracer's own).
_PID = os.getpid()

logger = logging.getLogger(__name__)


class RemoteSink(fn.SinkFunction):
    """Ships records (TensorValue) to a RemoteSource over TCP, coalesced
    into multi-record bursts with a columnar fast path."""

    #: Frames replayed after a restore are sent again down the wire and
    #: the peer cannot tell them from fresh ones.
    idempotent = False

    def __init__(self, host: str, port: int, *, connect_timeout_s: float = 30.0,
                 wire_dtype: typing.Optional[str] = None,
                 flush_bytes: typing.Optional[int] = None,
                 flush_ms: typing.Optional[float] = None,
                 columnar: bool = True,
                 reconnect_timeout_s: float = 5.0,
                 flow_control: typing.Optional[bool] = None):
        self.host = host
        self.port = port
        self.connect_timeout_s = connect_timeout_s
        #: Self-healing send path: a burst whose send fails reconnects
        #: with exponential backoff within this budget and is resent
        #: whole (the peer RemoteSource holds the fan-in slot open for
        #: the replacement connection).  Frames already swallowed by the
        #: dead socket's kernel buffer are NOT resent — raw TCP pipes
        #: stay at-least-once (module docstring; the exactly-once
        #: boundary lint points at the durable-WAL pattern).  0 restores
        #: fail-fast sends.
        self.reconnect_timeout_s = reconnect_timeout_s
        #: Compact on-the-wire dtype for float fields (tensors/serde.py);
        #: None defers to JobConfig.wire_dtype at open().
        self.wire_dtype = normalize_wire_dtype(wire_dtype)
        #: Coalescing knobs; None defers to JobConfig.wire_flush_bytes /
        #: wire_flush_ms (env-overridable) at open().
        self.flush_bytes = flush_bytes
        self.flush_ms = flush_ms
        self.columnar = columnar
        #: Credit-based flow control (module `_FC_MAGIC` docs): None
        #: defers to JobConfig.flow_control at open(); False pins the
        #: classic credit-free wire.
        self.flow_control = flow_control
        self._wire: typing.Optional[str] = self.wire_dtype
        self._sock: typing.Optional[socket.socket] = None
        self._tracer = None
        self._track = ""
        self._san = None
        self._hb_edge = ""
        self._saved_counter = None
        self._lock = threading.Lock()
        self._buf: typing.List[TensorValue] = []
        self._buf_bytes = 0
        self._buf_t0 = 0.0
        self._timer_armed = False
        self._flush_bytes = 0
        self._flush_ms = 0.0
        self._error: typing.Optional[BaseException] = None
        self._flush_counters: typing.Optional[dict] = None
        self._frame_records = self._frame_bytes = None
        self._flush_total = None
        self._fault_hook = None
        self._reconnects = None
        self._edge_reconnects = None
        # Credit state.  "off": classic wire.  "probe": hello sent,
        # waiting for the peer's first grant.  "on": every data burst
        # spends one credit; zero credit parks the producer.
        self._fc_state = "off"
        self._fc_credits = 0
        self._fc_rxbuf = b""
        self._fc_probe_waited = False
        self._credit_starved_s = 0.0
        self._resends = None
        self._resent_total = 0

    def clone(self):
        return RemoteSink(self.host, self.port,
                          connect_timeout_s=self.connect_timeout_s,
                          wire_dtype=self.wire_dtype,
                          flush_bytes=self.flush_bytes,
                          flush_ms=self.flush_ms,
                          columnar=self.columnar,
                          reconnect_timeout_s=self.reconnect_timeout_s,
                          flow_control=self.flow_control)

    def open(self, ctx) -> None:
        self._tracer = getattr(ctx, "tracer", None)
        self._track = f"{ctx.task_name}.{ctx.subtask_index}"
        # Distributed sanitizer: the job-to-job pipe logs its half of
        # each happens-before edge.  The edge name is directional and
        # sink-local on purpose — the pipe has no conn handshake, so the
        # stitcher must never pair these with the receiving job's log
        # (pairing without a shared conn id would be a false positive
        # factory); they enrich the per-process dump and local checks.
        self._san = getattr(ctx, "sanitizer", None)
        self._hb_edge = (f"{ctx.task_name}.{ctx.subtask_index}"
                         f"->{self.host}:{self.port}")
        self._wire = (self.wire_dtype
                      if self.wire_dtype is not None
                      else getattr(ctx, "wire_dtype", None))
        env_b, env_ms = env_flush_bytes(), env_flush_ms()
        self._flush_bytes = (
            env_b if env_b is not None
            else self.flush_bytes if self.flush_bytes is not None
            else getattr(ctx, "wire_flush_bytes", None) or DEFAULT_FLUSH_BYTES)
        self._flush_ms = (
            env_ms if env_ms is not None
            else self.flush_ms if self.flush_ms is not None
            else getattr(ctx, "wire_flush_ms", None) or DEFAULT_FLUSH_MS)
        if ctx.metrics is not None:
            if self._wire is not None:
                self._saved_counter = ctx.metrics.counter("wire_bytes_saved")
            # Flush-reason attribution + per-edge frame shape (satellite
            # of the coalescing plane; invoke/flush serialize on _lock).
            self._flush_counters = {
                reason: ctx.metrics.counter(f"wire_flush_{reason}")
                for reason in ("size", "timeout", "close")
            }
            self._frame_records = ctx.metrics.histogram("frame_records")
            self._frame_bytes = ctx.metrics.histogram("frame_bytes")
            self._flush_total = ctx.metrics.meter("wire_flush_total")
            self._reconnects = ctx.metrics.counter("reconnects")
            #: Resent bursts are booked HERE, never on the wire_flush_*
            #: reason counters — one logical flush ticks its reason
            #: exactly once no matter how many times the burst hits the
            #: wire, so attribution parity
            #: (wire_flush_total == size+timeout+close) holds across
            #: reconnects.
            self._resends = ctx.metrics.counter("resent_bursts")
            # Credit-plane observability (health rule `credit-starvation`
            # + doctor bottleneck ranking key off these).
            ctx.metrics.gauge("edge.credits_available",
                              lambda: float(self._fc_credits)
                              if self._fc_state == "on" else -1.0)
            ctx.metrics.gauge("edge.credit_starved_s",
                              lambda: self._credit_starved_s)
            registry = getattr(ctx.metrics, "_registry", None)
            if registry is not None:
                self._edge_reconnects = registry.group("recovery").meter(
                    "edge_reconnects")
        # Chaos plane: sever/blackhole/delay specs targeting this sink's
        # subtask fire inside _flush_locked (core/faults.py).
        injector = getattr(ctx, "fault_injector", None)
        if injector is not None:
            self._fault_hook = injector.edge_hook(
                ctx.task_name, ctx.subtask_index)

        # Bounded-backoff connect retry (the same loop the shuffle plane
        # uses for cohort startup): ANY OSError — refused, unreachable,
        # reset mid-handshake — retries until the deadline, because the
        # peer's listener may come up, or come BACK up, after this job
        # starts.
        self._sock = connect_with_retry(
            self.host, self.port, self.connect_timeout_s)
        fc_on = (self.flow_control if self.flow_control is not None
                 else getattr(ctx, "flow_control", True))
        if fc_on:
            self._fc_hello()

    def _fc_hello(self) -> None:
        """Start the credit handshake on the current socket: ship the
        FC hello frame and enter "probe" — the first grant (whenever it
        arrives) locks credits on.  Probe is non-terminal: a silent
        peer costs one probe-grace wait on the first burst, after which
        bursts flow credit-free while the sink keeps listening — so raw
        pre-credit readers never park this sink, yet a RemoteSource
        whose generator starts late (a consumer already overloaded at
        startup) still gets the credit loop the moment it grants."""
        self._fc_state = "probe"
        self._fc_probe_waited = False
        self._fc_credits = 0
        self._fc_rxbuf = b""
        try:
            self._sock.sendall(_LEN.pack(len(_FC_MAGIC)) + _FC_MAGIC)
        except OSError:
            pass  # the next burst's send notices and reconnects

    def _harvest_grants(self, timeout: float) -> bool:
        """Pull any credit grants off the sink-bound half of the socket
        (raw u64 increments).  Returns False when the peer is gone (EOF
        or socket error) — the caller stops parking and lets the send
        path run its reconnect loop."""
        sock = self._sock
        if sock is None:
            return False
        try:
            readable, _, _ = select.select([sock], [], [], timeout)
        except (OSError, ValueError):
            return False
        if not readable:
            return True
        try:
            chunk = sock.recv(4096)
        except (BlockingIOError, InterruptedError):
            return True
        except OSError:
            return False
        if not chunk:
            return False
        buf = self._fc_rxbuf + chunk
        while len(buf) >= _GRANT.size:
            self._fc_credits += _GRANT.unpack_from(buf)[0]
            buf = buf[_GRANT.size:]
            if self._fc_state == "probe":
                self._fc_state = "on"
        self._fc_rxbuf = buf
        return True

    def _fc_available(self) -> bool:
        """Non-destructive peek for the timeout-flush skip."""
        if self._fc_state == "off":
            return True
        self._harvest_grants(0.0)
        return self._fc_state != "on" or self._fc_credits > 0

    def _fc_acquire(self, fc: str) -> None:
        """Spend one credit for a burst about to hit the wire.

        ``fc`` mirrors the shuffle writer's modes: "data" parks at
        floor 0 until the RemoteSource grants; "align" (close-flush)
        may overdraw to -CREDIT_OVERFLOW_FRAMES so teardown never
        wedges on a stalled consumer; "bypass" (the EOS marker) spends
        nothing.  Parked time accrues on ``edge.credit_starved_s``.
        """
        if fc == "bypass" or self._fc_state == "off":
            return
        if self._fc_state == "probe":
            if not self._fc_probe_waited:
                deadline = time.monotonic() + _FC_PROBE_GRACE_S
                while (self._fc_state == "probe"
                       and time.monotonic() < deadline):
                    if not self._harvest_grants(0.05):
                        break
                self._fc_probe_waited = True
            else:
                self._harvest_grants(0.0)
            if self._fc_state != "on":
                return  # still probing: send credit-free, keep listening
        floor = -CREDIT_OVERFLOW_FRAMES if fc == "align" else 0
        san = self._san
        self._harvest_grants(0.0)
        if self._fc_credits > floor:
            self._fc_credits -= 1
            if san is not None:
                san.hb("credit.spend", self._hb_edge,
                       balance=self._fc_credits, floor=floor)
            return
        t0 = time.monotonic()
        if san is not None:
            san.hb("credit.park", self._hb_edge, floor=floor)
        while self._fc_credits <= floor:
            if not self._harvest_grants(0.05):
                break  # peer gone; the send path reconnects (or raises)
        waited = time.monotonic() - t0
        self._credit_starved_s += waited
        if san is not None:
            san.hb("credit.unpark", self._hb_edge, waited_s=waited)
        if self._tracer is not None and waited > 1e-3:
            self._tracer.span(self._track, "wire.credit_wait", t0, time.monotonic(),
                              args={"mode": fc})
        self._fc_credits -= 1
        if san is not None:
            san.hb("credit.spend", self._hb_edge,
                   balance=self._fc_credits, floor=floor)

    def invoke(self, value) -> None:
        if not isinstance(value, TensorValue):
            raise TypeError("RemoteSink carries TensorValue records")
        if self._saved_counter is not None:
            self._saved_counter.inc(wire_bytes_saved(value, self._wire))
        tracer = self._tracer
        if tracer is not None:
            # The trace id rides the frame in the record's metadata, so
            # the receiving source continues the same trace; the pid and
            # send stamp let a clock-synced receiver record the hop.
            tctx = tracer.current()
            if tctx is not None:
                value = value.with_meta(__trace__=(tctx.trace_id, _PID, time.monotonic()))
        with self._lock:
            if self._error is not None:
                exc, self._error = self._error, None
                raise exc
            if self._flush_bytes <= 0:
                self._buf.append(value)
                self._flush_locked("size")
                return
            self._buf.append(value)
            self._buf_bytes += sum(
                a.nbytes for a in value.fields.values()) + 64
            if len(self._buf) == 1:
                self._buf_t0 = time.monotonic()
                if self._flush_ms > 0 and not self._timer_armed:
                    # One pending deadline per sink, re-armed from the
                    # timer thread (mirrors RemoteChannelWriter): the hot
                    # invoke path never wakes the shared timer.
                    self._timer_armed = True
                    FlushScheduler.shared().schedule(
                        self._buf_t0 + self._flush_ms / 1e3,
                        self._timer_fire)
            if self._buf_bytes >= self._flush_bytes:
                self._flush_locked("size")
            elif self._flush_ms <= 0:
                self._flush_locked("timeout")

    def _timer_fire(self) -> None:
        # Non-blocking acquire: the invoke thread may hold _lock for
        # seconds while parked on credits, and this runs on the
        # process-wide FlushScheduler thread — one starved edge must
        # not stall every other edge's timers.
        if not self._lock.acquire(blocking=False):
            FlushScheduler.shared().schedule(
                time.monotonic() + max(self._flush_ms, 5.0) / 1e3,
                self._timer_fire)
            return
        try:
            if self._sock is None or not self._buf:
                self._timer_armed = False
                return
            due = self._buf_t0 + self._flush_ms / 1e3
            if time.monotonic() + 1e-4 < due:
                # Size-flushed and refilled since arming: sleep on
                # towards the current buffer's deadline.
                FlushScheduler.shared().schedule(due, self._timer_fire)
                return
            self._timer_armed = False
            try:
                self._flush_locked("timeout")
            except (OSError, ConnectionError) as exc:
                # Off-thread failure: the next invoke() re-raises it on
                # the sink's own subtask.
                self._error = exc
        finally:
            self._lock.release()

    def _flush_locked(self, reason: str) -> None:
        buf = self._buf
        if not buf:
            return
        if (reason == "timeout" and self._flush_ms > 0
                and self._fc_state == "on" and not self._fc_available()):
            # Zero credit on a deadline flush: keep coalescing instead
            # of parking the shared timer thread; the deadline re-arms
            # and fires again once the consumer grants.
            if not self._timer_armed:
                self._timer_armed = True
                FlushScheduler.shared().schedule(
                    time.monotonic() + self._flush_ms / 1e3,
                    self._timer_fire)
            return
        self._buf = []
        self._buf_bytes = 0
        t_first = self._buf_t0
        n = len(buf)
        t0 = time.monotonic()
        if n > 1 and self.columnar:
            sig = batch_signature(buf[0])
            homogeneous = sig is not None and all(
                batch_signature(v) == sig for v in buf[1:])
        else:
            homogeneous = False
        if homogeneous:
            payload = encode_batch(buf, self._wire)
            parts = [_LEN.pack(len(payload)), payload]
        else:
            parts = []
            for v in buf:
                payload = encode_record(v, self._wire)
                parts.append(_LEN.pack(len(payload)))
                parts.append(payload)
        burst_bytes = sum(len(p) for p in parts)
        t1 = time.monotonic()
        self._send_burst(parts, fc="align" if reason == "close" else "data")
        t2 = time.monotonic()
        if self._flush_counters is not None:
            self._flush_counters[reason].inc()
            self._frame_records.record(n)
            self._frame_bytes.record(burst_bytes)
            self._flush_total.mark()
        tracer = self._tracer
        if tracer is not None:
            tracer.span(self._track, "wire.flush", t_first, t0,
                        args={"reason": reason, "records": n})
            tracer.span(self._track, "serde", t0, t1,
                        args={"bytes": burst_bytes, "records": n, "columnar": homogeneous})
            tracer.span(self._track, "wire", t1, t2, args={"bytes": burst_bytes})

    def _send_burst(self, parts, fc: str = "data") -> None:
        """One burst onto the wire (scatter-gather sendmsg, no
        concatenation copy), with the chaos hook, the credit gate, and
        the self-healing retry: a failed send reconnects with
        exponential backoff within ``reconnect_timeout_s`` and resends
        the whole burst — the peer RemoteSource keeps the fan-in slot
        open for the replacement connection (see its reconnect grace)."""
        try:
            if self._fault_hook is not None and self._fault_hook() == "drop":
                # Injected blackhole: the burst vanishes.  Checked
                # BEFORE the credit spend — the receiver never sees a
                # dropped burst, so a spent credit could never be
                # replenished (a slow leak of the window under chaos).
                return
            self._fc_acquire(fc)
            _sendall_parts(self._sock, parts)
            if self._san is not None:
                self._san.hb("frame.send", self._hb_edge, fc=fc,
                             nbytes=sum(len(p) for p in parts))
            return
        except (OSError, ConnectionError):
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
            if self.reconnect_timeout_s <= 0:
                raise
        deadline = time.monotonic() + self.reconnect_timeout_s
        backoff = 0.05
        attempt = 0
        while True:
            attempt += 1
            time.sleep(min(backoff, max(0.0, deadline - time.monotonic())))
            backoff = min(backoff * 2.0, 1.0)
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise ConnectionError(
                    f"RemoteSink to {self.host}:{self.port}: send failed and "
                    f"reconnect did not succeed within "
                    f"{self.reconnect_timeout_s}s")
            try:
                self._sock = connect_with_retry(
                    self.host, self.port, max(0.05, remaining))
                self._reset_after_reconnect()
                self._fc_acquire(fc)
                _sendall_parts(self._sock, parts)
                if self._san is not None:
                    self._san.hb("frame.send", self._hb_edge, fc=fc,
                                 nbytes=sum(len(p) for p in parts),
                                 resend=True)
            except (OSError, ConnectionError, TimeoutError):
                if self._sock is not None:
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                    self._sock = None
                continue
            if self._reconnects is not None:
                self._reconnects.inc()
            if self._edge_reconnects is not None:
                self._edge_reconnects.mark()
            if self._resends is not None:
                self._resends.inc()
            self._resent_total += 1
            logger.warning(
                "RemoteSink to %s:%d re-established after %d attempt(s); "
                "in-flight burst resent", self.host, self.port, attempt)
            return

    def _reset_after_reconnect(self) -> None:
        """Fresh connection, fresh per-edge state.

        Credits: grants from the dead socket died with it and the
        replacement fan-in slot re-grants a full window, so the local
        count restarts from the new hello (stale grants can never be
        spent against the new connection).

        Coalescing attribution: the buffer-age stamp is reset so the
        resent burst's outage time is not billed to the NEXT buffer's
        `wire.flush` span, and the resend itself is booked on the
        `resent_bursts` counter only — the wire_flush_* reason counters
        tick once per logical flush, keeping
        wire_flush_total == size + timeout + close across reconnects.
        """
        if self._fc_state != "off":
            self._fc_hello()
        self._buf_t0 = time.monotonic()

    def close(self) -> None:
        # Under the lock: a deadline flush on the timer thread may be in
        # the middle of a reconnect (the socket None until it lands).  The
        # reference looks at the socket first, so a close racing that
        # reconnect skips the flush and the end-of-stream marker, and the
        # peer waits for it forever.
        with self._lock:
            if self._sock is None:
                return
            try:
                self._flush_locked("close")
            except (OSError, ConnectionError):
                pass  # peer already gone; nothing left to preserve
            sock, self._sock = self._sock, None
            if sock is None:
                return  # the close flush's reconnect failed
            try:
                # End-of-stream marker (a zero-length frame): the peer
                # RemoteSource counts this peer done only after seeing it;
                # a bare FIN is an unclean drop, eligible for a reconnect.
                sock.sendall(_LEN.pack(0))
            except OSError:
                pass
            try:
                sock.shutdown(socket.SHUT_WR)
            except OSError:
                pass
            _drain_until_peer_closes(sock, _CLOSE_DRAIN_S)
            sock.close()


def _drain_until_peer_closes(sock: socket.socket, timeout_s: float) -> None:
    """Read and discard until the peer closes (or ``timeout_s`` passes),
    so the close that follows sends a FIN and not a reset."""
    deadline = time.monotonic() + timeout_s
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return
        try:
            readable, _, _ = select.select([sock], [], [], remaining)
            if not readable or not sock.recv(1 << 16):
                return
        except (OSError, ValueError):
            return


class RemoteSource(fn.SourceFunction):
    """Accepts ``fan_in`` RemoteSink connections and yields their records.

    Bind with port=0 to pick a free port; read it from :attr:`port`
    after construction (the listener opens eagerly so peers can connect
    before the job starts).

    ``fan_in>=1`` peers multiplex over ONE ``selectors`` event loop
    running inside the source generator itself — no reader threads, no
    hand-off queue.  Records interleave in arrival order (no ordering
    across peers, exactly like Flink's network shuffle fan-in) and the
    source finishes when ALL peers have closed cleanly.  A truncated
    peer stream fails the source loudly.  Backpressure is inherent: the
    loop only reads more bytes once the pipeline consumed the decoded
    records, so a slow job closes the kernel TCP windows.
    """

    #: A TCP stream cannot be rewound to a checkpoint offset, so a job
    #: that replays after a failure re-reads nothing from this source:
    #: delivery through it is at-least-once unless a durable log fronts it.
    replayable = False

    def __init__(self, bind: str = "0.0.0.0", port: int = 0,
                 *, fan_in: int = 1, accept_timeout_s: float = 60.0,
                 queue_capacity: int = 1024,
                 reconnect_grace_s: float = 5.0):
        if fan_in < 1:
            raise ValueError(f"fan_in must be >= 1, got {fan_in}")
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((bind, port))
        self._listener.listen(fan_in)
        self.port = self._listener.getsockname()[1]
        self.fan_in = fan_in
        self.accept_timeout_s = accept_timeout_s
        #: Self-healing fan-in: a peer that drops WITHOUT the
        #: end-of-stream marker (reset, sink-side sever, truncated
        #: frame) frees its slot and the source waits this long for the
        #: peer to reconnect (RemoteSink resends its in-flight burst on
        #: the replacement connection) before failing loudly.  0
        #: restores fail-fast.
        self.reconnect_grace_s = reconnect_grace_s
        #: Retained for API compatibility; the threadless loop needs no
        #: hand-off queue (its backlog is the per-connection parser).
        self.queue_capacity = queue_capacity
        self._tracer = None
        self._track = ""
        self._san = None
        self._hb_edge = ""
        self._credit_grants = None
        self._wire_latency = None
        self._wire_latency_err = 0.0

    def clone(self):
        return self  # the listener is the identity; parallelism must be 1

    def open(self, ctx) -> None:
        self._tracer = getattr(ctx, "tracer", None)
        self._track = f"{ctx.task_name}.{ctx.subtask_index}"
        # Directional receive-side edge name; deliberately distinct from
        # any sender's edge so the cohort stitcher never pairs the
        # conn-less pipe (see RemoteSink.open).
        self._san = getattr(ctx, "sanitizer", None)
        self._hb_edge = f"remote:{self.port}->{self._track}"
        if ctx.metrics is not None:
            self._credit_grants = ctx.metrics.counter("credit_grants")
            # One-way wire latency per frame, mapped into this clock by
            # the cohort's offsets, with the estimate's error bound.
            self._wire_latency = ctx.metrics.histogram("edge.wire_latency_s")
            ctx.metrics.gauge("edge.wire_latency_err_s", lambda: self._wire_latency_err)
        if ctx.parallelism != 1:
            raise RuntimeError(
                "RemoteSource owns one listener — run it with "
                f"parallelism=1 (got {ctx.parallelism}); scale ingest by "
                "raising fan_in instead"
            )

    def _record_wire_latency(self, record, t_recv: float) -> None:
        """One-way send-to-receive latency of a frame, read off its first
        record's ``__trace__`` stamp (peeked: the source still admits the
        trace), once the clock sync knows the origin's offset."""
        hist = self._wire_latency
        tracer = self._tracer
        if hist is None or tracer is None:
            return
        meta = getattr(record, "meta", None)
        stamp = meta.get("__trace__") if meta else None
        if type(stamp) is not tuple:
            return
        _trace_id, origin, t_send = stamp
        off = tracer.clock_offsets.get(origin)
        if off is None or not t_send:
            return
        hist.record(max(0.0, t_recv - (t_send + off)))
        self._wire_latency_err = tracer.clock_error.get(origin, 0.0)

    def run(self) -> typing.Iterator[typing.Any]:
        """Yields records; yields SOURCE_IDLE while waiting (accepting or
        between frames) so the source loop can serve checkpoint barriers
        — a source blocked in recv() would otherwise stall coordinator-
        triggered checkpoints for the whole job."""
        sel = selectors.DefaultSelector()
        self._listener.setblocking(False)
        sel.register(self._listener, selectors.EVENT_READ, None)
        parsers: typing.Dict[socket.socket, LengthPrefixedParser] = {}
        #: Peers whose end-of-stream marker arrived: their EOF is clean
        #: completion; any other drop is reconnect-eligible.
        eos: typing.Set[socket.socket] = set()
        ready: typing.Deque[TensorValue] = collections.deque()
        started = closed = 0      # first-time accepts / completed peers
        lost = 0                  # unclean drops awaiting reconnect
        lost_deadline = 0.0
        deadline = time.monotonic() + self.accept_timeout_s
        # Credit plane (module _FC_MAGIC docs): peers that sent the FC
        # hello, the data frames consumed from each since the last
        # grant, and grant bytes awaiting a writable socket.  Grants
        # are queued only AFTER the frame's records were yielded — the
        # pipeline demonstrably consumed them — so a stalled consumer
        # stops the grant stream and parks the sender within one
        # credit window.
        window = credit_window(self.queue_capacity)
        fc_conns: typing.Set[socket.socket] = set()
        unacked: typing.Dict[socket.socket, int] = {}
        grant_out: typing.Dict[socket.socket, bytearray] = {}
        grants_counter = self._credit_grants

        san = self._san
        tracer = self._tracer

        def queue_grant(conn: socket.socket, n: int) -> None:
            grant_out.setdefault(conn, bytearray()).extend(_GRANT.pack(n))
            if grants_counter is not None:
                grants_counter.inc(n)
            if san is not None:
                san.hb("credit.grant", self._hb_edge, n=n)

        def flush_grants() -> None:
            for c in list(grant_out):
                buf = grant_out[c]
                if c not in parsers or not buf:
                    del grant_out[c]
                    continue
                try:
                    sent = c.send(bytes(buf))
                except (BlockingIOError, InterruptedError):
                    continue
                except OSError:
                    # Peer gone; its reconnect re-grants a full window.
                    del grant_out[c]
                    continue
                del buf[:sent]
                if not buf:
                    del grant_out[c]

        def drop_unclean(conn: socket.socket, why: str):
            nonlocal lost, lost_deadline
            sel.unregister(conn)
            try:
                conn.close()
            except OSError:
                pass
            del parsers[conn]
            eos.discard(conn)
            fc_conns.discard(conn)
            unacked.pop(conn, None)
            grant_out.pop(conn, None)
            if self.reconnect_grace_s <= 0:
                raise ConnectionError(
                    f"remote peer dropped uncleanly ({why}) and "
                    "reconnect_grace_s=0")
            lost += 1
            lost_deadline = time.monotonic() + self.reconnect_grace_s
            logger.warning(
                "remote peer dropped uncleanly (%s); holding its fan-in "
                "slot %.1fs for a reconnect", why, self.reconnect_grace_s)

        try:
            while closed < self.fan_in:
                # Drain decoded records FIRST: reading more while the
                # pipeline lags would just buffer unboundedly.
                while ready:
                    yield ready.popleft()
                # Everything decoded so far has been consumed by the
                # pipeline — NOW replenish the senders' credits.
                if unacked:
                    for c, n in unacked.items():
                        if c in parsers:
                            queue_grant(c, n)
                    unacked.clear()
                if grant_out:
                    flush_grants()
                now = time.monotonic()
                if started < self.fan_in and now > deadline:
                    raise TimeoutError(
                        f"RemoteSource accepted {started}/{self.fan_in} "
                        f"peers within {self.accept_timeout_s}s"
                    )
                if lost > 0 and now > lost_deadline:
                    raise ConnectionError(
                        f"{lost} remote peer(s) dropped uncleanly and did "
                        f"not reconnect within {self.reconnect_grace_s}s "
                        "(records in the dead connection's kernel buffer "
                        "are lost — TCP sources are at-least-once)"
                    )
                events = sel.select(timeout=0.1)
                if not events:
                    yield SOURCE_IDLE
                    continue
                for key, _ in events:
                    if key.fileobj is self._listener:
                        if started >= self.fan_in and lost <= 0:
                            continue
                        try:
                            conn, _addr = self._listener.accept()
                        except (BlockingIOError, OSError):
                            continue
                        conn.setblocking(False)
                        parsers[conn] = LengthPrefixedParser()
                        sel.register(conn, selectors.EVENT_READ, None)
                        if lost > 0:
                            # A dropped peer came back: the sink resends
                            # its in-flight burst on this connection.
                            lost -= 1
                            logger.info(
                                "remote peer reconnected; %d still lost",
                                lost)
                        else:
                            started += 1
                        continue
                    conn = typing.cast(socket.socket, key.fileobj)
                    parser = parsers[conn]
                    try:
                        chunk = conn.recv(1 << 20)
                    except (BlockingIOError, InterruptedError):
                        continue
                    except OSError as exc:
                        drop_unclean(conn, f"recv failed: {exc!r}")
                        continue
                    if not chunk:
                        if parser.buffered:
                            drop_unclean(conn, "closed mid-frame")
                            continue
                        if conn not in eos:
                            drop_unclean(conn, "closed without end-of-"
                                               "stream marker")
                            continue
                        sel.unregister(conn)
                        conn.close()
                        del parsers[conn]
                        eos.discard(conn)
                        fc_conns.discard(conn)
                        unacked.pop(conn, None)
                        grant_out.pop(conn, None)
                        continue
                    for payload, length in parser.feed(chunk):
                        if length == 0:
                            # End-of-stream marker: this peer is DONE —
                            # only now does its slot count completed.
                            eos.add(conn)
                            closed += 1
                            continue
                        if (length == len(_FC_MAGIC)
                                and payload == _FC_MAGIC):
                            # Credit handshake: grant the initial
                            # window (re-granted whole on reconnect —
                            # the dead socket's credits died with it).
                            fc_conns.add(conn)
                            queue_grant(conn, window)
                            continue
                        if conn in fc_conns:
                            # One credit per data frame, owed back once
                            # its records are yielded downstream.
                            unacked[conn] = unacked.get(conn, 0) + 1
                        if san is not None:
                            san.hb("frame.recv", self._hb_edge,
                                   nbytes=length)
                        if tracer is None:
                            ready.extend(decode_frame(payload))
                        else:
                            t0 = time.monotonic()
                            records = decode_frame(payload)
                            tracer.span(self._track, "serde", t0, time.monotonic(),
                                        args={"bytes": length, "records": len(records)})
                            if records:
                                self._record_wire_latency(records[0], t0)
                            ready.extend(records)
            while ready:
                yield ready.popleft()
        finally:
            for conn in parsers:
                try:
                    conn.close()
                except OSError:
                    pass
            sel.close()

    def close(self) -> None:
        self._listener.close()
