"""Single-threaded socket reactor — the record plane's event loop.

Copy of ``flink_tensorflow_tpu/core/reactor.py``.  Flink runs its
shuffle over a small pool of Netty event loops; here one thread per
process multiplexes every record-plane socket:

- :class:`Reactor` — one ``selectors`` thread (epoll on Linux) with a
  self-pipe for wakeups from other threads and a task queue for interest
  changes (the selector is not thread-safe), plus periodic pollers (the
  shm rings' liveness backstop).
- :class:`Connection` — one non-blocking socket: an incremental frame
  **parser** feeds a per-connection receive state machine, and a bounded
  **send queue** drains on ``EVENT_WRITE``.  ``on_message`` returning
  ``False`` PAUSES the connection (a full input gate stops the read, the
  kernel's TCP window fills, the sender blocks); :meth:`Connection.resume`
  re-arms it when the gate frees space.
- :class:`FlushScheduler` — one process-wide deadline timer for the
  coalescing writers' buffer timeout.

Two framings: the shuffle's pickle frames (:class:`ShuffleFrameParser`)
and length-prefixed frames (:class:`LengthPrefixedParser`).  Both hand
payload buffers out as ``bytearray``, so numpy arrays decoded over them
are writable.
"""

from __future__ import annotations

import collections
import heapq
import itertools
import logging
import pickle
import selectors
import socket
import struct
import threading
import time
import typing

logger = logging.getLogger(__name__)

_FRAME_HDR = struct.Struct("<IH")  # pickle byte length, out-of-band buffer count
_BUF_HDR = struct.Struct("<Q")
_LEN_HDR = struct.Struct("<Q")
_MAX_FRAME = 1 << 30


class ShuffleFrameParser:
    """Incremental parser for the shuffle framing:
    ``[u32 pickle_len][u16 nbuf][pickle][per buffer: u64 len + bytes]``.

    ``feed`` returns complete ``(object, payload_bytes)`` tuples;
    partial frames stay buffered.  Out-of-band pickle buffers are
    materialized as ``bytearray`` so reconstructed numpy arrays are
    writable (the mutable-buffer guarantee of the old reader threads).
    """

    __slots__ = ("_buf",)

    def __init__(self) -> None:
        self._buf = bytearray()

    @property
    def buffered(self) -> bool:
        """True when EOF here would be MID-FRAME (stream truncated)."""
        return bool(self._buf)

    def feed(self, chunk: bytes) -> typing.List[typing.Tuple[typing.Any, int]]:
        self._buf += chunk
        out: typing.List[typing.Tuple[typing.Any, int]] = []
        while True:
            item = self._try_parse()
            if item is None:
                return out
            out.append(item)

    def _try_parse(self):
        buf = self._buf
        if len(buf) < _FRAME_HDR.size:
            return None
        plen, nbuf = _FRAME_HDR.unpack_from(buf, 0)
        if plen > _MAX_FRAME:
            raise ConnectionError(f"oversized frame ({plen} bytes)")
        off = _FRAME_HDR.size + plen
        spans = []
        total = plen
        for _ in range(nbuf):
            if len(buf) < off + _BUF_HDR.size:
                return None
            (blen,) = _BUF_HDR.unpack_from(buf, off)
            if blen > _MAX_FRAME:
                raise ConnectionError(f"oversized buffer ({blen} bytes)")
            off += _BUF_HDR.size
            if len(buf) < off + blen:
                return None
            spans.append((off, blen))
            off += blen
            total += blen
        if len(buf) < off:
            return None
        view = memoryview(buf)
        data = bytes(view[_FRAME_HDR.size:_FRAME_HDR.size + plen])
        # bytearray slices: writable standalone buffers for the arrays.
        buffers = [bytearray(view[s:s + ln]) for s, ln in spans]
        view.release()
        del self._buf[:off]
        obj = pickle.loads(data, buffers=buffers)
        return obj, total


class LengthPrefixedParser:
    """Incremental parser for ``[u64 len][payload]`` frames (io/remote's
    serde framing).  ``feed`` yields ``(bytearray_payload, nbytes)`` —
    the payload is a WRITABLE standalone buffer."""

    __slots__ = ("_buf",)

    def __init__(self) -> None:
        self._buf = bytearray()

    @property
    def buffered(self) -> bool:
        return bool(self._buf)

    def feed(self, chunk: bytes) -> typing.List[typing.Tuple[bytearray, int]]:
        self._buf += chunk
        out: typing.List[typing.Tuple[bytearray, int]] = []
        while True:
            buf = self._buf
            if len(buf) < _LEN_HDR.size:
                return out
            (length,) = _LEN_HDR.unpack_from(buf, 0)
            if length > _MAX_FRAME:
                raise ConnectionError(f"oversized frame ({length} bytes)")
            end = _LEN_HDR.size + length
            if len(buf) < end:
                return out
            payload = bytearray(memoryview(buf)[_LEN_HDR.size:end])
            del self._buf[:end]
            out.append((payload, length))


class Connection:
    """One non-blocking socket on a reactor: parser-driven receive state
    machine + bounded writer-side send queue.

    Receive: ``on_message(msg) -> bool`` is called per parsed frame;
    ``False`` pauses the connection (read interest dropped — the
    backpressure signal).  :meth:`resume` re-arms it; ``on_resume() ->
    bool`` (when given) first drains the handler's own partial backlog.

    Send: :meth:`send` appends to the queue from ANY thread and returns
    once the queue is below ``send_limit`` bytes (bounded memory: a slow
    peer backpressures the sender exactly like the old blocking
    ``sendall``, but the actual socket writes happen on the reactor).
    """

    def __init__(self, reactor: "Reactor", sock: socket.socket, *,
                 parser: typing.Optional[typing.Any] = None,
                 on_message: typing.Optional[typing.Callable[[typing.Any], bool]] = None,
                 on_resume: typing.Optional[typing.Callable[[], bool]] = None,
                 on_eof: typing.Optional[typing.Callable[[bool], None]] = None,
                 on_error: typing.Optional[typing.Callable[[BaseException], None]] = None,
                 send_limit: int = 8 << 20):
        sock.setblocking(False)
        self.sock = sock
        self.reactor = reactor
        self.parser = parser
        self.on_message = on_message
        self.on_resume = on_resume
        self.on_eof = on_eof
        self.on_error = on_error
        self.send_limit = send_limit
        self._undelivered: typing.Deque[typing.Any] = collections.deque()
        self._paused = False
        self._want_read = parser is not None
        self._out: typing.Deque[memoryview] = collections.deque()
        self._out_bytes = 0
        self._peak_out_bytes = 0
        self._send_cv = threading.Condition()
        self._closed = False
        self._error: typing.Optional[BaseException] = None
        self._registered = False

    # -- registration (reactor thread only, via Reactor.submit) ---------
    def _register(self) -> None:
        if self._closed or self._registered:
            return
        self._registered = True
        self.reactor._sel.register(self.sock, self._interest_or_default(), self)

    def _interest_or_default(self) -> int:
        # selectors refuses events=0; an idle send-only connection still
        # registers for READ so peer resets/EOFs surface promptly.
        return self._interest() or selectors.EVENT_READ

    def _interest(self) -> int:
        ev = 0
        if self._want_read and not self._paused:
            ev |= selectors.EVENT_READ
        if self._out:
            ev |= selectors.EVENT_WRITE
        return ev

    def _update_interest(self) -> None:
        if self._closed or not self._registered:
            return
        try:
            self.reactor._sel.modify(self.sock, self._interest_or_default(), self)
        except (KeyError, ValueError, OSError):
            pass

    # -- event dispatch (reactor thread) --------------------------------
    def _handle(self, mask: int) -> None:
        if mask & selectors.EVENT_WRITE:
            self._do_send()
        if mask & selectors.EVENT_READ and self._want_read and not self._closed:
            self._do_recv()
        elif mask & selectors.EVENT_READ and not self._want_read:
            # Send-only connection turned readable: peer closed or reset.
            self._probe_eof()

    def _probe_eof(self) -> None:
        try:
            chunk = self.sock.recv(4096)
        except (BlockingIOError, InterruptedError):
            return
        except OSError as exc:
            self._fail(exc)
            return
        if not chunk:
            self._eof()

    def _do_recv(self) -> None:
        while not self._closed and not self._paused:
            try:
                chunk = self.sock.recv(1 << 20)
            except (BlockingIOError, InterruptedError):
                return
            except OSError as exc:
                self._fail(exc)
                return
            if not chunk:
                self._eof()
                return
            try:
                msgs = self.parser.feed(chunk)
            except BaseException as exc:  # noqa: BLE001 — protocol error
                self._fail(exc)
                return
            self._undelivered.extend(msgs)
            if not self._deliver():
                return  # paused mid-backlog

    def _deliver(self) -> bool:
        while self._undelivered:
            msg = self._undelivered.popleft()
            try:
                ok = self.on_message(msg)
            except BaseException as exc:  # noqa: BLE001 — handler error
                self._fail(exc)
                return False
            if not ok:
                self._paused = True
                self._update_interest()
                return False
        return True

    def resume(self) -> None:
        """Re-arm a paused connection (any thread) — called when the
        downstream gate freed space."""
        self.reactor.submit(self._do_resume)

    def _do_resume(self) -> None:
        if self._closed or not self._paused:
            return
        if self.on_resume is not None:
            try:
                if not self.on_resume():
                    return  # handler's own backlog still blocked
            except BaseException as exc:  # noqa: BLE001
                self._fail(exc)
                return
        self._paused = False
        if self._deliver():
            self._update_interest()
            self._do_recv()  # drain bytes accrued while paused

    def _eof(self) -> None:
        clean = not (self.parser is not None and self.parser.buffered) \
            and not self._undelivered
        self._teardown()
        if self.on_eof is not None:
            try:
                self.on_eof(clean)
            except BaseException as exc:  # noqa: BLE001
                if self.on_error is not None:
                    self.on_error(exc)

    def _fail(self, exc: BaseException) -> None:
        already = self._closed
        self._teardown(error=exc)
        if not already and self.on_error is not None:
            self.on_error(exc)

    def _teardown(self, error: typing.Optional[BaseException] = None) -> None:
        with self._send_cv:
            self._closed = True
            if error is not None and self._error is None:
                self._error = error
            self._out.clear()
            self._out_bytes = 0
            self._send_cv.notify_all()
        if self._registered:
            self._registered = False
            try:
                self.reactor._sel.unregister(self.sock)
            except (KeyError, ValueError, OSError):
                pass
        try:
            self.sock.close()
        except OSError:
            pass

    # -- send path -------------------------------------------------------
    def send(self, parts: typing.Sequence[typing.Any], block: bool = True) -> None:
        """Queue ``parts`` (bytes-like, sent in order, never interleaved
        with other calls' parts because callers serialize per writer)
        and optionally block until the queue is under ``send_limit``."""
        with self._send_cv:
            if self._error is not None:
                raise self._error
            if self._closed:
                return
            for p in parts:
                mv = p if isinstance(p, memoryview) else memoryview(p)
                mv = mv.cast("B") if mv.format != "B" or mv.ndim != 1 else mv
                self._out.append(mv)
                self._out_bytes += mv.nbytes
            if self._out_bytes > self._peak_out_bytes:
                self._peak_out_bytes = self._out_bytes
        self.reactor.submit(self._update_interest)
        if not block:
            return
        with self._send_cv:
            while (self._out_bytes > self.send_limit and not self._closed
                   and self._error is None):
                # Timed re-check: a reactor that died mid-drain must not
                # strand the writer parked forever.
                self._send_cv.wait(0.1)
                if not self.reactor.alive:
                    raise ConnectionError("reactor stopped while send queue full")
            if self._error is not None:
                raise self._error

    def _do_send(self) -> None:
        while True:
            with self._send_cv:
                if not self._out:
                    break
                mv = self._out[0]
            try:
                n = self.sock.send(mv)
            except (BlockingIOError, InterruptedError):
                return
            except OSError as exc:
                self._fail(exc)
                return
            with self._send_cv:
                self._out_bytes -= n
                if n == len(mv):
                    if self._out and self._out[0] is mv:
                        self._out.popleft()
                else:
                    if self._out and self._out[0] is mv:
                        self._out[0] = mv[n:]
                self._send_cv.notify_all()
            if n < len(mv):
                return  # kernel buffer full; wait for the next EVENT_WRITE
        self._update_interest()

    @property
    def send_queue_depth(self) -> int:
        """Frames parked on the writer-side queue (reactor gauge)."""
        return len(self._out)

    @property
    def send_queue_bytes(self) -> int:
        """Bytes pending on the writer-side queue (reactor gauge)."""
        return self._out_bytes

    @property
    def peak_send_queue_bytes(self) -> int:
        """High-water mark of the writer-side queue over the
        connection's lifetime — the sender-side memory (RSS proxy) a
        slow peer cost at its worst.  The flow-control acceptance bound
        (queue stays ≤ credit window × frame size under a stalled
        consumer) and the overload bench read THIS, not the instant
        depth, so a transient between two polls can't hide growth."""
        return self._peak_out_bytes

    def drain(self, timeout: typing.Optional[float] = None) -> bool:
        """Wait for the send queue to empty; True when drained."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._send_cv:
            while self._out and not self._closed and self._error is None:
                remaining = (None if deadline is None
                             else max(0.0, deadline - time.monotonic()))
                if remaining == 0.0 or not self.reactor.alive:
                    return False
                self._send_cv.wait(0.1 if remaining is None
                                   else min(0.1, remaining))
            return not self._out

    def close(self, *, shut_wr: bool = True) -> None:
        """Flush-agnostic close from any thread (call :meth:`drain`
        first for a clean shutdown)."""
        def _do_close():
            if shut_wr and not self._closed:
                try:
                    self.sock.shutdown(socket.SHUT_WR)
                except OSError:
                    pass
            self._teardown()
        if self.reactor.alive:
            self.reactor.submit(_do_close)
        else:
            _do_close()

    @property
    def closed(self) -> bool:
        return self._closed


class _Acceptor:
    """Listener socket on the reactor: accepts and hands raw conns off."""

    def __init__(self, reactor: "Reactor", sock: socket.socket,
                 on_accept: typing.Callable[[socket.socket], None]):
        self.sock = sock
        self.reactor = reactor
        self.on_accept = on_accept

    def _handle(self, mask: int) -> None:
        while True:
            try:
                conn, _ = self.sock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return  # listener closed
            try:
                self.on_accept(conn)
            except BaseException:  # noqa: BLE001 — one bad conn, not the loop
                logger.exception("accept handler failed")
                try:
                    conn.close()
                except OSError:
                    pass


class Reactor:
    """One event-loop thread multiplexing every registered socket."""

    def __init__(self, name: str = "record-plane-reactor"):
        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, None)
        self._tasks: typing.Deque[typing.Callable[[], None]] = collections.deque()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        #: fn -> (interval_s, next_due): periodic callbacks on the loop
        #: thread.  Liveness backstops (e.g. the shm rings' parked-
        #: consumer poll), NOT a general timer — keep intervals >= 1 ms.
        self._pollers: typing.Dict[typing.Callable[[], None],
                                   typing.List[float]] = {}
        #: Event-loop lag observability (plain float stores on the loop
        #: thread — no locks, no metric objects; readers are pull-based
        #: gauges registered by ShuffleServer): how long the last
        #: select() wakeup spent dispatching its events + tasks, and the
        #: worst case seen.  A loop stuck behind one slow handler shows
        #: up here before it shows up as cohort-wide backpressure.
        self.poll_to_dispatch_s = 0.0
        self.max_poll_to_dispatch_s = 0.0
        self.dispatches = 0
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._started = False

    def start(self) -> None:
        with self._lock:
            if self._started:
                return
            self._started = True
        self._thread.start()

    @property
    def alive(self) -> bool:
        return self._started and not self._stop.is_set()

    def submit(self, fn: typing.Callable[[], None]) -> None:
        """Run ``fn`` on the reactor thread (interest changes and
        registration MUST go through here — selectors are not
        thread-safe)."""
        if threading.current_thread() is self._thread:
            fn()
            return
        with self._lock:
            self._tasks.append(fn)
        self.wake()

    def wake(self) -> None:
        try:
            self._wake_w.send(b"\x00")
        except (BlockingIOError, OSError):
            pass  # pipe full = wakeup already pending / reactor closed

    def add_acceptor(self, sock: socket.socket,
                     on_accept: typing.Callable[[socket.socket], None]) -> None:
        sock.setblocking(False)
        acceptor = _Acceptor(self, sock, on_accept)
        self.submit(lambda: self._sel.register(sock, selectors.EVENT_READ, acceptor))

    def add_connection(self, conn: Connection) -> None:
        self.submit(conn._register)

    def add_poller(self, fn: typing.Callable[[], None],
                   interval_s: float) -> None:
        """Run ``fn`` on the reactor thread roughly every ``interval_s``
        (idempotent per fn).  The loop's select() timeout shrinks to the
        earliest poller deadline; with no pollers it blocks forever (the
        zero-overhead default)."""
        with self._lock:
            self._pollers[fn] = [interval_s,
                                 time.monotonic() + interval_s]
        self.wake()

    def remove_poller(self, fn: typing.Callable[[], None]) -> None:
        with self._lock:
            self._pollers.pop(fn, None)

    def _poll_timeout(self) -> typing.Optional[float]:
        with self._lock:
            if not self._pollers:
                return None
            due = min(entry[1] for entry in self._pollers.values())
        return max(0.0, due - time.monotonic())

    def _run_due_pollers(self) -> None:
        now = time.monotonic()
        with self._lock:
            due = [(fn, entry) for fn, entry in self._pollers.items()
                   if entry[1] <= now]
        for fn, entry in due:
            entry[1] = now + entry[0]
            try:
                fn()
            except BaseException:  # noqa: BLE001 — loop must survive
                logger.exception("reactor poller failed")

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                events = self._sel.select(timeout=self._poll_timeout())
            except OSError:
                return  # selector closed under us (close())
            t_ready = time.monotonic()
            self._run_due_pollers()
            for key, mask in events:
                if key.data is None:  # wake pipe
                    try:
                        self._wake_r.recv(4096)
                    except (BlockingIOError, OSError):
                        pass
                    continue
                try:
                    key.data._handle(mask)
                except BaseException:  # noqa: BLE001 — loop must survive
                    logger.exception("reactor handler failed")
            while True:
                with self._lock:
                    if not self._tasks:
                        break
                    fn = self._tasks.popleft()
                try:
                    fn()
                except BaseException:  # noqa: BLE001
                    logger.exception("reactor task failed")
            if events:
                # Poll-to-dispatch lag: socket-ready -> all handlers and
                # queued tasks served.  Every connection on the loop
                # waits at least this long behind its peers' handlers.
                lag = time.monotonic() - t_ready
                self.poll_to_dispatch_s = lag
                if lag > self.max_poll_to_dispatch_s:
                    self.max_poll_to_dispatch_s = lag
                self.dispatches += 1

    def close(self, join: bool = True) -> None:
        self._stop.set()
        self.wake()
        if join and self._started and \
                threading.current_thread() is not self._thread:
            self._thread.join(timeout=2.0)
        try:
            # A closed selector's get_map() is None (double-close: error
            # -path cancel followed by the join-path close).
            mapping = self._sel.get_map()
            for key in list(mapping.values()) if mapping is not None else ():
                try:
                    key.fileobj.close()
                except OSError:
                    pass
            self._sel.close()
        except (OSError, RuntimeError):
            pass
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass


class FlushScheduler:
    """Process-wide one-shot deadline timer (the buffer-timeout clock).

    EVERY coalescing writer in the process shares this single daemon —
    Flink runs one output flusher per task, not per channel; one per
    process is even leaner and the callbacks are sub-microsecond checks.
    Callbacks run on the scheduler thread and must be quick or delegate
    (a callback blocked on a full peer delays later flushes — the same
    global backpressure blocking ``sendall`` produced, made explicit).
    """

    _instance: typing.Optional["FlushScheduler"] = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self._heap: typing.List[typing.Tuple[float, int, typing.Callable[[], None]]] = []
        self._cv = threading.Condition()
        self._seq = itertools.count()
        self._thread: typing.Optional[threading.Thread] = None

    @classmethod
    def shared(cls) -> "FlushScheduler":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def schedule(self, deadline: float, fn: typing.Callable[[], None]) -> None:
        """Call ``fn()`` once at monotonic time ``deadline``."""
        with self._cv:
            # Wake the timer thread ONLY when this deadline is earlier
            # than what it is already sleeping towards — a later deadline
            # is reached by the existing wait, and the notify would just
            # bounce the GIL between the hot write path and the timer
            # (measured: ~0.15 ms per superfluous wake at 1k flushes/s).
            need_wake = not self._heap or deadline < self._heap[0][0]
            heapq.heappush(self._heap, (deadline, next(self._seq), fn))
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="wire-flush-timer", daemon=True)
                self._thread.start()
            elif need_wake:
                self._cv.notify()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._heap:
                    self._cv.wait()
                deadline, _, fn = self._heap[0]
                now = time.monotonic()
                if now < deadline:
                    self._cv.wait(deadline - now)
                    continue
                heapq.heappop(self._heap)
            try:
                fn()
            except BaseException:  # noqa: BLE001 — the clock must survive
                logger.exception("scheduled flush failed")
