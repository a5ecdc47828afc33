"""Host-side record channels between operator subtasks.

Port of ``flink_tensorflow_tpu/core/channels.py`` (``InputGate``
``:39-312``, ``ChannelWriter`` ``:333``).  Each downstream subtask owns
one gate merging the channels of all its upstream subtasks into one
bounded queue: a full queue blocks the writer (backpressure), an empty
one blocks the reader on a condition variable until a put, a
:meth:`InputGate.wake` or a close.  Barrier alignment happens here: a
channel whose barrier arrived is blocked, its later elements are stashed
and replayed in order once the checkpoint is taken (Flink's aligned
exactly-once protocol).  Only host objects cross a channel; tensors reach
the device as batches inside the model operators.

The record plane's receive side (``core/shuffle.py``) feeds a gate from
the reactor thread, which must never block: :meth:`InputGate.try_put_batch`
takes what fits, a space listener resumes the paused connection when the
queue leaves the full state, and a drain listener replenishes the
sender's credits once the consumer pulls the queue below its low-water
mark (JAX ``:101-115``, ``:162-220``).  A remote channel blocked for
alignment takes nothing: its frames stay parked in the connection's route
(Flink's credit-based alignment, and what the reference's route says it
does) until :meth:`InputGate.unblock_all` fires the space listeners.  The
reference's gate takes them and stashes them, so its route logs
deliveries into a blocked channel, which its own stitcher reports as
``dist-barrier-blocked-channel`` on a healthy cohort.

With a sanitizer (``core/sanitizer_rt.py``, JAX ``:50-77``, ``:250-294``)
the gate's lock and condition variables are instrumented and every
delivery is checked against the alignment state: an element handed out
from a blocked channel is a violation.  Without one the gate keeps plain
``threading`` primitives and pays one ``is None`` test per delivery.

For the metric plane (JAX ``:84-90``) a gate keeps the deepest queue seen
at a put (``high_watermark``) and the seconds writers spent blocked on a
full queue (``blocked_put_s``); :meth:`InputGate.put` returns the
writer's own blocked seconds, which the writing subtask books as its
backpressure time.
"""

from __future__ import annotations

import collections
import threading
import time
import typing

from flink_tensorflow_tpu_torch.core import elements as el


class InputGate:
    """Merged input of one subtask: N channels, one bounded queue, and
    barrier alignment (blocked channels, their stashes, the replay queue;
    these are touched by the single reader thread only)."""

    def __init__(self, num_channels: int, capacity: int = 1024, *,
                 sanitizer: typing.Optional[typing.Any] = None,
                 name: typing.Optional[str] = None):
        self.num_channels = num_channels
        self.capacity = capacity
        self._queue: typing.Deque[typing.Tuple[int, typing.Optional[el.StreamElement]]] = (
            collections.deque())
        self._stashed: typing.List[typing.Deque[typing.Tuple[int, el.StreamElement]]] = [
            collections.deque() for _ in range(num_channels)]
        self._replay: typing.Deque[typing.Tuple[int, el.StreamElement]] = collections.deque()
        self._blocked: typing.List[bool] = [False] * num_channels
        #: Elements put per channel (the runtime's per-edge queue gauges).
        self.puts_per_channel: typing.List[int] = [0] * num_channels
        #: Elements per channel buffered anywhere in the gate (queue,
        #: alignment stash, replay) until ``poll`` delivers them: the
        #: per-edge depth gauges the health plane's ``edge-queue`` rule
        #: reads.  Changed under the gate lock only.
        self.buffered_per_channel: typing.List[int] = [0] * num_channels
        #: Deepest queue occupancy seen at a put (a monotone maximum).
        self.high_watermark = 0
        #: Seconds writers spent blocked on a full queue.
        self.blocked_put_s = 0.0
        self._closed = False
        self._san = sanitizer
        self._san_name = name or f"gate@{id(self):x}"
        # One lock, two wait sets: the reader parks on ``_not_empty``,
        # writers on ``_not_full``.
        if sanitizer is not None:
            self._lock = sanitizer.lock(f"{self._san_name}.lock")
            self._not_empty = sanitizer.condition(f"{self._san_name}.not_empty", self._lock)
            self._not_full = sanitizer.condition(f"{self._san_name}.not_full", self._lock)
        else:
            self._lock = threading.Lock()
            self._not_empty = threading.Condition(self._lock)
            self._not_full = threading.Condition(self._lock)
        #: Wake sentinels in the queue (not counted by :attr:`depth`).
        self._wake_sentinels = 0
        #: Fired under the gate lock (so they must not block) on the full ->
        #: not-full transition and on close.
        self._space_listeners: typing.List[typing.Callable[[], None]] = []
        #: Fired under the gate lock when ``poll`` pulls the queue below
        #: the low-water mark, and on close.
        self._drain_listeners: typing.List[typing.Callable[[], None]] = []
        self._low_water = max(1, capacity // 2)

    def put(self, channel_idx: int, element: el.StreamElement) -> float:
        """Enqueue, waiting while the queue is full (backpressure); returns
        the seconds this put waited (0.0 on the uncontended path)."""
        with self._not_full:
            blocked = 0.0
            if len(self._queue) >= self.capacity and not self._closed:
                t0 = time.monotonic()
                while len(self._queue) >= self.capacity and not self._closed:
                    self._not_full.wait()
                blocked = time.monotonic() - t0
                self.blocked_put_s += blocked
            if self._closed:
                return blocked  # gate torn down (job cancelled): drop
            self._queue.append((channel_idx, element))
            self.puts_per_channel[channel_idx] += 1
            self.buffered_per_channel[channel_idx] += 1
            depth = len(self._queue)
            if depth > self.high_watermark:
                self.high_watermark = depth
            self._not_empty.notify()
            return blocked

    def try_put_batch(self, channel_idx: int,
                      elements: typing.Sequence[el.StreamElement],
                      on_put: typing.Optional[typing.Callable[[int], None]] = None) -> int:
        """Append as many of ``elements`` as the queue has room for, under
        one lock and one reader wakeup; returns how many were taken (the
        reactor offers the rest again once a space listener fires).  A
        channel blocked for alignment takes none.  A closed gate takes
        everything (dropped).  ``on_put(taken)`` runs under the lock, so
        what it logs is ordered with the alignment's block and unblock."""
        with self._not_full:
            if self._closed:
                return len(elements)
            room = self.capacity - len(self._queue)
            if room <= 0 or self._blocked[channel_idx]:
                return 0
            taken = min(room, len(elements))
            self._queue.extend((channel_idx, e) for e in elements[:taken])
            self.puts_per_channel[channel_idx] += taken
            self.buffered_per_channel[channel_idx] += taken
            depth = len(self._queue)
            if depth > self.high_watermark:
                self.high_watermark = depth
            if on_put is not None:
                on_put(taken)
            self._not_empty.notify()
            return taken

    def add_space_listener(self, fn: typing.Callable[[], None]) -> None:
        with self._lock:
            self._space_listeners.append(fn)

    def add_drain_listener(self, fn: typing.Callable[[], None]) -> None:
        with self._lock:
            self._drain_listeners.append(fn)

    @staticmethod
    def _notify(listeners) -> None:
        for fn in listeners:
            try:
                fn()
            except Exception:  # noqa: BLE001 - an observer never breaks the gate
                pass

    def wake(self) -> None:
        """Break a blocked :meth:`poll` now (the model runner's fetch thread
        calls this when results land).  No element is consumed."""
        with self._not_empty:
            self._queue.append((-1, None))
            self._wake_sentinels += 1
            self._not_empty.notify()

    def poll(self, timeout: typing.Optional[float] = None
             ) -> typing.Optional[typing.Tuple[int, el.StreamElement]]:
        """Next ``(channel, element)`` from a channel that is not blocked;
        None on timeout, wake, or a closed and empty gate.
        ``timeout=None`` waits for an event."""
        while self._replay:
            idx, element = self._replay.popleft()
            if self._blocked[idx]:
                self._stashed[idx].append((idx, element))
                continue
            with self._lock:
                self.buffered_per_channel[idx] -= 1
            if self._san is not None:
                self._san.gate_delivered(self._san_name, idx)
            return idx, element
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._not_empty:
                while not self._queue:
                    if self._closed:
                        return None
                    if deadline is None:
                        self._not_empty.wait()
                    else:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0 or not self._not_empty.wait(remaining):
                            if not self._queue:
                                return None
                idx, element = self._queue.popleft()
                self._not_full.notify()
                if self._space_listeners and len(self._queue) == self.capacity - 1:
                    self._notify(self._space_listeners)
                if self._drain_listeners and len(self._queue) == self._low_water - 1:
                    self._notify(self._drain_listeners)
                if idx < 0:
                    self._wake_sentinels -= 1
                elif not self._blocked[idx]:
                    # Delivered below (alignment state is this reader's own).
                    self.buffered_per_channel[idx] -= 1
            if idx < 0:
                return None  # wake() sentinel: hand control back now
            if self._blocked[idx]:
                self._stashed[idx].append((idx, element))
                continue
            if self._san is not None:
                self._san.gate_delivered(self._san_name, idx)
            return idx, element

    def block_channel(self, idx: int) -> None:
        """Hold ``idx``'s elements back until :meth:`unblock_all` (its
        barrier arrived; the others' have not)."""
        with self._lock:  # ordered with a remote route's try_put_batch
            self._blocked[idx] = True
            if self._san is not None:
                self._san.gate_channel_blocked(self._san_name, idx)

    def unblock_all(self) -> None:
        """Alignment done: stashed elements replay in channel order, and
        remote routes parked on a blocked channel resume."""
        with self._lock:
            self._blocked = [False] * self.num_channels
            if self._san is not None:
                self._san.gate_unblocked(self._san_name)
            self._notify(self._space_listeners)
        stashed = self._stashed
        self._stashed = [collections.deque() for _ in range(self.num_channels)]
        for dq in stashed:
            self._replay.extend(dq)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()
            # A paused connection must not stay parked on a gate nobody
            # drains again.
            self._notify(self._space_listeners)
            self._notify(self._drain_listeners)

    @property
    def depth(self) -> int:
        """Elements buffered (queue, stashes and replay; wake sentinels
        excluded)."""
        return max(0, len(self._queue) + len(self._replay)
                   + sum(len(d) for d in self._stashed) - self._wake_sentinels)

    def channel_depth(self, idx: int) -> int:
        """Elements of channel ``idx`` buffered in the gate."""
        return max(0, self.buffered_per_channel[idx])


class ChannelWriter:
    """Upstream handle to one channel of a downstream gate."""

    __slots__ = ("_gate", "_idx")

    def __init__(self, gate: InputGate, idx: int):
        self._gate = gate
        self._idx = idx

    def write(self, element: el.StreamElement) -> float:
        """Put ``element``; returns the seconds the put was blocked."""
        return self._gate.put(self._idx, element)
