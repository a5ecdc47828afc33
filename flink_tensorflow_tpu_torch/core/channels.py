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

    def __init__(self, num_channels: int, capacity: int = 1024):
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
        self._closed = False
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)

    def put(self, channel_idx: int, element: el.StreamElement) -> None:
        """Enqueue, waiting while the queue is full (backpressure)."""
        with self._not_full:
            while len(self._queue) >= self.capacity and not self._closed:
                self._not_full.wait()
            if self._closed:
                return  # gate torn down (job cancelled): drop
            self._queue.append((channel_idx, element))
            self.puts_per_channel[channel_idx] += 1
            self._not_empty.notify()

    def wake(self) -> None:
        """Break a blocked :meth:`poll` now (the model runner's fetch thread
        calls this when results land).  No element is consumed."""
        with self._not_empty:
            self._queue.append((-1, None))
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
            if idx < 0:
                return None  # wake() sentinel: hand control back now
            if self._blocked[idx]:
                self._stashed[idx].append((idx, element))
                continue
            return idx, element

    def block_channel(self, idx: int) -> None:
        """Hold ``idx``'s elements back until :meth:`unblock_all` (its
        barrier arrived; the others' have not)."""
        self._blocked[idx] = True

    def unblock_all(self) -> None:
        """Alignment done: stashed elements replay in channel order."""
        self._blocked = [False] * self.num_channels
        stashed = self._stashed
        self._stashed = [collections.deque() for _ in range(self.num_channels)]
        for dq in stashed:
            self._replay.extend(dq)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()


class ChannelWriter:
    """Upstream handle to one channel of a downstream gate."""

    __slots__ = ("_gate", "_idx")

    def __init__(self, gate: InputGate, idx: int):
        self._gate = gate
        self._idx = idx

    def write(self, element: el.StreamElement) -> None:
        self._gate.put(self._idx, element)
