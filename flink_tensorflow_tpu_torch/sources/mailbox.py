"""The wakeable source wait: one condition variable per split-source subtask.

Port of ``flink_tensorflow_tpu/sources/mailbox.py`` (``:33-107``).  The
legacy source loop blocks wherever the user's generator blocks, so a
checkpoint barrier or a chained operator's deadline waits for the next
yield.  The split-source loop owns all waiting instead: with nothing to do
now (no split assigned, the next record not due), it parks here until a
deadline and is woken early by whichever comes first:

- a checkpoint barrier request (``_Subtask.request_checkpoint``);
- a durable-checkpoint notification or an abort;
- a split becoming assignable (the coordinator thawing after an
  alignment, splits added back);
- an operator's background thread finishing work (``ctx.wakeup``, e.g. a
  model runner's fetch thread in the chain);
- the job's cancellation (``close``, which is sticky).

That wait is what lets the chaining pass fuse timer-driven operators
into split-source chains: the loop bounds each park by the chain's
earliest deadline.

With a sanitizer (``core/sanitizer_rt.py``) the condition variable is
instrumented, so a stranded waiter shows in the stall watchdog's dump
under the mailbox's name (JAX ``:51-61``).
"""

from __future__ import annotations

import threading
import typing


class SourceMailbox:
    """The event signal of one split-source subtask thread.

    A ``notify`` posted while the loop is busy, between two waits, is kept
    (a count, not a bare event), so a barrier posted in that window is not
    left until some later wakeup: ``wait`` takes pending signals first and
    only then parks.

    Shutdown is a separate, sticky signal: after ``close()`` every current
    and later ``wait`` returns at once.  ``close`` and ``notify`` are
    idempotent and safe from any thread in any order."""

    __slots__ = ("_cond", "_signals", "_closed")

    def __init__(self, *, sanitizer: typing.Optional[typing.Any] = None,
                 name: typing.Optional[str] = None) -> None:
        if sanitizer is not None:
            self._cond = sanitizer.condition(name or f"mailbox@{id(self):x}")
        else:
            self._cond = threading.Condition()
        self._signals = 0
        self._closed = False

    def notify(self) -> None:
        """Post an event: wake the parked loop, or let its next ``wait``
        return at once.  A no-op after ``close``."""
        with self._cond:
            if self._closed:
                return
            self._signals += 1
            self._cond.notify()

    def close(self) -> None:
        """Shut the mailbox: every current and later ``wait`` returns True
        at once, so the loop checks its cancellation flag."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed

    def wait(self, timeout: typing.Optional[float]) -> bool:
        """Park until a ``notify`` / ``close`` or ``timeout`` seconds (None:
        until signalled).  True when signalled (or closed), False on
        timeout.  One wait takes every pending signal: the loop looks at
        every event source on each turn anyway."""
        with self._cond:
            if self._closed:
                return True
            if self._signals:
                self._signals = 0
                return True
            if timeout is not None and timeout <= 0:
                return False
            notified = self._cond.wait(timeout)
            self._signals = 0
            return notified or self._closed
