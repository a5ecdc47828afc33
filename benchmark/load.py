"""The benchmark's load: record pools made from the seed, and the closed
loop that feeds them to the job.

``ClosedSource`` keeps a fixed number of records outstanding (emitted,
their results not yet at the sink), as that many clients each waiting
for a reply would, so the load does not depend on how deep the program's
own queues are.  It emits whole windows: it waits, at each multiple of
the job's window, until the results of a whole window's records have
come back, so the source and the sink meet once a window and not once a
record.  It cycles a pool with fresh ids, stops on request at a whole
multiple of the window, and writes what it did into a shared ``Feed``
(sources are cloned per subtask).
"""

from __future__ import annotations

import threading
import typing

import numpy as np


def pool(seed: int, records: int, shape: typing.Sequence[int], salt: int) -> np.ndarray:
    """``[records, *shape]`` uint8 pixels from the seed, read-only."""
    rng = np.random.default_rng([int(seed), salt])
    size = int(records * np.prod(shape))
    pixels = np.frombuffer(rng.bytes(size), np.uint8).reshape((records, *shape))
    return pixels


class Feed:
    """What a source did, shared by its clones and read by the harness:
    records emitted, results returned, and the stop request."""

    def __init__(self):
        self.emitted = 0
        self.returned = 0
        self.returns = threading.Condition()
        #: The count of returned results the source waits for.
        self.need = 0
        self.stop = threading.Event()

    def back(self, n: int = 1) -> None:
        """``n`` more records' results reached the sink."""
        with self.returns:
            self.returned += n
            if self.returned >= self.need:
                self.returns.notify()


class ClosedSource:
    """Emits ``make(i)`` for i = 0, 1, ..., a whole window (``batch``
    records) at a time, never more than ``outstanding`` ahead of the
    results, until ``feed.stop`` is set and i is a multiple of
    ``batch``.  It keeps the framework's source protocol (``clone``,
    ``open``, ``close``, ``run``)."""

    def __init__(self, make: typing.Callable[[int], typing.Any], batch: int, feed: Feed,
                 outstanding: int):
        if outstanding < batch:
            raise ValueError("a closed loop keeps at least one window outstanding")
        self.make = make
        self.batch = batch
        self.feed = feed
        self.outstanding = outstanding

    def clone(self):
        return self   # one subtask; the feed is shared anyway

    def open(self, ctx) -> None:
        pass

    def close(self) -> None:
        pass

    def run(self):
        feed = self.feed
        i = 0
        while not (feed.stop.is_set() and i % self.batch == 0):
            if i % self.batch == 0:
                need = i + self.batch - self.outstanding
                with feed.returns:
                    feed.need = need
                    while feed.returned < need:
                        feed.returns.wait(0.1)
            yield self.make(i)
            i += 1
            feed.emitted = i
