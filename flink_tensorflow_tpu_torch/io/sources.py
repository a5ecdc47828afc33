"""Built-in sources.

Port of ``flink_tensorflow_tpu/io/sources.py`` (``:17-170``):
``CollectionSource``, ``GeneratorSource``, ``ThrottledSource`` and the
open-loop ``PacedSource``.  Every source here replays: the source
operator snapshots an offset per subtask and skips that many records on
restore (``PacedSource`` repositions with ``seek`` instead of sleeping
through them).  Not ported: the split sources of ``sources/`` (they
belong to the distributed record plane).
"""

from __future__ import annotations

import copy
import time
import typing

import numpy as np

from flink_tensorflow_tpu_torch.core import functions as fn
from flink_tensorflow_tpu_torch.core.elements import SOURCE_IDLE


class CollectionSource(fn.SourceFunction):
    """Bounded source over an in-memory sequence.

    With parallelism N, subtask i emits elements i, i+N, i+2N, ... so the
    collection is emitted exactly once across the source's subtasks.
    """

    def __init__(self, data: typing.Sequence[typing.Any]):
        self.data = data
        self._subtask = 0
        self._parallelism = 1

    def clone(self):
        c = CollectionSource(self.data)  # share the (read-only) data
        c._subtask = self._subtask
        c._parallelism = self._parallelism
        return c

    def open(self, ctx):
        self._subtask = ctx.subtask_index
        self._parallelism = ctx.parallelism

    def run(self):
        for i in range(self._subtask, len(self.data), self._parallelism):
            yield self.data[i]


class GeneratorSource(fn.SourceFunction):
    """Source from a factory of iterators, called once per subtask with
    ``(subtask_index, parallelism)``; it must be deterministic for a
    replay to be exactly-once."""

    def __init__(self, factory: typing.Callable[[int, int], typing.Iterator[typing.Any]]):
        self.factory = factory
        self._subtask = 0
        self._parallelism = 1

    def clone(self):
        return copy.copy(self)

    def open(self, ctx):
        self._subtask = ctx.subtask_index
        self._parallelism = ctx.parallelism

    def run(self):
        return iter(self.factory(self._subtask, self._parallelism))


class ThrottledSource(fn.SourceFunction):
    """Another source with a sleep of ``delay_s`` before each record."""

    def __init__(self, inner: fn.SourceFunction, delay_s: float):
        self.inner = inner
        self.delay_s = delay_s

    def clone(self):
        dup = copy.copy(self)
        dup.inner = self.inner.clone()
        return dup

    def open(self, ctx):
        self.inner.open(ctx)

    def close(self):
        self.inner.close()

    def run(self):
        for value in self.inner.run():
            time.sleep(self.delay_s)
            yield value


class PacedSource(fn.SourceFunction):
    """Open-loop arrivals: record i is due at ``t_start + start_delay_s +
    offset[i]`` however the pipeline is doing, and a ``TensorValue``
    leaves with that scheduled time (``time.monotonic()`` clock) in
    ``meta[ts_key]``.  A sink measures latency from it, so a source that
    falls behind shows its backlog as latency (no coordinated omission).

    ``jitter="poisson"`` draws exponential gaps from
    ``RandomState(seed)`` at ``rate_hz`` (the same schedule on every
    replay); ``"none"`` is a fixed rate.  While it waits the source sleeps
    in slices of at most 0.1 s and yields ``SOURCE_IDLE`` between them, so
    the source loop serves checkpoint barriers in a sparse schedule."""

    def __init__(self, data: typing.Sequence[typing.Any], rate_hz: float, *,
                 jitter: str = "poisson", seed: int = 0, ts_key: str = "sched_ts",
                 start_delay_s: float = 0.0):
        if rate_hz <= 0:
            raise ValueError("rate_hz must be > 0")
        if jitter not in ("poisson", "none"):
            raise ValueError(f"unknown jitter {jitter!r}")
        self.data = data
        self.rate_hz = rate_hz
        self.jitter = jitter
        self.seed = seed
        self.ts_key = ts_key
        #: Shifts the whole schedule, so downstream operators finish
        #: ``open()`` (warmup) before the first record is due.
        self.start_delay_s = start_delay_s
        self._subtask = 0
        self._parallelism = 1
        self._seek = 0

    def clone(self):
        return copy.copy(self)

    def open(self, ctx):
        self._subtask = ctx.subtask_index
        self._parallelism = ctx.parallelism

    def seek(self, n: int) -> None:
        """Skip the first ``n`` of this subtask's records on restore
        without running their sleep schedule."""
        self._seek = n

    def _offsets(self, n: int) -> np.ndarray:
        if self.jitter == "poisson":
            gaps = np.random.RandomState(self.seed).exponential(1.0 / self.rate_hz, size=n)
        else:
            gaps = np.full(n, 1.0 / self.rate_hz)
        return np.cumsum(gaps)

    def run(self):
        mine = list(range(self._subtask, len(self.data), self._parallelism))
        offsets = self._offsets(len(self.data))
        skipped, mine = mine[:self._seek], mine[self._seek:]
        # After a seek the first remaining record is due one gap after the
        # restore: the schedule keeps its shape.
        base = float(offsets[skipped[-1]]) if skipped else 0.0
        t_start = time.monotonic()
        for i in mine:
            due = t_start + self.start_delay_s + float(offsets[i]) - base
            while True:
                delay = due - time.monotonic()
                if delay <= 0:
                    break
                time.sleep(min(delay, 0.1))
                if due - time.monotonic() > 0:
                    yield SOURCE_IDLE
            value = self.data[i]
            if hasattr(value, "with_meta"):
                value = value.with_meta(**{self.ts_key: due})
            yield value
