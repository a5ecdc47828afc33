"""PacedSplitSource: open-loop arrivals on the split API.

Port of ``flink_tensorflow_tpu/sources/paced.py`` (``:41-164``), the
split-based successor of ``io.sources.PacedSource``: records are due on a
schedule whatever the pipeline's progress, and each leaves with its
scheduled time in ``meta[ts_key]``, so sinks measure latency from the
schedule, not from the emit.

Pacing never sleeps in user code: the reader yields
:class:`~flink_tensorflow_tpu_torch.sources.api.NotReady` with the next
due time and the runtime parks on the subtask's mailbox, wakeable by
barriers and by chained operators' deadlines.  That is what lets this
source share a thread with a count-or-timeout window.

``cycles=None`` makes the source unbounded: the enumerator issues the
data's range splits cycle after cycle until the job is cancelled.
"""

from __future__ import annotations

import dataclasses
import time
import typing
import zlib

import numpy as np

from flink_tensorflow_tpu_torch.sources.api import (
    NotReady,
    SourceReader,
    SourceSplit,
    SplitEnumerator,
    SplitSource,
)
from flink_tensorflow_tpu_torch.sources.replay import range_splits


@dataclasses.dataclass
class PacedSplit(SourceSplit):
    """Records ``[start, stop)`` of cycle ``cycle``, paced by the schedule."""

    start: int = 0
    stop: int = 0
    cycle: int = 0


class _PacedEnumerator(SplitEnumerator):
    """Makes each cycle's range splits on demand (an unbounded source
    cannot hold its split list)."""

    def __init__(self, source: "PacedSplitSource"):
        self._source = source
        self._template = range_splits(len(source.data), source.num_splits)
        self._cycle = 0
        self._index = 0
        self._backlog: typing.List[PacedSplit] = []

    def next_split(self, reader_index: int) -> typing.Optional[PacedSplit]:
        if self._backlog:
            return self._backlog.pop(0)
        cycles = self._source.cycles
        if not self._template or (cycles is not None and self._cycle >= cycles):
            return None
        t = self._template[self._index]
        split = PacedSplit(split_id=f"cycle{self._cycle}/{t.split_id}", start=t.start,
                           stop=t.stop, cycle=self._cycle)
        self._index += 1
        if self._index >= len(self._template):
            self._index = 0
            self._cycle += 1
        return split

    def add_splits_back(self, splits) -> None:
        self._backlog[:0] = list(splits)

    def snapshot_state(self):
        return {"cycle": self._cycle, "index": self._index,
                "backlog": [s.freeze() for s in self._backlog]}

    def restore_state(self, state) -> None:
        self._cycle = state["cycle"]
        self._index = state["index"]
        self._backlog = [s.freeze() for s in state["backlog"]]


class _PacedReader(SourceReader):
    def __init__(self, source: "PacedSplitSource"):
        self._source = source

    def _offsets(self, split: PacedSplit) -> np.ndarray:
        src = self._source
        n = split.stop - split.start
        if src.jitter == "poisson":
            # Fixed per split (a replay resumes the same schedule),
            # independent across splits and cycles.
            seed = zlib.crc32(f"{src.seed}/{split.split_id}".encode())
            gaps = np.random.RandomState(seed).exponential(1.0 / src.rate_hz, size=n)
        else:
            gaps = np.full(n, 1.0 / src.rate_hz)
        return np.cumsum(gaps)

    def read(self, split: PacedSplit) -> typing.Iterator[typing.Any]:
        src = self._source
        offsets = self._offsets(split)
        # After a restore the records already emitted do not run their
        # waits again: the first remaining record is due one gap after the
        # (re)assignment, as ``PacedSource.seek`` has it.
        base = float(offsets[split.offset - 1]) if split.offset else 0.0
        t0 = time.monotonic()
        for j in range(split.offset, split.stop - split.start):
            due = t0 + src.start_delay_s + float(offsets[j]) - base
            while time.monotonic() < due:
                yield NotReady(due)
            value = src.data[split.start + j]
            if hasattr(value, "with_meta"):
                value = value.with_meta(**{src.ts_key: due})
            yield value


class PacedSplitSource(SplitSource):
    #: Offers records on its own arrival schedule, whatever the pipeline's
    #: pace: the plan analyzer's open-loop rules read this.
    is_open_loop = True

    def __init__(self, data: typing.Sequence[typing.Any], rate_hz: float, *,
                 jitter: str = "poisson", seed: int = 0, num_splits: int = 8,
                 cycles: typing.Optional[int] = 1, ts_key: str = "sched_ts",
                 start_delay_s: float = 0.0, schema=None):
        if rate_hz <= 0:
            raise ValueError("rate_hz must be > 0")
        if jitter not in ("poisson", "none"):
            raise ValueError(f"unknown jitter {jitter!r}")
        if num_splits <= 0:
            raise ValueError(f"num_splits must be positive, got {num_splits}")
        if cycles is not None and cycles <= 0:
            raise ValueError(f"cycles must be positive or None, got {cycles}")
        self.data = data
        #: Offered rate per reader: the aggregate is ``rate_hz`` times the
        #: readers that hold splits at once (splits pace independently).
        self.rate_hz = rate_hz
        self.jitter = jitter
        self.seed = seed
        self.num_splits = num_splits
        self.cycles = cycles
        self.ts_key = ts_key
        #: Shifts each split's schedule, so downstream operators finish
        #: ``open()`` before the first record is due.
        self.start_delay_s = start_delay_s
        self.schema = schema
        self.bounded = cycles is not None

    def create_enumerator(self) -> SplitEnumerator:
        return _PacedEnumerator(self)

    def create_reader(self, ctx) -> SourceReader:
        return _PacedReader(self)

    def plan_split_count(self) -> typing.Optional[int]:
        if self.cycles is None:
            return None
        per_cycle = max(1, min(self.num_splits, len(self.data))) if len(self.data) else 0
        return per_cycle * self.cycles
