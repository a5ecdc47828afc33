"""ReplaySplitSource: any in-memory sequence as range splits.

Port of ``flink_tensorflow_tpu/sources/replay.py`` (``:25-72``), the
split-based successor of ``CollectionSource``: the sequence is cut into
``num_splits`` contiguous ranges that readers pull instead of owning a
stride, so a reader that stalls simply pulls fewer ranges.
"""

from __future__ import annotations

import dataclasses
import typing

from flink_tensorflow_tpu_torch.sources.api import (
    ListSplitEnumerator,
    SourceReader,
    SourceSplit,
    SplitEnumerator,
    SplitSource,
)


@dataclasses.dataclass
class RangeSplit(SourceSplit):
    """Records ``[start, stop)`` of the source sequence."""

    start: int = 0
    stop: int = 0


def range_splits(total: int, num_splits: int, prefix: str = "range") -> typing.List[RangeSplit]:
    """``[0, total)`` cut into at most ``num_splits`` contiguous, near-equal
    ranges (the replay and paced sources share it)."""
    n = max(1, min(num_splits, total)) if total else 0
    splits = []
    for k in range(n):
        start = k * total // n
        stop = (k + 1) * total // n
        if stop > start:
            splits.append(RangeSplit(split_id=f"{prefix}[{start}:{stop}]", start=start,
                                     stop=stop))
    return splits


class _SequenceReader(SourceReader):
    def __init__(self, data: typing.Sequence[typing.Any]):
        self._data = data

    def read(self, split: RangeSplit) -> typing.Iterator[typing.Any]:
        for i in range(split.start + split.offset, split.stop):
            yield self._data[i]


class ReplaySplitSource(SplitSource):
    def __init__(self, data: typing.Sequence[typing.Any], *, num_splits: int = 8,
                 schema=None):
        if num_splits <= 0:
            raise ValueError(f"num_splits must be positive, got {num_splits}")
        self.data = data
        self.num_splits = num_splits
        self.schema = schema

    def create_enumerator(self) -> SplitEnumerator:
        return ListSplitEnumerator(range_splits(len(self.data), self.num_splits))

    def create_reader(self, ctx) -> SourceReader:
        return _SequenceReader(self.data)  # shared, read-only

    def plan_split_count(self) -> typing.Optional[int]:
        return max(1, min(self.num_splits, len(self.data))) if len(self.data) else 0
