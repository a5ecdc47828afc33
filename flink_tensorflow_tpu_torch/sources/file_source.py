"""FileSplitSource: a split-based source over record frame files.

Port of ``flink_tensorflow_tpu/sources/file_source.py`` (``:33-98``), on
the port's ``io/files.py:iter_record_frames`` and
``tensors/serde.py:decode_record``.  The split-based successor of
``RecordFileSource``: instead of a fixed stride, each file (or, with
``records_per_split``, each record range of a file) is a
:class:`FileSplit` that any reader can pull, so skewed file sizes stop
mattering: the reader on the big file keeps reading it while its peers
drain the small ones.

A replay skips cheaply: frames are length-prefixed, so reaching
``start + offset`` walks the headers without decoding payloads.
"""

from __future__ import annotations

import dataclasses
import typing

from flink_tensorflow_tpu_torch.io.files import iter_record_frames
from flink_tensorflow_tpu_torch.sources.api import (
    ListSplitEnumerator,
    SourceReader,
    SourceSplit,
    SplitEnumerator,
    SplitSource,
)
from flink_tensorflow_tpu_torch.tensors.serde import decode_record


@dataclasses.dataclass
class FileSplit(SourceSplit):
    """Records ``[start, stop)`` of one frame file (``stop=None``: to the
    end of the file)."""

    path: str = ""
    start: int = 0
    stop: typing.Optional[int] = None


class _FileSplitReader(SourceReader):
    def read(self, split: FileSplit) -> typing.Iterator[typing.Any]:
        first = split.start + split.offset
        for i, payload in enumerate(iter_record_frames(split.path)):
            if split.stop is not None and i >= split.stop:
                return
            if i >= first:
                yield decode_record(payload)


class FileSplitSource(SplitSource):
    """A bounded split source over one or more frame files.

    ``records_per_split=None`` (the default): one split per file.  With a
    value, each file is cut into ranges of at most that many records (the
    scan walks frame headers only), so one huge file still spreads."""

    #: The write-ahead-log ingest path of the exactly-once dataflow pass:
    #: durable frame files, split offsets in snapshots.
    wal_fronted = True

    def __init__(self, paths: typing.Union[str, typing.Sequence[str]], *,
                 records_per_split: typing.Optional[int] = None, schema=None):
        if records_per_split is not None and records_per_split <= 0:
            raise ValueError(f"records_per_split must be positive, got {records_per_split}")
        self.paths = [paths] if isinstance(paths, str) else list(paths)
        self.records_per_split = records_per_split
        self.schema = schema

    def create_enumerator(self) -> SplitEnumerator:
        splits: typing.List[FileSplit] = []
        if self.records_per_split is None:
            for path in self.paths:
                splits.append(FileSplit(split_id=path, path=path))
        else:
            per = self.records_per_split
            for path in self.paths:
                count = sum(1 for _ in iter_record_frames(path))
                for start in range(0, count, per):
                    stop = min(start + per, count)
                    splits.append(FileSplit(split_id=f"{path}[{start}:{stop}]", path=path,
                                            start=start, stop=stop))
        return ListSplitEnumerator(splits)

    def create_reader(self, ctx) -> SourceReader:
        return _FileSplitReader()

    def plan_split_count(self) -> typing.Optional[int]:
        # Chunked counts need a file scan; one split per file is known free.
        return len(self.paths) if self.records_per_split is None else None
