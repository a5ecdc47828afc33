"""Split-based sources (FLIP-27 style): a split enumerator, source readers,
split assignment pulled by the readers, and a wakeable mailbox source
loop.  The names of ``flink_tensorflow_tpu/sources/__init__.py``; see
``sources/api.py`` for the protocol.
"""

from flink_tensorflow_tpu_torch.sources.api import (
    ListSplitEnumerator,
    NotReady,
    SourceReader,
    SourceSplit,
    SplitEnumerator,
    SplitSource,
)
from flink_tensorflow_tpu_torch.sources.coordinator import SplitCoordinator
from flink_tensorflow_tpu_torch.sources.file_source import FileSplit, FileSplitSource
from flink_tensorflow_tpu_torch.sources.mailbox import SourceMailbox
from flink_tensorflow_tpu_torch.sources.operator import SplitSourceOperator
from flink_tensorflow_tpu_torch.sources.paced import PacedSplit, PacedSplitSource
from flink_tensorflow_tpu_torch.sources.replay import (
    RangeSplit,
    ReplaySplitSource,
    range_splits,
)

__all__ = [
    "FileSplit",
    "FileSplitSource",
    "ListSplitEnumerator",
    "NotReady",
    "PacedSplit",
    "PacedSplitSource",
    "RangeSplit",
    "ReplaySplitSource",
    "SourceMailbox",
    "SourceReader",
    "SourceSplit",
    "SplitCoordinator",
    "SplitEnumerator",
    "SplitSource",
    "SplitSourceOperator",
    "range_splits",
]
