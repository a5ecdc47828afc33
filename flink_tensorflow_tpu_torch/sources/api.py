"""Split-based source API — the FLIP-27-style source protocols.

Port of ``flink_tensorflow_tpu/sources/api.py`` (``:49-170``).  The
legacy ``SourceFunction.run()`` generator (``io/sources.py``) fixes the
distribution of work when the job is planned: subtask i owns records
``i, i+N, ...``, a failed subtask can only replay its own stride, and
the source loop blocks inside the user's sleeps.  A split source splits
a source into three roles:

- :class:`SourceSplit`: one unit of assignable work (a file range, a
  slice of a sequence) carrying its own replay ``offset``;
- :class:`SplitEnumerator`: the job's split pool.  Assignment is pulled:
  an idle reader asks for the next split, so a fast subtask takes work a
  slow one never reached;
- :class:`SourceReader`: turns one split into records on a subtask.

A :class:`SplitSource` bundles the factories and is what
``env.from_source(...)`` accepts; the runtime hosts it in a
``SplitSourceOperator`` whose mailbox loop (``core/runtime.py``) serves
records, split assignment, checkpoint barriers and the chain's timer
deadlines from one wait, which lets timer-driven operators fuse into
split-source chains (``analysis/chaining.py``).

Exactly-once: a reader's in-flight split (with its offset) goes into the
reader's own snapshot; the enumerator's unassigned pool goes beside it
through the coordinator (``sources/coordinator.py``), with assignment
frozen while a barrier aligns across the readers, so a split is never
both pooled in the snapshot and emitted before a reader's barrier.
Restored splits resume at their offsets; splits of lost readers rejoin
the pool.
"""

from __future__ import annotations

import abc
import copy
import dataclasses
import typing

if typing.TYPE_CHECKING:
    from flink_tensorflow_tpu_torch.core.runtime_context import RuntimeContext
    from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema


@dataclasses.dataclass
class SourceSplit:
    """One assignable unit of source work.

    ``offset`` counts the records the split has already emitted
    downstream; the reader skips that many on (re)start, so a restored
    split resumes mid-way.  Concrete splits add their addressing fields."""

    split_id: str
    offset: int = 0

    def freeze(self) -> "SourceSplit":
        """A copy as of now, for snapshots: the live split keeps moving its
        ``offset`` on the reader thread while the store writes."""
        return copy.copy(self)


@dataclasses.dataclass
class NotReady:
    """Yielded by a reader when its next record is not due yet (paced
    sources).  ``due`` is the monotonic time it becomes ready; the source
    loop parks on its mailbox until then, wakeable by barriers,
    notifications and chained operators' timers."""

    due: float


class SplitEnumerator(abc.ABC):
    """The job's split pool; it runs under the coordinator's lock and
    needs no locking of its own."""

    @abc.abstractmethod
    def next_split(self, reader_index: int) -> typing.Optional[SourceSplit]:
        """The next split for ``reader_index``, or None while the pool is
        empty (for a bounded source: done)."""

    @abc.abstractmethod
    def add_splits_back(self, splits: typing.Sequence[SourceSplit]) -> None:
        """Return splits to the pool (failover, rescale).  They keep their
        offsets, so a reassignment resumes rather than replays."""

    @abc.abstractmethod
    def snapshot_state(self) -> typing.Any:
        """Picklable pool state, insulated from later changes of the live
        splits (copy them: :meth:`SourceSplit.freeze`), and never None:
        a restore reads None as "nothing was dispensed yet"."""

    @abc.abstractmethod
    def restore_state(self, state: typing.Any) -> None: ...


class ListSplitEnumerator(SplitEnumerator):
    """The bounded enumerator: a FIFO pool over a fixed list of splits.
    Splits added back go to the front, so unfinished work goes out before
    untouched splits."""

    def __init__(self, splits: typing.Sequence[SourceSplit]):
        self._pending: typing.List[SourceSplit] = list(splits)

    def next_split(self, reader_index: int) -> typing.Optional[SourceSplit]:
        return self._pending.pop(0) if self._pending else None

    def add_splits_back(self, splits: typing.Sequence[SourceSplit]) -> None:
        self._pending[:0] = list(splits)

    def snapshot_state(self) -> typing.Any:
        return [s.freeze() for s in self._pending]

    def restore_state(self, state: typing.Any) -> None:
        self._pending = [s.freeze() for s in state]


class SourceReader(abc.ABC):
    """A subtask's record producer for the splits it is assigned."""

    def open(self, ctx: "RuntimeContext") -> None:  # noqa: B027
        pass

    def close(self) -> None:  # noqa: B027
        pass

    @abc.abstractmethod
    def read(self, split: SourceSplit) -> typing.Iterator[typing.Any]:
        """The split's records from ``split.offset`` on (records already
        emitted are skipped).  May yield :class:`NotReady` while the next
        record is not due; the loop polls again after that time."""


class SplitSource(abc.ABC):
    """A split-based source, what ``env.from_source(...)`` accepts beside
    a :class:`~flink_tensorflow_tpu_torch.core.functions.SourceFunction`;
    it runs in the mailbox-driven ``SplitSourceOperator``."""

    #: A bounded source ends when its enumerator is drained; an unbounded
    #: one parks on the mailbox until the job is cancelled.
    bounded: bool = True

    #: Optional RecordSchema of the records it emits.
    schema: typing.Optional["RecordSchema"] = None

    @abc.abstractmethod
    def create_enumerator(self) -> SplitEnumerator: ...

    @abc.abstractmethod
    def create_reader(self, ctx: "RuntimeContext") -> SourceReader: ...

    def plan_split_count(self) -> typing.Optional[int]:
        """The number of splits, where it is known without IO when the job
        is planned, else None (fewer splits than subtasks leaves readers
        idle)."""
        return None
