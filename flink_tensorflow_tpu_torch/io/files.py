"""Record files — a replayable file source and an exactly-once sink.

Port of ``flink_tensorflow_tpu/io/files.py``.  A record file is a
sequence of frames (``tensors/serde.py``), each prefixed by its length as
a little-endian u64, so a file written by one package reads back in the
other, and files the sink writes feed the source.

:class:`ExactlyOnceRecordFileSink` (``:105``) is a two-phase-commit sink
in the mold of Flink's ``TwoPhaseCommitSinkFunction``: records stage into
``*.inprogress`` transaction files; each checkpoint barrier closes the
open transaction and binds it to the checkpoint's id (phase 1, through
the operator's ``snapshot_state_for_checkpoint`` hook); the coordinator's
notification that the checkpoint is durable
(``core/checkpoint.py:CheckpointCoordinator``) promotes the bound files to
their final names (phase 2).  A crash between the two leaves
``.inprogress`` files: a restore promotes those bound to the restored
checkpoint or an earlier one, and deletes the rest, whose records replay.
A cancelled attempt commits nothing: ``close()`` promotes nothing, the
coordinator takes no snapshot of it and announces none of its
checkpoints after the cancel.  Readers of the promoted files
(:func:`read_committed`) see every record exactly once.
"""

from __future__ import annotations

import copy
import os
import struct
import typing

from flink_tensorflow_tpu_torch.core import functions as fn
from flink_tensorflow_tpu_torch.tensors.serde import decode_record, encode_record
from flink_tensorflow_tpu_torch.tensors.value import TensorValue

_LEN = struct.Struct("<Q")
_STAGING_SUFFIX = ".inprogress"


def write_record_file(path: str, records: typing.Iterable[TensorValue]) -> int:
    """Write records as a frame file; returns how many."""
    n = 0
    with open(path, "wb") as f:
        for r in records:
            payload = encode_record(r)
            f.write(_LEN.pack(len(payload)) + payload)
            n += 1
    return n


def iter_record_frames(path: str) -> typing.Iterator[bytes]:
    """A frame file's payloads, one in memory at a time."""
    with open(path, "rb") as f:
        while True:
            head = f.read(_LEN.size)
            if not head:
                return
            if len(head) < _LEN.size:
                raise IOError(f"{path}: truncated frame header")
            (length,) = _LEN.unpack(head)
            payload = f.read(length)
            if len(payload) < length:
                raise IOError(f"{path}: truncated frame body")
            yield payload


def read_record_file(path: str) -> typing.List[TensorValue]:
    return [decode_record(p) for p in iter_record_frames(path)]


class RecordFileSource(fn.SourceFunction):
    """Bounded, replayable source over one or more frame files: with
    parallelism N, subtask i emits records i, i+N, ... of the files in
    order (``CollectionSource``'s striding, so offsets restore exactly)."""

    #: Frame files on durable storage are the write-ahead log the
    #: exactly-once dataflow pass (statecheck) prescribes for a live feed.
    wal_fronted = True

    def __init__(self, paths: typing.Union[str, typing.Sequence[str]]):
        self.paths = [paths] if isinstance(paths, str) else list(paths)
        self._subtask = 0
        self._parallelism = 1

    def clone(self):
        return copy.copy(self)

    def open(self, ctx):
        self._subtask = ctx.subtask_index
        self._parallelism = ctx.parallelism

    def run(self):
        i = 0
        for path in self.paths:
            for payload in iter_record_frames(path):
                # Frames of other subtasks are never decoded.
                if i % self._parallelism == self._subtask:
                    yield decode_record(payload)
                i += 1


class ExactlyOnceRecordFileSink(fn.SinkFunction):
    """Two-phase-commit frame-file sink (see the module docstring).

    Each subtask writes ``part-{subtask:03d}-{txn:06d}`` files; the open
    transaction carries the ``.inprogress`` suffix.  Read the committed
    output with :func:`committed_files` / :func:`read_committed`."""

    #: Two-phase commit: replayed records land in a transaction that
    #: supersedes the aborted one, so at-least-once provenance arriving
    #: here is absorbed (a statecheck INFO, not an ERROR).
    idempotent = True

    def __init__(self, directory: str):
        self.directory = directory
        self._subtask = 0
        self._txn = 0  # the next transaction's number
        self._file = None
        self._records_in_txn = 0
        #: Transactions closed at a barrier, by the checkpoint id they
        #: wait for.
        self._bound: typing.Dict[int, typing.List[int]] = {}
        self._restored: typing.Optional[dict] = None

    def clone(self):
        dup = copy.copy(self)
        dup._file = None
        dup._bound = {}
        return dup

    def _final(self, txn: int) -> str:
        return os.path.join(self.directory, f"part-{self._subtask:03d}-{txn:06d}")

    def _staging(self, txn: int) -> str:
        return self._final(txn) + _STAGING_SUFFIX

    def open(self, ctx) -> None:
        self._subtask = ctx.subtask_index
        os.makedirs(self.directory, exist_ok=True)
        if self._restored is not None:
            self._txn = self._restored["txn"]
            # Transactions bound to the restored checkpoint or an earlier
            # one are covered by a durable checkpoint: commit them (their
            # notification may have been lost in the crash).
            for txns in self._restored["bound"].values():
                for txn in txns:
                    self._promote(txn)
            self._restored = None
        # Everything from the restore point on, staged or committed,
        # replays: delete it (a commit past the restored counter exists
        # when an earlier checkpoint than the latest is restored).  On a
        # fresh run this clears what an earlier attempt left here.
        prefix = f"part-{self._subtask:03d}-"
        for name in os.listdir(self.directory):
            if not name.startswith(prefix):
                continue
            stem = name[len(prefix):]
            if stem.endswith(_STAGING_SUFFIX):
                stem = stem[:-len(_STAGING_SUFFIX)]
            try:
                txn = int(stem)
            except ValueError:
                continue
            if txn >= self._txn:
                try:
                    os.unlink(os.path.join(self.directory, name))
                except FileNotFoundError:
                    pass  # a cancelled attempt's thread removed it first

    def invoke(self, value) -> None:
        if not isinstance(value, TensorValue):
            raise TypeError("ExactlyOnceRecordFileSink carries TensorValue records")
        if self._file is None:
            self._file = open(self._staging(self._txn), "wb")
            self._records_in_txn = 0
        payload = encode_record(value)
        self._file.write(_LEN.pack(len(payload)) + payload)
        self._records_in_txn += 1

    def _close_txn(self, on_nonempty: typing.Callable[[int], None]) -> None:
        """Flush, fsync and close the open transaction; hand a non-empty
        one to ``on_nonempty(txn)`` (bind or promote), delete an empty one."""
        if self._file is None:
            return
        self._file.flush()
        os.fsync(self._file.fileno())
        self._file.close()
        self._file = None
        if self._records_in_txn:
            on_nonempty(self._txn)
        else:
            os.unlink(self._staging(self._txn))
        self._txn += 1

    def snapshot_state_for_checkpoint(self, checkpoint_id) -> dict:
        """Phase 1: close the open transaction and bind it to
        ``checkpoint_id``; the snapshot records the binding, so a restore
        can commit it after a crash before phase 2."""
        self._close_txn(lambda txn: self._bound.setdefault(checkpoint_id, []).append(txn))
        return {"txn": self._txn, "bound": {c: list(t) for c, t in self._bound.items()}}

    def restore_state(self, state) -> None:
        self._restored = state

    def notify_checkpoint_complete(self, checkpoint_id: int) -> None:
        """Phase 2: the checkpoint is durable; promote what is bound to it
        and to any earlier id."""
        for cid in sorted(c for c in self._bound if c <= checkpoint_id):
            for txn in self._bound.pop(cid):
                self._promote(txn)

    def _promote(self, txn: int) -> None:
        staging = self._staging(txn)
        if os.path.exists(staging):
            os.replace(staging, self._final(txn))

    def finish(self) -> None:
        """A clean end of a bounded stream: nothing staged can replay."""
        self._close_txn(self._promote)
        for cid in list(self._bound):
            for txn in self._bound.pop(cid):
                self._promote(txn)

    def close(self) -> None:
        # Also runs on cancel: close the handle and promote nothing.
        if self._file is not None:
            self._file.close()
            self._file = None


def committed_files(directory: str) -> typing.List[str]:
    """Every promoted part file, sorted."""
    return sorted(os.path.join(directory, name) for name in os.listdir(directory)
                  if name.startswith("part-") and not name.endswith(_STAGING_SUFFIX))


def read_committed(directory: str) -> typing.List[TensorValue]:
    out = []
    for path in committed_files(directory):
        out.extend(read_record_file(path))
    return out
