"""Micro-batch assembly: stack, pad, bucket.

Port of ``flink_tensorflow_tpu/tensors/batching.py``: a fired window's
records become one ``[B, ...]`` host buffer per field, with B taken from
a bucket ladder (or pinned by ``fixed_batch``) so the device sees a few
static shapes.  Pad rows replay the first record; ``valid`` marks the
real rows and ``unbatch`` drops the rest.

``assemble`` takes an optional ``alloc(name, shape, dtype)``: the model
runner passes one that hands out views of a pinned staging buffer, so the
stacking copy IS the fill of the host side of the transfer.  The lengths
of a dynamic field come from the same allocator (``length_key``).
"""

from __future__ import annotations

import bisect
import dataclasses
import typing

import numpy as np

from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema
from flink_tensorflow_tpu_torch.tensors.value import TensorValue

Alloc = typing.Callable[[str, typing.Tuple[int, ...], np.dtype], np.ndarray]


def length_key(name: str) -> str:
    """The ``alloc`` name of a dynamic field's ``[B]`` lengths."""
    return f"{name}:lengths"


class BucketLadder:
    """Monotone ladder of sizes; values round up to the next rung
    (powers of two by default)."""

    def __init__(self, sizes: typing.Optional[typing.Sequence[int]] = None, *,
                 max_size: int = 4096):
        if sizes is None:
            sizes, s = [], 1
            while s <= max_size:
                sizes.append(s)
                s *= 2
        self.sizes = sorted(set(int(s) for s in sizes))
        if not self.sizes:
            raise ValueError("bucket ladder must be non-empty")

    def round_up(self, n: int) -> int:
        i = bisect.bisect_left(self.sizes, n)
        if i == len(self.sizes):
            raise ValueError(f"size {n} exceeds largest bucket {self.sizes[-1]}")
        return self.sizes[i]

    @classmethod
    def up_to(cls, cap: int) -> "BucketLadder":
        """Powers of two below ``cap``, then ``cap`` itself as the top rung
        (the micro-batch ladder of ``ModelMapFunction``)."""
        if cap < 1:
            raise ValueError(f"cap must be >= 1, got {cap}")
        sizes, s = [], 1
        while s < cap:
            sizes.append(s)
            s *= 2
        sizes.append(cap)
        return cls(sizes)


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """How a model operator resolves dynamic dims to static shapes."""

    batch: BucketLadder = dataclasses.field(default_factory=BucketLadder)
    #: Ladder for every dynamic (non-batch) dim, e.g. sequence length.
    lengths: BucketLadder = dataclasses.field(default_factory=lambda: BucketLadder(max_size=8192))
    #: If set, batches are always padded to exactly this size (no ladder).
    fixed_batch: typing.Optional[int] = None

    def batch_bucket(self, n: int) -> int:
        return self.fixed_batch if self.fixed_batch is not None else self.batch.round_up(n)


@dataclasses.dataclass
class Batch:
    """One assembled micro-batch (host side, before the transfer).

    ``arrays``: field -> ``[B, ...]``; ``valid``: ``[B]`` bool (False rows
    are padding); ``lengths``: field -> ``[B]`` int32 true lengths of
    dynamic fields; ``metas``: per-record metadata."""

    arrays: typing.Dict[str, np.ndarray]
    valid: np.ndarray
    lengths: typing.Dict[str, np.ndarray]
    metas: typing.List[typing.Mapping[str, typing.Any]]

    @property
    def num_records(self) -> int:
        return int(self.valid.sum())

    @property
    def padded_size(self) -> int:
        return int(self.valid.shape[0])

    def unbatch(self, outputs: typing.Mapping[str, np.ndarray]) -> typing.List[TensorValue]:
        """Split ``[B, ...]`` outputs into per-record values, dropping pad
        rows and re-attaching each record's metadata."""
        records = []
        for i in range(self.padded_size):
            if not self.valid[i]:
                continue
            records.append(TensorValue({n: a[i] for n, a in outputs.items()},
                                       self.metas[len(records)]))
        return records


def assemble(
    records: typing.Sequence[TensorValue],
    schema: RecordSchema,
    policy: typing.Optional[BucketPolicy] = None,
    alloc: typing.Optional[Alloc] = None,
) -> Batch:
    """Stack records into one bucketed, padded micro-batch.

    Dynamic dims are padded to the policy's length ladder, the batch dim
    to the batch ladder (or ``fixed_batch``).  Pad rows replay the first
    record's values (and length) so the padded computation meets no
    NaN/inf path; ``valid`` masks them out."""
    if not records:
        raise ValueError("cannot assemble an empty batch")
    policy = policy or BucketPolicy()
    alloc = alloc or (lambda name, shape, dtype: np.empty(shape, dtype))
    n = len(records)
    b = policy.batch_bucket(n)
    if b < n:
        raise ValueError(f"{n} records exceed fixed_batch={b}; chunk the window upstream")

    arrays: typing.Dict[str, np.ndarray] = {}
    lengths: typing.Dict[str, np.ndarray] = {}
    for name, spec in schema:
        parts = [np.asarray(r[name]) for r in records]
        dyn_axes = [ax for ax, d in enumerate(spec.shape) if d is None]
        if dyn_axes:
            target = list(parts[0].shape)
            for ax in dyn_axes:
                target[ax] = policy.lengths.round_up(max(p.shape[ax] for p in parts))
            lens = alloc(length_key(name), (b,), np.int32)
            lens[:n] = [p.shape[dyn_axes[0]] for p in parts]
            lens[n:] = lens[0]   # pad rows replay record 0's length
            lengths[name] = lens
            out = alloc(name, (b, *target), spec.dtype)
            out[...] = 0
            for i, p in enumerate(parts):
                out[(i, *(slice(0, s) for s in p.shape))] = p
        else:
            # One preallocated buffer, one row copy per record: this fill
            # is the batch's host-side memory traffic, kept at 1x.
            out = alloc(name, (b, *parts[0].shape), spec.dtype)
            for i, p in enumerate(parts):
                out[i] = p
        if b > n:  # batch pad replays record 0
            out[n:] = out[0]
        arrays[name] = out

    valid = np.zeros((b,), dtype=bool)
    valid[:n] = True
    return Batch(arrays=arrays, valid=valid, lengths=lengths, metas=[r.meta for r in records])
