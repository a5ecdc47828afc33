"""Record schemas — a flat mapping ``field -> TensorSpec``.

Port of ``flink_tensorflow_tpu/tensors/schema.py``: what a model method
declares, and the checks the coercion and batching layers run against it.
Dynamic dims are spelled ``None``; batching pads them to a bucket before
anything reaches the device.  The plan-time half (JAX ``:104``,
``:124-194``): ``RecordSchema.is_static``, ``batched_struct`` (meta
tensors of a ``[B, ...]`` batch, for the pricer's walk), and
:class:`SchemaMismatch` / :func:`check_compatible`, which the operators'
``output_schema`` hooks raise and the analyzer turns into an ERROR on the
edge where it occurred.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape/dtype contract for one record field (no batch dim)."""

    shape: typing.Tuple[typing.Optional[int], ...]
    dtype: typing.Any = np.float32

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(self.shape))
        object.__setattr__(self, "dtype", np.dtype(self.dtype))

    @property
    def is_static(self) -> bool:
        return all(d is not None for d in self.shape)

    @property
    def rank(self) -> int:
        return len(self.shape)

    def with_batch(self, batch: int) -> typing.Tuple[int, ...]:
        """Static batched shape; dynamic dims must already be resolved."""
        if not self.is_static:
            raise ValueError(f"cannot batch dynamic spec {self.shape} without bucketing")
        return (batch, *self.shape)

    def validate(self, array: np.ndarray) -> None:
        if array.ndim != self.rank:
            raise TypeError(
                f"rank mismatch: spec {self.shape} vs array shape {array.shape}")
        for want, got in zip(self.shape, array.shape):
            if want is not None and want != got:
                raise TypeError(
                    f"shape mismatch: spec {self.shape} vs array shape {array.shape}")
        if array.dtype != self.dtype:
            raise TypeError(f"dtype mismatch: spec {self.dtype} vs array {array.dtype}")


class RecordSchema:
    """Ordered mapping field -> TensorSpec describing one stream record."""

    def __init__(self, fields: typing.Mapping[str, TensorSpec]):
        self.fields: typing.Dict[str, TensorSpec] = dict(fields)

    def __iter__(self):
        return iter(self.fields.items())

    def __getitem__(self, name: str) -> TensorSpec:
        return self.fields[name]

    def __contains__(self, name: str) -> bool:
        return name in self.fields

    def __eq__(self, other) -> bool:
        return isinstance(other, RecordSchema) and self.fields == other.fields

    def __hash__(self) -> int:
        return hash(frozenset(self.fields.items()))

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}: {v.shape}/{v.dtype}" for k, v in self.fields.items())
        return f"RecordSchema({inner})"

    @property
    def names(self) -> typing.List[str]:
        return list(self.fields.keys())

    @property
    def is_static(self) -> bool:
        return all(spec.is_static for spec in self.fields.values())

    def validate(self, record: typing.Mapping[str, np.ndarray]) -> None:
        missing = set(self.fields) - set(record)
        extra = set(record) - set(self.fields)
        if missing or extra:
            raise TypeError(f"record fields mismatch: missing={missing} extra={extra}")
        for name, spec in self.fields.items():
            spec.validate(np.asarray(record[name]))

    def resolve_dynamic(self, length_bucket: int) -> typing.Dict[str, typing.Tuple[int, ...]]:
        """Per-record shapes with every dynamic dim pinned to
        ``length_bucket`` (the shapes a warmup batch takes)."""
        return {
            name: tuple(length_bucket if d is None else d for d in spec.shape)
            for name, spec in self.fields.items()
        }


    def batched_struct(self, batch: int, length_bucket: typing.Optional[int] = None,
                       device="meta") -> typing.Dict[str, typing.Any]:
        """Empty ``[B, ...]`` tensors, one per field, on ``device`` (meta by
        default: shapes and dtypes, no storage) — what the pricer runs a
        model method on.  Dynamic dims must be pinned by ``length_bucket``
        (the :meth:`resolve_dynamic` rule) unless the schema is static."""
        import torch

        if length_bucket is None:
            shapes = {name: spec.with_batch(batch) for name, spec in self.fields.items()}
        else:
            shapes = {name: (batch, *shape)
                      for name, shape in self.resolve_dynamic(length_bucket).items()}
        # The numpy dtype's name is torch's (uint8, int32, float32, bool).
        return {name: torch.empty(shapes[name], dtype=getattr(torch, self.fields[name].dtype.name),
                                  device=device)
                for name in self.fields}


def spec(shape, dtype=np.float32) -> TensorSpec:
    """Shorthand constructor: ``spec((299, 299, 3), np.uint8)``."""
    return TensorSpec(tuple(shape), dtype)


class SchemaMismatch(TypeError):
    """Two record schemas disagree (field set, rank, dtype, or a static
    dim).  Raised by plan-time ``output_schema`` hooks; the analyzer turns
    it into an ERROR diagnostic on the edge where it occurred."""


def check_compatible(expected: RecordSchema, actual: RecordSchema, *, where: str = "") -> None:
    """Check that records described by ``actual`` satisfy ``expected``.

    Every expected field must be present with equal rank and dtype, and
    equal static dims; a ``None`` (dynamic) dim on either side matches
    anything.  Extra fields in ``actual`` are allowed: operators read the
    fields they declare and pass the rest through.  Raises
    :class:`SchemaMismatch` with a field-level message."""
    ctx = f" at {where}" if where else ""
    missing = [n for n in expected.names if n not in actual]
    if missing:
        raise SchemaMismatch(f"missing field(s) {missing}{ctx}: expected {expected}, got {actual}")
    for name in expected.names:
        want, got = expected[name], actual[name]
        if want.rank != got.rank:
            raise SchemaMismatch(
                f"rank mismatch for field {name!r}{ctx}: expected {want.shape} "
                f"(rank {want.rank}), got {got.shape} (rank {got.rank})")
        if want.dtype != got.dtype:
            raise SchemaMismatch(
                f"dtype mismatch for field {name!r}{ctx}: expected {want.dtype}, got {got.dtype}")
        for axis, (w, g) in enumerate(zip(want.shape, got.shape)):
            if w is not None and g is not None and w != g:
                raise SchemaMismatch(
                    f"shape mismatch for field {name!r} axis {axis}{ctx}: "
                    f"expected {want.shape}, got {got.shape}")
