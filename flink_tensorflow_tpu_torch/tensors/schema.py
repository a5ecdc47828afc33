"""Record schemas — a flat mapping ``field -> TensorSpec``.

Port of ``flink_tensorflow_tpu/tensors/schema.py``: what a model method
declares, and the checks the coercion and batching layers run against it.
Dynamic dims are spelled ``None``; batching pads them to a bucket before
anything reaches the device.
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


def spec(shape, dtype=np.float32) -> TensorSpec:
    """Shorthand constructor: ``spec((299, 299, 3), np.uint8)``."""
    return TensorSpec(tuple(shape), dtype)
