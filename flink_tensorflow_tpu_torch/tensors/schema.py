"""Record schemas — a flat mapping ``field -> TensorSpec``.

Port of the declarative part of ``flink_tensorflow_tpu/tensors/schema.py``
(what a model method declares).  Dynamic dims are spelled ``None``.
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
