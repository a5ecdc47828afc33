"""Tensor coercion — host values in, schema-conforming TensorValues out.

Port of ``flink_tensorflow_tpu/tensors/coercion.py:coerce`` (``:57``) and
the array-like conversion under it: a record, a mapping, a tuple in
schema order or a single array becomes a host ``TensorValue`` whose
fields match the schema's dtypes and shapes.
"""

from __future__ import annotations

import typing

import numpy as np

from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, TensorSpec
from flink_tensorflow_tpu_torch.tensors.value import TensorValue


def coerce_field(value: typing.Any, spec: TensorSpec) -> np.ndarray:
    arr = np.asarray(value)
    if arr.dtype != spec.dtype:
        arr = arr.astype(spec.dtype)
    # Rank promotion: a flat list reshapes to a fully static field.
    if arr.ndim != spec.rank:
        target = tuple(d for d in spec.shape if d is not None)
        if len(target) == spec.rank and arr.size == int(np.prod(target)):
            arr = arr.reshape(target)
        else:
            raise TypeError(f"cannot coerce array of shape {arr.shape} to spec {spec.shape}")
    spec.validate(arr)
    return arr


def coerce(value: typing.Any, schema: RecordSchema) -> TensorValue:
    """Coerce a host value into a TensorValue that conforms to ``schema``:
    a ``TensorValue`` (its schema fields are selected and checked), a
    mapping, a tuple/list in the schema's field order, or a single
    array-like when the schema has one field."""
    if isinstance(value, TensorValue):
        missing = set(schema.names) - set(value.names)
        if missing:
            raise TypeError(f"record missing fields {missing}")
        return TensorValue({n: coerce_field(value[n], schema[n]) for n in schema.names},
                           value.meta)
    if isinstance(value, typing.Mapping):
        missing = set(schema.names) - set(value)
        if missing:
            raise TypeError(f"row missing fields {missing}")
        return TensorValue({n: coerce_field(value[n], schema[n]) for n in schema.names})
    if isinstance(value, (tuple, list)) and len(schema.names) > 1:
        if len(value) != len(schema.names):
            raise TypeError(f"row of {len(value)} columns does not match schema {schema.names}")
        return TensorValue({n: coerce_field(v, schema[n]) for n, v in zip(schema.names, value)})
    if len(schema.names) == 1:
        name = schema.names[0]
        return TensorValue({name: coerce_field(value, schema[name])})
    raise TypeError(f"cannot coerce {type(value).__name__} to {schema}")
