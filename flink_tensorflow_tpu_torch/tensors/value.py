"""TensorValue — the serializable tensor record.

Port of ``flink_tensorflow_tpu/tensors/value.py``: an immutable record of
named host numpy buffers plus picklable metadata (a record id rides along
without entering the device path).  Records cross channels as host
values; they reach the device only as a batch (``tensors/transfer.py``).
"""

from __future__ import annotations

import typing

import numpy as np


class TensorValue:
    """Immutable record of named host tensors and metadata."""

    __slots__ = ("_fields", "_meta")

    def __init__(
        self,
        fields: typing.Mapping[str, typing.Any],
        meta: typing.Optional[typing.Mapping[str, typing.Any]] = None,
    ):
        frozen = {}
        for name, arr in fields.items():
            a = np.asarray(arr)
            # Detach from the caller's buffer: a writable array is copied
            # and frozen; a read-only one is shared as it is.
            if a.flags.writeable:
                a = a.copy()
                a.setflags(write=False)
            frozen[name] = a
        object.__setattr__(self, "_fields", frozen)
        object.__setattr__(self, "_meta", dict(meta or {}))

    def __setattr__(self, name, value):
        raise AttributeError("TensorValue is immutable")

    def __getitem__(self, name: str) -> np.ndarray:
        return self._fields[name]

    def __contains__(self, name: str) -> bool:
        return name in self._fields

    @property
    def fields(self) -> typing.Mapping[str, np.ndarray]:
        return self._fields

    @property
    def meta(self) -> typing.Mapping[str, typing.Any]:
        return self._meta

    @property
    def names(self) -> typing.List[str]:
        return list(self._fields.keys())

    def with_meta(self, **meta) -> "TensorValue":
        """The same fields (shared: they are read-only) with ``meta``
        merged into a copy of this record's metadata."""
        merged = dict(self._meta)
        merged.update(meta)
        return TensorValue(self._fields, merged)

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}: {v.shape}/{v.dtype}" for k, v in self._fields.items())
        return f"TensorValue({inner})"

    # A copy or pickle (a deep-copied user function holding records) goes
    # through these: the immutable __setattr__ blocks the default path.
    def __getstate__(self):
        return {"fields": dict(self._fields), "meta": self._meta}

    def __setstate__(self, state):
        frozen = {}
        for name, arr in state["fields"].items():
            a = np.asarray(arr)
            a.setflags(write=False)
            frozen[name] = a
        object.__setattr__(self, "_fields", frozen)
        object.__setattr__(self, "_meta", dict(state["meta"]))
