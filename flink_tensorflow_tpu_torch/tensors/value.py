"""TensorValue — the serializable tensor record.

Port of ``flink_tensorflow_tpu/tensors/value.py``: an immutable record of
named host numpy buffers plus picklable metadata (a record id rides along
without entering the device path).  Records cross channels as host
values; they reach the device only as a batch (``tensors/transfer.py``).
"""

from __future__ import annotations

import typing

import numpy as np

from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, TensorSpec


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

    def __eq__(self, other) -> bool:
        """Value equality, as the reference's (JAX ``value.py:78-83``): the
        same field names, equal meta and equal arrays field by field."""
        if not isinstance(other, TensorValue):
            return NotImplemented
        if set(self._fields) != set(other._fields) or self._meta != other._meta:
            return False
        return all(np.array_equal(self._fields[k], other._fields[k]) for k in self._fields)

    def replace(self, **fields) -> "TensorValue":
        merged = dict(self._fields)
        merged.update(fields)
        return TensorValue(merged, self._meta)

    def with_meta(self, **meta) -> "TensorValue":
        """The same fields (shared: they are read-only) with ``meta``
        merged into a copy of this record's metadata."""
        merged = dict(self._meta)
        merged.update(meta)
        return TensorValue(self._fields, merged)

    def select(self, *names: str) -> "TensorValue":
        return TensorValue({n: self._fields[n] for n in names}, self._meta)

    def schema(self) -> RecordSchema:
        return RecordSchema({n: TensorSpec(a.shape, a.dtype) for n, a in self._fields.items()})

    def conforms_to(self, schema: RecordSchema) -> bool:
        try:
            schema.validate(self._fields)
            return True
        except TypeError:
            return False

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

    # -- device boundary: batch first (tensors/transfer.py); one record's
    # copy is the per-record transfer the batching path exists to avoid.
    def to_device(self, device=None) -> typing.Dict[str, typing.Any]:
        """Every field as a torch tensor on ``device`` (``None`` is the
        card, as at every entry point of the port; ``"cpu"`` the host)."""
        import torch

        from flink_tensorflow_tpu_torch.utils.device import resolve_device

        dev = resolve_device(device)
        return {n: torch.from_numpy(np.array(a)).to(dev) for n, a in self._fields.items()}

    @staticmethod
    def from_device(arrays: typing.Mapping[str, typing.Any], meta=None) -> "TensorValue":
        """A host record of device tensors (each copied to a read-only
        numpy array; waits for the copy) with ``meta`` kept.  numpy has no
        bfloat16, so a bf16 tensor comes back widened to float32 (exact)."""
        import torch

        def host(a):
            if not isinstance(a, torch.Tensor):
                return np.asarray(a)
            a = a.detach()
            return (a.float() if a.dtype == torch.bfloat16 else a).cpu().numpy()

        return TensorValue({n: host(a) for n, a in arrays.items()}, meta)
