"""Binary record codec — the on-disk form of a record.

Copy of ``flink_tensorflow_tpu/tensors/serde.py`` (``:20-195``): the
identity codec and wire narrowing.  A frame written by either package
reads back in the other, and the same record and wire dtype give the
same bytes in both.

Frame layout (little-endian)::

    u32 magic 'FTTR' | u32 header_len | u32 meta_len | header (json)
    | meta (pickle) | field buffers

``header = {"fields": [[name, shape, dtype], ...]}``; the buffers follow
in header order, tightly packed, and decode as read-only views of the
frame (no copy).  Meta is pickled, so it may hold any picklable value:
a frame is trusted input, as a checkpoint is.

**Wire narrowing** (``encode_record(..., wire_dtype=...)``): the buffer
of a float field of 4 bytes or more is written in a narrower dtype —
``"bf16"`` and ``"f16"`` halve an f32 field, ``"int8"`` quarters it with
a per-field absmax scale — and ``decode_record`` restores the declared
dtype.  A narrowed field's header row is ``[name, shape, dtype, wire,
scale]`` (``scale`` is None except for int8); other fields keep the row
of three, so ``"f32"`` or None writes the identity frame.  bf16 rounds to
nearest even, as ``ml_dtypes`` does (the port keeps no dependency on it).  Accuracy: bf16 keeps f32's range with
about 3 significant digits, f16 about 3.3 and saturates beyond ±65504,
int8 is a uniform absmax quantization (worst error absmax / 254 per
field); never narrow ids.

Not ported: the columnar batch frame and ``decode_frame`` (they belong
to the distributed record plane).
"""

from __future__ import annotations

import json
import pickle
import struct
import typing

import numpy as np
import torch

from flink_tensorflow_tpu_torch.tensors.value import TensorValue

MAGIC = 0x52545446  # 'FTTR'
_HEADER = struct.Struct("<III")

#: Accepted ``wire_dtype`` names; ``"f32"`` and None both mean the
#: identity codec.
WIRE_DTYPES = ("f32", "bf16", "f16", "int8")

#: The layout of a narrowed buffer on the wire.  bf16 has no numpy dtype
#: here: its buffer is the upper 16 bits of each f32, read as uint16.
_WIRE_LAYOUT = {"bf16": np.dtype(np.uint16), "f16": np.dtype(np.float16),
                "int8": np.dtype(np.int8)}
# The bf16 quiet NaNs, as int16: 0x7FC0 and (negative) 0xFFC0.
_BF16_QNAN = torch.tensor(0x7FC0, dtype=torch.int16)
_BF16_NEG_QNAN = torch.tensor(-64, dtype=torch.int16)


def normalize_wire_dtype(wire: typing.Optional[str]) -> typing.Optional[str]:
    """Validate a wire-dtype name; ``"f32"`` -> None."""
    if wire is None or wire == "f32":
        return None
    if wire not in WIRE_DTYPES:
        raise ValueError(f"unknown wire dtype {wire!r} (expected one of {WIRE_DTYPES})")
    return wire


def wire_itemsize(wire: str) -> int:
    """Bytes per element of a buffer narrowed to ``wire``."""
    return _WIRE_LAYOUT[wire].itemsize


def _narrowable(dtype: np.dtype) -> bool:
    """Only full-width floats narrow; ints, bools and f16 ship verbatim."""
    return dtype.kind == "f" and dtype.itemsize >= 4


def to_bf16(a: np.ndarray, out: typing.Optional[torch.Tensor] = None) -> torch.Tensor:
    """``a`` (any float dtype) rounded to bf16, into ``out`` when given:
    through f32, then to nearest even, a NaN to the quiet NaN of its sign
    (``ml_dtypes.bfloat16``'s cast, bit for bit)."""
    src = torch.from_numpy(np.array(a, np.float32, order="C", copy=None))
    if out is None:
        out = torch.empty(src.shape, dtype=torch.bfloat16)
    out.copy_(src)
    nan = torch.isnan(src)
    if bool(nan.any()):
        # torch writes 0x7FFF for every NaN; ml_dtypes keeps the sign.
        out.view(torch.int16)[nan] = torch.where(torch.signbit(src[nan]), _BF16_NEG_QNAN,
                                                 _BF16_QNAN)
    return out


def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """uint16 bf16 bits -> f32 values (exact)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def wire_bytes_saved(record: TensorValue, wire: typing.Optional[str]) -> int:
    """Field-buffer bytes a narrowed frame saves against the identity
    codec (header and meta excluded)."""
    wire = normalize_wire_dtype(wire)
    if wire is None:
        return 0
    itemsize = wire_itemsize(wire)
    saved = 0
    for arr in record.fields.values():
        a = np.asarray(arr)
        if _narrowable(a.dtype):
            saved += a.size * (a.dtype.itemsize - itemsize)
    return saved


def _narrow(a: np.ndarray, wire: str):
    """``(buffer bytes, scale)`` of one field narrowed to ``wire``."""
    if wire == "int8":
        absmax = float(np.max(np.abs(a))) if a.size else 0.0
        scale = absmax / 127.0 if absmax > 0.0 else 1.0
        q = np.clip(np.rint(a.astype(np.float64) / scale), -127, 127)
        return q.astype(np.int8).tobytes(), scale
    if wire == "bf16":
        return to_bf16(a).view(torch.int16).numpy().tobytes(), None
    return a.astype(np.float16).tobytes(), None


def encode_record(record: TensorValue, wire_dtype: typing.Optional[str] = None) -> bytes:
    wire = normalize_wire_dtype(wire_dtype)
    fields = []
    buffers = []
    for name, arr in record.fields.items():
        a = np.asarray(arr)
        if a.dtype.hasobject:
            # tobytes() of an object array writes pointers, not values.
            raise TypeError(f"field {name!r} has object dtype {a.dtype} — record fields "
                            "must be numeric/bytes tensors (put Python objects in meta)")
        if wire is not None and _narrowable(a.dtype):
            buf, scale = _narrow(a, wire)
            fields.append([name, list(a.shape), a.dtype.str, wire, scale])
            buffers.append(buf)
        else:
            fields.append([name, list(a.shape), a.dtype.str])
            buffers.append(a.tobytes())
    header = json.dumps({"fields": fields}).encode()
    meta = pickle.dumps(dict(record.meta), protocol=pickle.HIGHEST_PROTOCOL)
    return b"".join([_HEADER.pack(MAGIC, len(header), len(meta)), header, meta, *buffers])


def decode_record(data: typing.Union[bytes, memoryview]) -> TensorValue:
    view = memoryview(data)
    magic, header_len, meta_len = _HEADER.unpack_from(view, 0)
    if magic != MAGIC:
        raise ValueError(f"bad record magic {magic:#x}")
    off = _HEADER.size
    header = json.loads(bytes(view[off:off + header_len]))
    off += header_len
    meta = pickle.loads(view[off:off + meta_len])
    off += meta_len
    out = {}
    for entry in header["fields"]:
        name, shape, dtype = entry[0], entry[1], np.dtype(entry[2])
        count = int(np.prod(shape)) if shape else 1
        if len(entry) > 3:
            # A narrowed field: restored to its declared dtype here, so
            # the narrowing never leaks past the codec (the restore is a
            # new array; only the identity path is zero-copy).
            wire, scale = entry[3], entry[4]
            layout = _WIRE_LAYOUT[wire]
            raw = np.frombuffer(view, dtype=layout, count=count, offset=off)
            if wire == "int8":
                arr = raw.astype(dtype) * dtype.type(scale)
            elif wire == "bf16":
                arr = bf16_to_f32(raw).astype(dtype)
            else:
                arr = raw.astype(dtype)
            arr = arr.reshape(shape)
            off += count * layout.itemsize
        else:
            arr = np.frombuffer(view, dtype=dtype, count=count, offset=off).reshape(shape)
            off += count * dtype.itemsize
        # Read-only, so TensorValue shares the array instead of copying it.
        if arr.flags.writeable:
            arr.setflags(write=False)
        out[name] = arr
    return TensorValue(out, meta)
