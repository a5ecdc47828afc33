"""Binary record codec — the on-disk form of a record.

Copy of ``flink_tensorflow_tpu/tensors/serde.py:encode_record`` /
``decode_record`` (the identity codec): a frame written by either
package reads back in the other.

Frame layout (little-endian)::

    u32 magic 'FTTR' | u32 header_len | u32 meta_len | header (json)
    | meta (pickle) | field buffers

``header = {"fields": [[name, shape, dtype], ...]}``; the buffers follow
in header order, tightly packed, and decode as read-only views of the
frame (no copy).  Meta is pickled, so it may hold any picklable value:
a frame is trusted input, as a checkpoint is.

Not ported: wire narrowing (``wire_dtype``, a frame field row of five
entries), the columnar batch frame and ``decode_frame``.  A narrowed
frame is refused with an error that says so.
"""

from __future__ import annotations

import json
import pickle
import struct
import typing

import numpy as np

from flink_tensorflow_tpu_torch.tensors.value import TensorValue

MAGIC = 0x52545446  # 'FTTR'
_HEADER = struct.Struct("<III")


def encode_record(record: TensorValue) -> bytes:
    fields = []
    buffers = []
    for name, arr in record.fields.items():
        a = np.asarray(arr)
        if a.dtype.hasobject:
            # tobytes() of an object array writes pointers, not values.
            raise TypeError(f"field {name!r} has object dtype {a.dtype} — record fields "
                            "must be numeric/bytes tensors (put Python objects in meta)")
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
        if len(entry) > 3:
            raise NotImplementedError(
                f"field {entry[0]!r} was written with wire dtype {entry[3]!r}: wire "
                "narrowing is not ported to the PyTorch port yet")
        name, shape, dtype_str = entry
        dtype = np.dtype(dtype_str)
        count = int(np.prod(shape)) if shape else 1
        arr = np.frombuffer(view, dtype=dtype, count=count, offset=off).reshape(shape)
        # Read-only, so TensorValue shares the view instead of copying it.
        if arr.flags.writeable:
            arr.setflags(write=False)
        off += count * dtype.itemsize
        out[name] = arr
    return TensorValue(out, meta)
