"""Records, schemas, batching and the host<->device transfer of the port,
with the names ``flink_tensorflow_tpu/tensors/__init__.py`` exports."""

from flink_tensorflow_tpu_torch.tensors.batching import (
    Batch,
    BucketLadder,
    BucketPolicy,
    assemble,
)
from flink_tensorflow_tpu_torch.tensors.coercion import (
    coerce,
    coerce_field,
    image_to_float,
    register_converter,
)
from flink_tensorflow_tpu_torch.tensors.schema import (
    RecordSchema,
    SchemaMismatch,
    TensorSpec,
    check_compatible,
    spec,
)
from flink_tensorflow_tpu_torch.tensors.transfer import DeviceBatch, DeviceTransfer
from flink_tensorflow_tpu_torch.tensors.value import TensorValue

__all__ = [
    "Batch",
    "BucketLadder",
    "BucketPolicy",
    "DeviceBatch",
    "DeviceTransfer",
    "RecordSchema",
    "SchemaMismatch",
    "TensorSpec",
    "TensorValue",
    "assemble",
    "check_compatible",
    "coerce",
    "coerce_field",
    "image_to_float",
    "register_converter",
    "spec",
]
