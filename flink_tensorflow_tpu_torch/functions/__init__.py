"""Model operators of the port: inference window and map functions, frozen
graph functions, the device-batch map, the runner under them and the
trainers, with the names ``flink_tensorflow_tpu/functions/__init__.py``
exports."""

from flink_tensorflow_tpu_torch.functions.model_function import (
    DeviceMapFunction,
    GraphMapFunction,
    GraphWindowFunction,
    ModelMapFunction,
    ModelWindowFunction,
)
from flink_tensorflow_tpu_torch.functions.runner import CompiledMethodRunner
from flink_tensorflow_tpu_torch.functions.training_function import (
    DPTrainWindowFunction,
    OnlineTrainFunction,
)

__all__ = [
    "CompiledMethodRunner",
    "DeviceMapFunction",
    "DPTrainWindowFunction",
    "OnlineTrainFunction",
    "GraphMapFunction",
    "GraphWindowFunction",
    "ModelMapFunction",
    "ModelWindowFunction",
]
