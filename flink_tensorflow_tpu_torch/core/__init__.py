"""The streaming runtime of the port, with the names
``flink_tensorflow_tpu/core/__init__.py`` exports."""

from flink_tensorflow_tpu_torch.core.environment import (
    JobHandle,
    JobResult,
    StreamExecutionEnvironment,
)
from flink_tensorflow_tpu_torch.core.functions import (
    Collector,
    FilterFunction,
    FlatMapFunction,
    MapFunction,
    ProcessFunction,
    RichFunction,
    SinkFunction,
    SourceFunction,
    WindowFunction,
)
from flink_tensorflow_tpu_torch.core.state import StateDescriptor
from flink_tensorflow_tpu_torch.core.stream import DataStream, KeyedStream, WindowedStream

__all__ = [
    "StreamExecutionEnvironment",
    "JobHandle",
    "JobResult",
    "DataStream",
    "KeyedStream",
    "WindowedStream",
    "MapFunction",
    "FlatMapFunction",
    "FilterFunction",
    "ProcessFunction",
    "WindowFunction",
    "SourceFunction",
    "SinkFunction",
    "RichFunction",
    "Collector",
    "StateDescriptor",
]
