"""StreamExecutionEnvironment — job construction and execution entry point.

Port of ``flink_tensorflow_tpu/core/environment.py``:
``StreamExecutionEnvironment`` (``:153``) with ``from_collection``
(``:301``), ``execute`` (``:439``), ``execute_async`` (``:544``) and
``set_device_provider`` (``:193``); ``JobHandle`` (``:69``) and
``JobResult`` (``:27``).  The job builds a graph; ``execute()`` runs it
on the local executor, one thread per operator subtask.

Devices: a model subtask runs on what the device provider returns for
``(task_name, subtask_index)``.  Without a provider it runs on
``resolve_device(None)`` — the GPU, or an error when there is none.
"""

from __future__ import annotations

import dataclasses
import typing

from flink_tensorflow_tpu_torch.core import functions as fn
from flink_tensorflow_tpu_torch.core.config import JobConfig
from flink_tensorflow_tpu_torch.core.graph import DataflowGraph
from flink_tensorflow_tpu_torch.core.operators import SourceOperator
from flink_tensorflow_tpu_torch.core.runtime import LocalExecutor
from flink_tensorflow_tpu_torch.core.stream import DataStream
from flink_tensorflow_tpu_torch.io.sources import CollectionSource
from flink_tensorflow_tpu_torch.metrics.registry import MetricRegistry


class JobResult:
    def __init__(self, metrics: typing.Dict[str, typing.Any]):
        self.metrics = metrics


class JobHandle:
    """Handle to an asynchronously running job."""

    def __init__(self, executor: LocalExecutor):
        self.executor = executor

    def wait(self, timeout: typing.Optional[float] = None) -> JobResult:
        self.executor.join(timeout)
        return JobResult(self.executor.metrics.report())

    def cancel(self) -> None:
        self.executor.cancel()

    @property
    def metrics(self) -> MetricRegistry:
        return self.executor.metrics


class StreamExecutionEnvironment:
    def __init__(self, parallelism: int = 1, *, config: typing.Optional[JobConfig] = None):
        self.graph = DataflowGraph()
        if config is not None and parallelism != 1:
            config = dataclasses.replace(config, parallelism=parallelism)
        self.config: JobConfig = config or JobConfig(parallelism=parallelism)
        self.metric_registry = MetricRegistry()

    def configure(self, **changes) -> "StreamExecutionEnvironment":
        """Replace JobConfig fields: ``env.configure(channel_capacity=64)``."""
        self.config = dataclasses.replace(self.config, **changes)
        return self

    def set_device_provider(self, provider: typing.Callable[[str, int], typing.Any]
                            ) -> "StreamExecutionEnvironment":
        """Assign a device per ``(task_name, subtask_index)``."""
        return self.configure(device_provider=provider)

    @property
    def default_parallelism(self) -> int:
        return self.config.parallelism

    @property
    def source_throttle_s(self) -> float:
        return self.config.source_throttle_s

    @source_throttle_s.setter
    def source_throttle_s(self, v: float) -> None:
        self.configure(source_throttle_s=v)

    def from_collection(self, data: typing.Sequence[typing.Any], *, name="collection",
                        parallelism: int = 1) -> DataStream:
        return self.from_source(CollectionSource(data), name=name, parallelism=parallelism)

    def from_source(self, source: fn.SourceFunction, *, name="source",
                    parallelism: int = 1) -> DataStream:
        if not isinstance(source, fn.SourceFunction):
            raise TypeError(f"from_source expects a SourceFunction, got {type(source).__name__}")
        t = self.graph.add(name, lambda: SourceOperator(name, source), parallelism,
                           is_source=True)
        return DataStream(self, t)

    def execute(self, job_name: str = "job", *,
                timeout: typing.Optional[float] = None) -> JobResult:
        """Run the job to completion (``timeout`` bounds the wait)."""
        return self.execute_async(job_name).wait(timeout)

    def execute_async(self, job_name: str = "job") -> JobHandle:
        cfg = self.config.validate()
        executor = LocalExecutor(self.graph, channel_capacity=cfg.channel_capacity,
                                 metric_registry=self.metric_registry,
                                 device_provider=cfg.device_provider,
                                 source_throttle_s=cfg.source_throttle_s)
        executor.start()
        return JobHandle(executor)
