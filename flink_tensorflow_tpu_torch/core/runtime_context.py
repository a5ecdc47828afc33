"""Per-subtask runtime context handed to operators and functions.

Port of ``flink_tensorflow_tpu/core/runtime_context.py``: the subtask's
identity, parallelism and metric group; ``device``, the answer of the
job's device provider (None: the model runner resolves the GPU); and
``wakeup``, which breaks the subtask loop's wait when a model runner's
results land (None for sources and bare operators).
"""

from __future__ import annotations

import typing

from flink_tensorflow_tpu_torch.metrics.registry import MetricGroup


class RuntimeContext:
    def __init__(self, task_name: str, subtask_index: int = 0, parallelism: int = 1,
                 metric_group: typing.Optional[MetricGroup] = None,
                 device: typing.Any = None):
        self.task_name = task_name
        self.subtask_index = subtask_index
        self.parallelism = parallelism
        self.metrics = metric_group or MetricGroup(f"{task_name}.{subtask_index}")
        self.device = device
        self.wakeup: typing.Optional[typing.Callable[[], None]] = None
