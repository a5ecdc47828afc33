"""Per-subtask runtime context handed to operators at ``setup()``.

Port of ``flink_tensorflow_tpu/core/runtime_context.py``: the subtask's
identity and metric group (no mesh, tracer or roofline plane yet; the
operator picks its own device).
"""

from __future__ import annotations

from flink_tensorflow_tpu_torch.metrics.registry import MetricGroup


class RuntimeContext:
    def __init__(self, task_name: str, subtask_index: int = 0):
        self.task_name = task_name
        self.subtask_index = subtask_index
        self.metrics = MetricGroup(f"{task_name}.{subtask_index}")
