"""Per-subtask runtime context handed to operators and functions.

Port of ``flink_tensorflow_tpu/core/runtime_context.py``: the subtask's
identity, parallelism and metric group; keyed state through
``state(descriptor)`` (scoped to the current key, ``with_key`` swaps it);
``device``, the answer of the job's device provider (None: the model
runner resolves the GPU); ``mesh``, the job's mesh for gang operators,
and ``num_processes``, the processes of the ``torch.distributed`` cohort
this one belongs to (``parallel.multihost``; 1 outside a cohort), each
of which runs its own executor; ``wakeup``, which breaks the subtask loop's
wait when a model runner's results land (the chain head's gate, shared by
every member of a worker chain; None for source chains and bare
operators); ``device_resident``, the job's residency mode; and
``wire_dtype``, the job's H2D wire dtype (None: full width).
"""

from __future__ import annotations

import contextlib
import typing

from flink_tensorflow_tpu_torch.core.state import KeyedStateStore, StateDescriptor, ValueState
from flink_tensorflow_tpu_torch.metrics.registry import MetricGroup


class RuntimeContext:
    def __init__(self, task_name: str, subtask_index: int = 0, parallelism: int = 1,
                 metric_group: typing.Optional[MetricGroup] = None,
                 device: typing.Any = None,
                 keyed_state: typing.Optional[KeyedStateStore] = None,
                 mesh: typing.Any = None, num_processes: int = 1):
        self.task_name = task_name
        self.subtask_index = subtask_index
        self.parallelism = parallelism
        self.metrics = metric_group or MetricGroup(f"{task_name}.{subtask_index}")
        self.device = device
        #: Shared ``parallel.mesh.Mesh`` for gang operators (DP training).
        self.mesh = mesh
        self.num_processes = num_processes
        self._keyed_state = keyed_state if keyed_state is not None else KeyedStateStore()
        self.wakeup: typing.Optional[typing.Callable[[], None]] = None
        #: ``JobConfig.device_resident``: model functions read it at
        #: ``open()`` to choose their emission.
        self.device_resident = False
        #: The job's H2D wire dtype (``JobConfig.wire_dtype`` or
        #: ``FLINK_TPU_WIRE_DTYPE``): model functions without their own
        #: ``wire_dtype`` take it at ``open()``.
        self.wire_dtype: typing.Optional[str] = None

    def state(self, descriptor: StateDescriptor) -> ValueState:
        return self._keyed_state.value_state(descriptor)

    @contextlib.contextmanager
    def with_key(self, key):
        """Scope keyed-state access to ``key`` outside the per-element
        window (end-of-input flushes, timer callbacks across keys)."""
        prev = self._keyed_state.current_key
        self._keyed_state.current_key = key
        try:
            yield
        finally:
            self._keyed_state.current_key = prev
