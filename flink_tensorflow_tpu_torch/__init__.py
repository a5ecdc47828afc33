"""PyTorch/CUDA port of flink_tensorflow_tpu.

A second package beside the JAX one.  It mirrors the JAX package's module
paths and names so each counterpart is easy to find, imports ``torch`` and
numpy only, and never imports ``jax`` or anything of
``flink_tensorflow_tpu``: what it needs from there it keeps as its own
copy.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain PyTorch
version.

Ported so far:

- streaming inference, the README's Quick-start job:
  ``core.environment.StreamExecutionEnvironment`` -> ``from_collection``
  -> ``count_window`` -> ``functions.model_function.ModelWindowFunction``
  -> ``sink_to_list``, on the port's local executor, with
  ``functions.runner.CompiledMethodRunner``, ``tensors.transfer`` and
  Inception-v3 (``models.zoo.inception``);
- LLM serving: the char transformer, ``DecodeStepRunner`` (dense KV
  pool) or ``PagedDecodeStepRunner`` (paged pool, radix prefix sharing,
  device -> host -> disk session tiering), ``ContinuousBatchingOperator``
  and ``serving.continuous_batching`` on a keyed stream (or one keyed
  subtask driven directly, ``core.runtime.KeyedSubtask``).  The prefill's
  flash attention is a hand-written CUDA kernel (``csrc/flash_attention.cu``);
- keyed streams and exactly-once state: ``key_by().process()``, keyed
  state, aligned checkpoints (``core.checkpoint``, ``checkpoint.store``),
  restore, restart (``RestartStrategy``) and rescale by key group;
- event time and the rest of the DataStream surface: watermarks
  (``assign_timestamps``), tumbling, sliding and session windows with
  late side outputs and allowed lateness (``core.event_time``), window
  and interval joins (``core.joins``), ``connect``, ``union``,
  ``broadcast``, ``flat_map``, ``reduce``, keyed and sliding count
  windows; record files and the two-phase-commit
  ``io.files.ExactlyOnceRecordFileSink``;
- the reference bench's transfer plane: the zero-copy
  ``native.ring.TensorRing`` (C++ counters in ``csrc/spsc_ring.cpp``)
  under ``ModelWindowFunction``, transfer lanes, wire dtypes
  (``JobConfig.wire_dtype``), stage stamps, and the open loop:
  ``io.sources.PacedSource`` into ``count_window(latency_budget_s=...)``
  (``core.windows.AdaptiveLatencyTrigger``);
- frozen graphs: ``models.loaders.freeze_method`` / ``GraphLoader``
  (``torch.export``) and ``functions.model_function.GraphWindowFunction``
  / ``GraphMapFunction``; the checkpoint coordinator's deadline sweeper;
- parallelism over ``torch.distributed`` (``parallel.multihost``, one
  device per process): the data-parallel gang across processes with
  global batch-norm statistics, and ring and Ulysses attention over a
  ``seq`` axis on the flash-attention kernel;
- split sources (``sources/``) and the cohort supervisor
  (``parallel.supervisor``);
- the distributed record plane: one job graph across a process cohort
  (``env.set_distributed(DistributedConfig(...))``, ``core.distributed``)
  with keyed and rebalance edges over ``core.shuffle`` (coalesced,
  columnar, credit-controlled, shared memory between processes of one
  host) on one ``core.reactor`` thread per process, cohort checkpoints
  and the rescaling restore.
"""

from flink_tensorflow_tpu_torch.core.config import CheckpointConfig, JobConfig
from flink_tensorflow_tpu_torch.core.distributed import DistributedConfig
from flink_tensorflow_tpu_torch.core.environment import (
    RestartStrategy,
    StreamExecutionEnvironment,
)
from flink_tensorflow_tpu_torch.core.functions import ProcessFunction
from flink_tensorflow_tpu_torch.core.state import StateDescriptor
from flink_tensorflow_tpu_torch.core.stream import DataStream, KeyedStream, WindowedStream

__all__ = [
    "CheckpointConfig",
    "DataStream",
    "DistributedConfig",
    "JobConfig",
    "KeyedStream",
    "ProcessFunction",
    "RestartStrategy",
    "StateDescriptor",
    "StreamExecutionEnvironment",
    "WindowedStream",
]
