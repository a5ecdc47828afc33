"""Streaming LLM serving plane of the port — continuous batching over
keyed sessions with the KV cache as keyed state.

- :mod:`records` — ``GenerateRequest`` in, ``TokenEvent`` out.
- :mod:`kv_cache` — ``KVBlock``/``DeviceKVBlock`` (one session's cache,
  host- or device-resident) and ``KVCacheState`` (the keyed-state facade).
- :mod:`scheduler` — ``ServingConfig`` + ``TokenBudgetScheduler``.
- :mod:`operator` — ``ContinuousBatchingOperator`` and
  :func:`continuous_batching` (the DataStream entry point).
- :mod:`baseline` — ``FixedWindowGenerateFunction``, the fixed
  count-window comparison arm.
- :mod:`paged` — ``PagedKVPool`` (page-granular cache with per-session
  block tables) and ``RadixPrefixIndex`` (prefix sharing, copy-on-write
  at divergence).
- :mod:`tiering` — ``SessionTierManager``, the device -> host -> disk
  residency ladder.
"""

from flink_tensorflow_tpu_torch.serving.baseline import FixedWindowGenerateFunction
from flink_tensorflow_tpu_torch.serving.kv_cache import (
    DeviceKVBlock,
    KVBlock,
    KVCacheState,
    SessionState,
)
from flink_tensorflow_tpu_torch.serving.operator import (
    ContinuousBatchingOperator,
    continuous_batching,
)
from flink_tensorflow_tpu_torch.serving.paged import (
    PagedKVHandle,
    PagedKVPool,
    RadixPrefixIndex,
)
from flink_tensorflow_tpu_torch.serving.records import GenerateRequest, TokenEvent
from flink_tensorflow_tpu_torch.serving.scheduler import (
    ServingConfig,
    TokenBudgetScheduler,
)
from flink_tensorflow_tpu_torch.serving.tiering import (
    SessionTierManager,
    SpilledKVBlock,
)

__all__ = [
    "ContinuousBatchingOperator",
    "DeviceKVBlock",
    "FixedWindowGenerateFunction",
    "GenerateRequest",
    "KVBlock",
    "KVCacheState",
    "PagedKVHandle",
    "PagedKVPool",
    "RadixPrefixIndex",
    "ServingConfig",
    "SessionState",
    "SessionTierManager",
    "SpilledKVBlock",
    "TokenBudgetScheduler",
    "TokenEvent",
    "continuous_batching",
]
