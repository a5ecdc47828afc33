"""Streaming LLM serving plane of the port — continuous batching over
keyed sessions with the KV cache as keyed state (dense pool)."""

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
from flink_tensorflow_tpu_torch.serving.records import GenerateRequest, TokenEvent
from flink_tensorflow_tpu_torch.serving.scheduler import (
    ServingConfig,
    TokenBudgetScheduler,
)

__all__ = [
    "ContinuousBatchingOperator", "DeviceKVBlock", "GenerateRequest", "KVBlock",
    "KVCacheState", "ServingConfig", "SessionState", "TokenBudgetScheduler",
    "TokenEvent", "continuous_batching",
]
