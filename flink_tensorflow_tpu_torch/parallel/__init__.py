"""Parallelism layer — meshes, data-parallel training, ring and Ulysses
attention, process cohorts and their supervisor.

The names of ``flink_tensorflow_tpu/parallel/__init__.py`` that the port
has: where the reference lets XLA emit collectives from sharding
annotations, the port runs them over ``torch.distributed`` process
groups (``parallel/collectives.py``), one device per process.
"""

from flink_tensorflow_tpu_torch.parallel.dp import (
    init_train_state,
    make_dp_train_step,
    make_train_step,
)
from flink_tensorflow_tpu_torch.parallel.mesh import (
    AXIS_ORDER,
    DATA_AXIS,
    EXPERT_AXIS,
    FSDP_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    TP_AXIS,
    Mesh,
    abstract_mesh,
    batch_sharding,
    is_abstract_mesh,
    make_mesh,
    replicate,
    shard_batch,
    spans_processes,
)
from flink_tensorflow_tpu_torch.parallel.multihost import (
    HostTopology,
    global_mesh,
    initialize,
)
from flink_tensorflow_tpu_torch.parallel.ring_attention import (
    full_attention,
    ring_attention,
    ring_attention_sharded,
    ring_decode_attention,
)
from flink_tensorflow_tpu_torch.parallel.supervisor import (
    CohortFailed,
    CohortOutcome,
    CohortSupervisor,
    latest_common_checkpoint,
)
from flink_tensorflow_tpu_torch.parallel.ulysses import (
    ulysses_attention,
    ulysses_attention_sharded,
    ulysses_decode_attention,
)

__all__ = [
    "AXIS_ORDER",
    "DATA_AXIS",
    "EXPERT_AXIS",
    "FSDP_AXIS",
    "MODEL_AXIS",
    "PIPE_AXIS",
    "SEQ_AXIS",
    "TP_AXIS",
    "CohortFailed",
    "CohortOutcome",
    "CohortSupervisor",
    "HostTopology",
    "Mesh",
    "abstract_mesh",
    "batch_sharding",
    "full_attention",
    "global_mesh",
    "init_train_state",
    "initialize",
    "is_abstract_mesh",
    "latest_common_checkpoint",
    "make_dp_train_step",
    "make_mesh",
    "make_train_step",
    "replicate",
    "ring_attention",
    "ring_attention_sharded",
    "ring_decode_attention",
    "shard_batch",
    "spans_processes",
    "ulysses_attention",
    "ulysses_attention_sharded",
    "ulysses_decode_attention",
]
