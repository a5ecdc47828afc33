"""Checkpoint persistence of the port (``checkpoint/store.py``)."""

from flink_tensorflow_tpu_torch.checkpoint.store import (
    latest_checkpoint_id,
    read_checkpoint,
    write_checkpoint,
)

__all__ = ["write_checkpoint", "read_checkpoint", "latest_checkpoint_id"]
