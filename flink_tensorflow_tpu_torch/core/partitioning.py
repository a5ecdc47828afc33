"""Stream partitioners — how records route between operator subtasks.

Copy of the forward and rebalance partitioners of
``flink_tensorflow_tpu/core/partitioning.py`` (keyed routing waits for
``key_by``).
"""

from __future__ import annotations

import abc
import typing


class Partitioner(abc.ABC):
    """Selects target downstream channel(s) for one record."""

    @abc.abstractmethod
    def select(self, value: typing.Any, num_channels: int) -> typing.Sequence[int]: ...


class ForwardPartitioner(Partitioner):
    """1:1 — requires equal upstream/downstream parallelism."""

    def select(self, value, num_channels):
        return (0,)


class RebalancePartitioner(Partitioner):
    """Round-robin across downstream subtasks (stateful per upstream)."""

    def __init__(self) -> None:
        self._next = 0

    def select(self, value, num_channels):
        idx = self._next % num_channels
        self._next = idx + 1
        return (idx,)
