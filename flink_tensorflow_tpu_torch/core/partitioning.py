"""Stream partitioners — how records route between operator subtasks.

Copy of ``flink_tensorflow_tpu/core/partitioning.py:18-106``: forward,
rebalance, key-group hash and broadcast routing.  ``_stable_hash`` is the JAX
package's byte for byte, so a key lands in the same key group in both
packages and a checkpoint's key groups mean the same thing in each.
"""

from __future__ import annotations

import abc
import typing

import numpy as np


def _stable_hash(key: typing.Any) -> int:
    """Deterministic across processes (unlike ``hash`` with PYTHONHASHSEED)."""
    if isinstance(key, (int, np.integer)):
        return int(key) & 0x7FFFFFFFFFFFFFFF
    if isinstance(key, bytes):
        data = key
    else:
        data = repr(key).encode("utf-8")
    # FNV-1a 64-bit
    h = 0xCBF29CE484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h & 0x7FFFFFFFFFFFFFFF


class Partitioner(abc.ABC):
    """Selects target downstream channel(s) for one record."""

    @abc.abstractmethod
    def select(self, value: typing.Any, num_channels: int) -> typing.Sequence[int]: ...

    def is_broadcast(self) -> bool:
        return False


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


#: Fixed key-group count (Flink's maxParallelism): keys hash into this
#: many groups, groups map onto subtasks as contiguous ranges, so keyed
#: state redistributes when a job restarts with another parallelism.
DEFAULT_MAX_PARALLELISM = 128


def key_group(key: typing.Any, max_parallelism: int) -> int:
    return _stable_hash(key) % max_parallelism


def subtask_for_key_group(group: int, parallelism: int, max_parallelism: int) -> int:
    """Contiguous range assignment (Flink's operator-index formula)."""
    return group * parallelism // max_parallelism


def subtask_for_key(key: typing.Any, parallelism: int, max_parallelism: int) -> int:
    return subtask_for_key_group(
        key_group(key, max_parallelism), parallelism, max_parallelism)


class HashPartitioner(Partitioner):
    """Key-group routing; the same key always reaches the same subtask, and
    the mapping agrees with keyed-state redistribution on rescale."""

    def __init__(self, key_selector: typing.Callable[[typing.Any], typing.Any],
                 max_parallelism: int = DEFAULT_MAX_PARALLELISM):
        self.key_selector = key_selector
        self.max_parallelism = max_parallelism

    def select(self, value, num_channels):
        return (subtask_for_key(self.key_selector(value), num_channels, self.max_parallelism),)


class BroadcastPartitioner(Partitioner):
    """Every record to every downstream subtask (control streams)."""

    def select(self, value, num_channels):
        return tuple(range(num_channels))

    def is_broadcast(self) -> bool:
        return True
