"""Built-in sources.

Port of ``flink_tensorflow_tpu/io/sources.py:CollectionSource`` (``:17``).
"""

from __future__ import annotations

import typing

from flink_tensorflow_tpu_torch.core import functions as fn


class CollectionSource(fn.SourceFunction):
    """Bounded source over an in-memory sequence.

    With parallelism N, subtask i emits elements i, i+N, i+2N, ... so the
    collection is emitted exactly once across the source's subtasks.
    """

    def __init__(self, data: typing.Sequence[typing.Any]):
        self.data = data
        self._subtask = 0
        self._parallelism = 1

    def clone(self):
        c = CollectionSource(self.data)  # share the (read-only) data
        c._subtask = self._subtask
        c._parallelism = self._parallelism
        return c

    def open(self, ctx):
        self._subtask = ctx.subtask_index
        self._parallelism = ctx.parallelism

    def run(self):
        for i in range(self._subtask, len(self.data), self._parallelism):
            yield self.data[i]
