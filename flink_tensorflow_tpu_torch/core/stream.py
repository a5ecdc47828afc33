"""DataStream API — the user-facing fluent stream-building layer.

Port of ``flink_tensorflow_tpu/core/stream.py``: ``DataStream`` (``:130``)
with ``map``, ``filter``, ``key_by`` (``:209``), ``rebalance`` (``:212``),
``count_window`` (``:290``), ``add_sink``, ``sink_to_callable`` (``:316``),
``sink_to_list`` (``:319``) and the chaining opt-outs
``start_new_chain`` / ``disable_chaining`` (``:191-205``); ``KeyedStream`` (``:344``) with
``process``; and ``WindowedStream.apply`` (``:533``).
"""

from __future__ import annotations

import threading
import typing

from flink_tensorflow_tpu_torch.core import functions as fn
from flink_tensorflow_tpu_torch.core.graph import Edge, Transformation
from flink_tensorflow_tpu_torch.core.operators import (
    FilterOperator,
    MapOperator,
    ProcessOperator,
    SinkOperator,
    WindowOperator,
)
from flink_tensorflow_tpu_torch.core.partitioning import (
    ForwardPartitioner,
    HashPartitioner,
    Partitioner,
    RebalancePartitioner,
)
from flink_tensorflow_tpu_torch.core.windows import CountOrTimeoutTrigger, CountTrigger, Trigger

if typing.TYPE_CHECKING:
    from flink_tensorflow_tpu_torch.core.environment import StreamExecutionEnvironment


class _LambdaMap(fn.MapFunction):
    def __init__(self, f):
        self.f = f

    def map(self, value):
        return self.f(value)


class _LambdaFilter(fn.FilterFunction):
    def __init__(self, f):
        self.f = f

    def filter(self, value):
        return bool(self.f(value))


class _ListSink(fn.SinkFunction):
    def __init__(self, target: list, lock):
        self.target = target
        self.lock = lock

    def clone(self):
        return self  # all subtasks share the collection target on purpose

    def invoke(self, value):
        with self.lock:
            self.target.append(value)


class _CallableSink(fn.SinkFunction):
    def __init__(self, f):
        self.f = f

    def clone(self):
        return self  # the callable is the caller's; subtasks share it

    def invoke(self, value):
        self.f(value)


class DataStream:
    """A (possibly re-partitioned) stream of records."""

    def __init__(self, env: "StreamExecutionEnvironment", transformation: Transformation,
                 partitioner: typing.Optional[Partitioner] = None):
        self.env = env
        self.transformation = transformation
        #: Partitioner of the NEXT hop (None: forward at equal parallelism,
        #: else rebalance).
        self._partitioner = partitioner

    def _edge(self, downstream_parallelism: int) -> Edge:
        p = self._partitioner
        if p is None:
            if downstream_parallelism == self.transformation.parallelism:
                p = ForwardPartitioner()
            else:
                p = RebalancePartitioner()
        return Edge(upstream=self.transformation, partitioner=p)

    def _add_op(self, name, factory, parallelism) -> Transformation:
        parallelism = parallelism or self.env.default_parallelism
        return self.env.graph.add(name, factory, parallelism, inputs=[self._edge(parallelism)])

    def map(self, f: typing.Union[fn.MapFunction, fn.AsyncMapFunction, typing.Callable], *,
            name="map", parallelism=None) -> "DataStream":
        """One result per record: a ``MapFunction``, a plain callable, or
        an ``AsyncMapFunction`` (results in arrival order, possibly later,
        e.g. ``ModelMapFunction``)."""
        func = f if isinstance(f, (fn.MapFunction, fn.AsyncMapFunction)) else _LambdaMap(f)
        return DataStream(self.env, self._add_op(name, lambda: MapOperator(name, func),
                                                 parallelism))

    def filter(self, f, *, name="filter", parallelism=None) -> "DataStream":
        func = f if isinstance(f, fn.FilterFunction) else _LambdaFilter(f)
        return DataStream(self.env, self._add_op(name, lambda: FilterOperator(name, func),
                                                 parallelism))

    def start_new_chain(self) -> "DataStream":
        """Pin this operator as the head of a new chain: it never fuses
        with its upstream, though it may still fuse with what follows."""
        self.transformation.chain_start = True
        return self

    def disable_chaining(self) -> "DataStream":
        """Keep this operator out of chains on both sides: it runs on its
        own thread behind its own input gate."""
        self.transformation.chainable = False
        return self

    def key_by(self, key_selector: typing.Callable[[typing.Any], typing.Any]) -> "KeyedStream":
        return KeyedStream(self.env, self.transformation, key_selector)

    def rebalance(self) -> "DataStream":
        return DataStream(self.env, self.transformation, RebalancePartitioner())

    def count_window(self, size: int, *, timeout_s: typing.Optional[float] = None
                     ) -> "WindowedStream":
        """Per-subtask count window (the micro-batch primitive);
        ``timeout_s`` makes it the count-or-timeout batcher."""
        trigger = (CountOrTimeoutTrigger(size, timeout_s) if timeout_s is not None
                   else CountTrigger(size))
        return WindowedStream(self.env, self, trigger)

    def add_sink(self, sink: fn.SinkFunction, *, name="sink",
                 parallelism=None) -> Transformation:
        return self._add_op(name, lambda: SinkOperator(name, sink), parallelism)

    def sink_to_callable(self, f: typing.Callable, *, name="sink",
                         parallelism=None) -> Transformation:
        return self.add_sink(_CallableSink(f), name=name, parallelism=parallelism)

    def sink_to_list(self, *, name="collect", parallelism=None) -> list:
        """Collect results into a list filled during execute()."""
        out: list = []
        self.add_sink(_ListSink(out, threading.Lock()), name=name, parallelism=parallelism)
        return out


class KeyedStream:
    """Stream partitioned by key; downstream operators get keyed state."""

    def __init__(self, env, transformation: Transformation, key_selector):
        self.env = env
        self.transformation = transformation
        self.key_selector = key_selector

    def _edge(self) -> Edge:
        return Edge(self.transformation,
                    HashPartitioner(self.key_selector, self.env.config.max_parallelism))

    def process(self, f: fn.ProcessFunction, *, name="keyed_process",
                parallelism=None) -> DataStream:
        parallelism = parallelism or self.env.default_parallelism
        t = self.env.graph.add(
            name, lambda: ProcessOperator(name, f, key_selector=self.key_selector),
            parallelism, inputs=[self._edge()])
        return DataStream(self.env, t)


class WindowedStream:
    def __init__(self, env, upstream: DataStream, trigger: Trigger):
        self.env = env
        self.upstream = upstream
        self.trigger = trigger

    def apply(self, f: fn.WindowFunction, *, name="window", parallelism=None) -> DataStream:
        parallelism = parallelism or self.env.default_parallelism
        t = self.env.graph.add(name, lambda: WindowOperator(name, f, self.trigger),
                               parallelism, inputs=[self.upstream._edge(parallelism)])
        return DataStream(self.env, t)
