"""DataStream API — the user-facing fluent stream-building layer.

Port of ``flink_tensorflow_tpu/core/stream.py``: ``DataStream`` (``:130``)
with ``map``, ``flat_map``, ``filter``, unkeyed ``process``, the chaining
opt-outs ``start_new_chain`` / ``disable_chaining`` (``:191-205``),
``key_by`` (``:209``), ``rebalance``, ``broadcast``, ``union``,
``side_output``, ``connect``, ``join`` (``:212-255``), event time
(``assign_timestamps``, ``time_window_all``, ``session_window_all``,
``:257-287``), ``count_window`` with ``slide``, ``timeout_s`` or
``latency_budget_s`` (the adaptive latency trigger, ``:290``), and the
sinks (``:313-326``); ``KeyedStream`` (``:344``) with ``process``,
``count_window``, ``time_window``, ``session_window``, ``connect``,
``interval_join`` and ``reduce``; ``EventTimeWindowedStream``,
``SessionWindowedStream``, ``WindowedStream``, ``ConnectedStreams``,
``JoinBuilder`` and ``IntervalJoinBuilder`` (``:453-702``).

Every operator records its plan-time schema contract on its
transformation (JAX ``:66-77``): the ``output_schema=`` argument of
``map``, ``flat_map``, ``process`` and ``WindowedStream.apply`` (a
RecordSchema or an ``input_schema -> output_schema`` callable), else the
function's own ``output_schema`` hook; operators that forward records
unchanged (filter, union, timestamps) carry the identity.
"""

from __future__ import annotations

import threading
import typing

from flink_tensorflow_tpu_torch.core import elements as el
from flink_tensorflow_tpu_torch.core import functions as fn
from flink_tensorflow_tpu_torch.core.graph import Edge, Transformation
from flink_tensorflow_tpu_torch.core.operators import (
    CoFlatMapOperator,
    CoMapOperator,
    CoProcessOperator,
    FilterOperator,
    FlatMapOperator,
    MapOperator,
    ProcessOperator,
    SinkOperator,
    WindowOperator,
)
from flink_tensorflow_tpu_torch.core.partitioning import (
    BroadcastPartitioner,
    ForwardPartitioner,
    HashPartitioner,
    Partitioner,
    RebalancePartitioner,
)
from flink_tensorflow_tpu_torch.core.state import StateDescriptor
from flink_tensorflow_tpu_torch.core.windows import (
    AdaptiveLatencyTrigger,
    CountOrTimeoutTrigger,
    CountTrigger,
    SlidingCountTrigger,
    Trigger,
)

if typing.TYPE_CHECKING:
    from flink_tensorflow_tpu_torch.core.environment import StreamExecutionEnvironment


def _count_trigger(size: int, slide: typing.Optional[int], timeout_s: typing.Optional[float],
                   latency_budget_s: typing.Optional[float]) -> Trigger:
    if slide is not None:
        if timeout_s is not None or latency_budget_s is not None:
            raise ValueError("sliding count windows do not take timeout_s/latency_budget_s "
                             "(a sliding fire is driven by arrivals, not deadlines)")
        return SlidingCountTrigger(size, slide)
    if latency_budget_s is not None:
        if timeout_s is not None:
            raise ValueError("pass either timeout_s (static flush deadline) or "
                             "latency_budget_s (adaptive rate-projected flush), not both")
        return AdaptiveLatencyTrigger(size, latency_budget_s)
    if timeout_s is not None:
        return CountOrTimeoutTrigger(size, timeout_s)
    return CountTrigger(size)


def _schema_fn(explicit, func):
    """An operator's plan-time schema transform: the explicit
    ``output_schema=`` argument wins; otherwise the function's optional
    ``output_schema`` hook.  None: unknown (propagation stops at the node
    without failing it)."""
    if explicit is not None:
        return explicit
    return getattr(func, "output_schema", None)


def _identity_schema(s):
    """The schema transform of operators that forward records unchanged."""
    return s


class _LambdaMap(fn.MapFunction):
    def __init__(self, f):
        self.f = f

    def map(self, value):
        return self.f(value)


class _LambdaFlatMap(fn.FlatMapFunction):
    def __init__(self, f):
        self.f = f

    def flat_map(self, value):
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
        #: The transformation whose side outputs ``side_output`` taps (a
        #: window applied with ``late_tag``; None: this one).
        self._side_source: typing.Optional[Transformation] = None

    def _edge(self, downstream_parallelism: int) -> Edge:
        p = self._partitioner
        if p is None:
            if downstream_parallelism == self.transformation.parallelism:
                p = ForwardPartitioner()
            else:
                p = RebalancePartitioner()
        return Edge(upstream=self.transformation, partitioner=p)

    def _add_op(self, name, factory, parallelism, schema_fn=None) -> Transformation:
        parallelism = parallelism or self.env.default_parallelism
        return self.env.graph.add(name, factory, parallelism, inputs=[self._edge(parallelism)],
                                  schema_fn=schema_fn)

    def map(self, f: typing.Union[fn.MapFunction, fn.AsyncMapFunction, typing.Callable], *,
            name="map", parallelism=None, output_schema=None) -> "DataStream":
        """One result per record: a ``MapFunction``, a plain callable, or
        an ``AsyncMapFunction`` (results in arrival order, possibly later,
        e.g. ``ModelMapFunction``)."""
        func = f if isinstance(f, (fn.MapFunction, fn.AsyncMapFunction)) else _LambdaMap(f)
        return DataStream(self.env, self._add_op(name, lambda: MapOperator(name, func),
                                                 parallelism,
                                                 schema_fn=_schema_fn(output_schema, func)))

    def flat_map(self, f, *, name="flat_map", parallelism=None,
                 output_schema=None) -> "DataStream":
        """Zero or more results per record, each with the record's timestamp."""
        func = f if isinstance(f, fn.FlatMapFunction) else _LambdaFlatMap(f)
        return DataStream(self.env, self._add_op(name, lambda: FlatMapOperator(name, func),
                                                 parallelism,
                                                 schema_fn=_schema_fn(output_schema, func)))

    def filter(self, f, *, name="filter", parallelism=None) -> "DataStream":
        func = f if isinstance(f, fn.FilterFunction) else _LambdaFilter(f)
        # A filter drops records but never reshapes them.
        return DataStream(self.env, self._add_op(name, lambda: FilterOperator(name, func),
                                                 parallelism, schema_fn=_identity_schema))

    def process(self, f: fn.ProcessFunction, *, name="process", parallelism=None,
                output_schema=None) -> "DataStream":
        """An unkeyed process function (timers per subtask, no keyed state)."""
        return DataStream(self.env, self._add_op(name, lambda: ProcessOperator(name, f),
                                                 parallelism,
                                                 schema_fn=_schema_fn(output_schema, f)))

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

    def broadcast(self) -> "DataStream":
        """Every record to every subtask of the next operator."""
        return DataStream(self.env, self.transformation, BroadcastPartitioner())

    def union(self, *others: "DataStream") -> "DataStream":
        """Merge streams into one materialized stream: an identity operator
        with one input edge per stream, so every API downstream (key_by,
        windows, joins, further unions) sees all of them."""
        merged = _UnionStream(self.env, [self, *others])
        return merged.map(lambda v: v, name="union", parallelism=self.transformation.parallelism,
                          output_schema=_identity_schema)

    def side_output(self, tag: str) -> "DataStream":
        """Tap the side output ``tag`` (e.g. the late records of an
        event-time window applied with ``late_tag=tag``), unwrapped."""
        src = DataStream(self.env, self._side_source or self.transformation)
        return src.flat_map(
            lambda v: [v.value] if isinstance(v, el.SideOutput) and v.tag == tag else [],
            name=f"side_output:{tag}", parallelism=src.transformation.parallelism)

    def connect(self, other: "DataStream") -> "ConnectedStreams":
        """Pair two streams for a two-input operator: ``s1.connect(s2).map(f)``
        with ``f.map1`` for this stream and ``f.map2`` for ``other``."""
        if isinstance(other, KeyedStream):
            raise TypeError("connect: key both inputs or neither — call .key_by(...) on "
                            "this stream too")
        return ConnectedStreams(self.env, self, other)

    def join(self, other: "DataStream") -> "JoinBuilder":
        """``s1.join(s2).where(k1).equal_to(k2).window(size_s).apply(f)``."""
        return JoinBuilder(self.env, self, other)

    def assign_timestamps(self, ts_fn: typing.Callable[[typing.Any], float], *,
                          out_of_orderness_s: float = 0.0, watermark_every: int = 32,
                          name="timestamps") -> "DataStream":
        """Stamp records with event time and emit bounded-out-of-orderness
        watermarks every ``watermark_every`` records (needed upstream of
        time windows and joins)."""
        from flink_tensorflow_tpu_torch.core.event_time import TimestampAssignerOperator

        return DataStream(self.env, self._add_op(
            name, lambda: TimestampAssignerOperator(name, ts_fn, out_of_orderness_s,
                                                    watermark_every),
            self.transformation.parallelism, schema_fn=_identity_schema))

    def time_window_all(self, size_s: float, slide_s: typing.Optional[float] = None
                        ) -> "EventTimeWindowedStream":
        """Tumbling (or, with ``slide_s``, sliding) event-time windows over
        each subtask's whole stream."""
        return EventTimeWindowedStream(self.env, self, size_s, None, slide_s)

    def session_window_all(self, gap_s: float) -> "SessionWindowedStream":
        """Event-time session windows (fixed inactivity gap), unkeyed."""
        return SessionWindowedStream(self.env, self, gap_s, None)

    def count_window(self, size: int, *, slide: typing.Optional[int] = None,
                     timeout_s: typing.Optional[float] = None,
                     latency_budget_s: typing.Optional[float] = None) -> "WindowedStream":
        """Per-subtask count window (the micro-batch primitive):
        ``timeout_s`` makes it the count-or-timeout batcher,
        ``latency_budget_s`` the adaptive latency trigger (a partial window
        fires once it cannot fill inside the budget), ``slide`` a sliding
        window that fires every ``slide`` records with the last ``size``."""
        return WindowedStream(self.env, self,
                              _count_trigger(size, slide, timeout_s, latency_budget_s), None)

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


class _UnionStream(DataStream):
    """The multi-edge view that builds a union's merge operator: its
    ``_add_op`` wires one edge per input stream."""

    def __init__(self, env, streams: typing.List[DataStream]):
        super().__init__(env, streams[0].transformation)
        self._streams = streams

    def _add_op(self, name, factory, parallelism, schema_fn=None):
        parallelism = parallelism or self.env.default_parallelism
        return self.env.graph.add(name, factory, parallelism,
                                  inputs=[s._edge(parallelism) for s in self._streams],
                                  schema_fn=schema_fn)


class KeyedStream:
    """Stream partitioned by key; downstream operators get keyed state."""

    def __init__(self, env, transformation: Transformation, key_selector):
        self.env = env
        self.transformation = transformation
        self.key_selector = key_selector

    def _edge(self, downstream_parallelism: typing.Optional[int] = None) -> Edge:
        """A hash edge on the key, whatever the downstream parallelism."""
        return Edge(self.transformation,
                    HashPartitioner(self.key_selector, self.env.config.max_parallelism))

    def process(self, f: fn.ProcessFunction, *, name="keyed_process",
                parallelism=None, output_schema=None) -> DataStream:
        parallelism = parallelism or self.env.default_parallelism
        t = self.env.graph.add(
            name, lambda: ProcessOperator(name, f, key_selector=self.key_selector),
            parallelism, inputs=[self._edge()], schema_fn=_schema_fn(output_schema, f))
        return DataStream(self.env, t)

    def count_window(self, size: int, *, slide: typing.Optional[int] = None,
                     timeout_s: typing.Optional[float] = None,
                     latency_budget_s: typing.Optional[float] = None) -> "WindowedStream":
        """Count windows per key."""
        return WindowedStream(self.env, self,
                              _count_trigger(size, slide, timeout_s, latency_budget_s),
                              self.key_selector)

    def time_window(self, size_s: float, slide_s: typing.Optional[float] = None
                    ) -> "EventTimeWindowedStream":
        """Tumbling (or, with ``slide_s``, sliding) event-time windows per key."""
        return EventTimeWindowedStream(self.env, self, size_s, self.key_selector, slide_s)

    def session_window(self, gap_s: float) -> "SessionWindowedStream":
        """Event-time session windows per key (fixed inactivity gap)."""
        return SessionWindowedStream(self.env, self, gap_s, self.key_selector)

    def connect(self, other: "KeyedStream") -> "ConnectedStreams":
        """Both inputs in one key space: a CoProcessFunction shares keyed
        state across them."""
        if not isinstance(other, KeyedStream):
            raise TypeError("keyed connect requires both streams keyed — call .key_by(...) "
                            "on the other stream too")
        return ConnectedStreams(self.env, self, other, self.key_selector, other.key_selector)

    def interval_join(self, other: "KeyedStream", *, lower_s: float,
                      upper_s: float) -> "IntervalJoinBuilder":
        """Pair this stream's ``l`` with the other's ``r`` when
        ``l.ts + lower_s <= r.ts <= l.ts + upper_s``."""
        if not isinstance(other, KeyedStream):
            raise TypeError("interval_join requires both streams keyed")
        return IntervalJoinBuilder(self.env, self, other, lower_s, upper_s)

    def reduce(self, f: typing.Union[fn.ReduceFunction, typing.Callable], *, name="reduce",
               parallelism=None) -> DataStream:
        """Running per-key reduction: emits the updated accumulator for
        every record."""
        reducer = f if isinstance(f, fn.ReduceFunction) else _LambdaReduce(f)
        return self.process(_ReduceProcess(reducer), name=name, parallelism=parallelism)


class _LambdaReduce(fn.ReduceFunction):
    def __init__(self, f):
        self.f = f

    def reduce(self, acc, value):
        return self.f(acc, value)


class _ReduceProcess(fn.ProcessFunction):
    """A keyed running reduce on a ProcessFunction and one ValueState."""

    _ACC = StateDescriptor("reduce_acc")

    def __init__(self, reducer: fn.ReduceFunction):
        self.reducer = reducer

    def open(self, ctx):
        self.reducer.open(ctx)

    def close(self):
        self.reducer.close()

    def process_element(self, value, ctx, out: fn.Collector):
        state = ctx.state(self._ACC)
        acc = state.value()
        acc = value if acc is None else self.reducer.reduce(acc, value)
        state.update(acc)
        out.collect(acc)


def _with_side_outputs(env, raw: Transformation, name, parallelism, late_tag) -> DataStream:
    """The stream of a window applied with ``late_tag``: its main stream
    filters the SideOutput envelopes out, and ``side_output(tag)`` on it
    taps ``raw``."""
    stream = DataStream(env, raw)
    if late_tag is None:
        return stream
    main = stream.flat_map(lambda v: [] if isinstance(v, el.SideOutput) else [v],
                           name=f"{name}:main", parallelism=parallelism,
                           output_schema=_identity_schema)
    main._side_source = raw
    return main


class EventTimeWindowedStream:
    """Tumbling or sliding event-time windows; they fire as the watermark
    passes their end."""

    def __init__(self, env, upstream, size_s: float, key_selector,
                 slide_s: typing.Optional[float] = None):
        self.env = env
        self.upstream = upstream  # DataStream or KeyedStream
        self.size_s = size_s
        self.slide_s = slide_s
        self.key_selector = key_selector

    def apply(self, f: fn.WindowFunction, *, name="time_window", parallelism=None,
              late_tag: typing.Optional[str] = None,
              allowed_lateness_s: float = 0.0) -> DataStream:
        """``late_tag`` sends records too late for every window to a side
        output (tap it with ``result.side_output(late_tag)``) instead of
        dropping them; ``allowed_lateness_s`` keeps a fired window for that
        much more event time, re-firing it on each late arrival."""
        from flink_tensorflow_tpu_torch.core.event_time import EventTimeWindowOperator

        parallelism = parallelism or self.env.default_parallelism
        t = self.env.graph.add(
            name, lambda: EventTimeWindowOperator(
                name, f, self.size_s, key_selector=self.key_selector, slide_s=self.slide_s,
                late_tag=late_tag, allowed_lateness_s=allowed_lateness_s),
            parallelism, inputs=[self.upstream._edge(parallelism)],
            schema_fn=_schema_fn(None, f))
        return _with_side_outputs(self.env, t, name, parallelism, late_tag)


class SessionWindowedStream:
    """Event-time session windows (fixed inactivity gap)."""

    def __init__(self, env, upstream, gap_s: float, key_selector):
        self.env = env
        self.upstream = upstream  # DataStream or KeyedStream
        self.gap_s = gap_s
        self.key_selector = key_selector

    def apply(self, f: fn.WindowFunction, *, name="session_window", parallelism=None,
              late_tag: typing.Optional[str] = None) -> DataStream:
        from flink_tensorflow_tpu_torch.core.event_time import SessionWindowOperator

        parallelism = parallelism or self.env.default_parallelism
        t = self.env.graph.add(
            name, lambda: SessionWindowOperator(name, f, self.gap_s,
                                                key_selector=self.key_selector,
                                                late_tag=late_tag),
            parallelism, inputs=[self.upstream._edge(parallelism)],
            schema_fn=_schema_fn(None, f))
        return _with_side_outputs(self.env, t, name, parallelism, late_tag)


class WindowedStream:
    """Count windows (per subtask, or per key behind ``key_by``)."""

    def __init__(self, env, upstream, trigger: Trigger, key_selector=None):
        self.env = env
        self.upstream = upstream  # DataStream or KeyedStream
        self.trigger = trigger
        self.key_selector = key_selector

    def apply(self, f: fn.WindowFunction, *, name="window", parallelism=None,
              output_schema=None) -> DataStream:
        parallelism = parallelism or self.env.default_parallelism
        t = self.env.graph.add(
            name, lambda: WindowOperator(name, f, self.trigger, key_selector=self.key_selector),
            parallelism, inputs=[self.upstream._edge(parallelism)],
            schema_fn=_schema_fn(output_schema, f))
        return DataStream(self.env, t)


class ConnectedStreams:
    """Two streams feeding one two-input operator: unkeyed (each input
    routed on its own), or keyed by ``KeyedStream.connect`` (both inputs
    hash into one key space, so keyed state is shared across them)."""

    def __init__(self, env, s1, s2, key_selector1=None, key_selector2=None):
        self.env = env
        self.s1 = s1
        self.s2 = s2
        self.key_selector1 = key_selector1
        self.key_selector2 = key_selector2

    def _add(self, name, factory, parallelism, schema_fn=None) -> DataStream:
        parallelism = parallelism or self.env.default_parallelism
        t = self.env.graph.add(name, factory, parallelism,
                               inputs=[self.s1._edge(parallelism), self.s2._edge(parallelism)],
                               schema_fn=schema_fn)
        return DataStream(self.env, t)

    def map(self, f: fn.CoMapFunction, *, name="co_map", parallelism=None) -> DataStream:
        return self._add(name, lambda: CoMapOperator(name, f), parallelism,
                         schema_fn=_schema_fn(None, f))

    def flat_map(self, f: fn.CoFlatMapFunction, *, name="co_flat_map",
                 parallelism=None) -> DataStream:
        return self._add(name, lambda: CoFlatMapOperator(name, f), parallelism,
                         schema_fn=_schema_fn(None, f))

    def process(self, f: fn.CoProcessFunction, *, name="co_process",
                parallelism=None) -> DataStream:
        return self._add(name, lambda: CoProcessOperator(
            name, f, key_selector1=self.key_selector1, key_selector2=self.key_selector2),
            parallelism, schema_fn=_schema_fn(None, f))


class JoinBuilder:
    """``s1.join(s2).where(k1).equal_to(k2).window(size_s).apply(f)``: a
    tumbling event-time window join."""

    def __init__(self, env, s1: DataStream, s2: DataStream):
        self.env = env
        self.s1 = s1
        self.s2 = s2
        self._key1 = None
        self._key2 = None
        self._size_s = None

    def where(self, key_selector) -> "JoinBuilder":
        self._key1 = key_selector
        return self

    def equal_to(self, key_selector) -> "JoinBuilder":
        self._key2 = key_selector
        return self

    def window(self, size_s: float) -> "JoinBuilder":
        self._size_s = size_s
        return self

    def apply(self, f, *, name="window_join", parallelism=None) -> DataStream:
        from flink_tensorflow_tpu_torch.core.joins import WindowJoinOperator, as_join_function

        if self._key1 is None or self._key2 is None:
            raise ValueError("join needs .where(k1).equal_to(k2)")
        if self._size_s is None:
            raise ValueError("join needs .window(size_s)")
        func = as_join_function(f)
        key1, key2, size_s = self._key1, self._key2, self._size_s
        maxp = self.env.config.max_parallelism
        t = self.env.graph.add(
            name, lambda: WindowJoinOperator(name, func, size_s, key1, key2),
            parallelism or self.env.default_parallelism,
            inputs=[Edge(self.s1.transformation, HashPartitioner(key1, maxp)),
                    Edge(self.s2.transformation, HashPartitioner(key2, maxp))],
            schema_fn=_schema_fn(None, func))
        return DataStream(self.env, t)


class IntervalJoinBuilder:
    """``left.interval_join(right, lower_s=.., upper_s=..).apply(f)``."""

    def __init__(self, env, left: KeyedStream, right: KeyedStream,
                 lower_s: float, upper_s: float):
        self.env = env
        self.left = left
        self.right = right
        self.lower_s = lower_s
        self.upper_s = upper_s

    def apply(self, f, *, name="interval_join", parallelism=None) -> DataStream:
        from flink_tensorflow_tpu_torch.core.joins import IntervalJoinOperator, as_join_function

        func = as_join_function(f)
        t = self.env.graph.add(
            name, lambda: IntervalJoinOperator(name, func, self.lower_s, self.upper_s,
                                               self.left.key_selector,
                                               self.right.key_selector),
            parallelism or self.env.default_parallelism,
            inputs=[self.left._edge(), self.right._edge()],
            schema_fn=_schema_fn(None, func))
        return DataStream(self.env, t)
