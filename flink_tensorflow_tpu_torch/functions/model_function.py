"""ModelWindowFunction and ModelMapFunction — models as stream operators.

Port of ``flink_tensorflow_tpu/functions/model_function.py``: the model
source resolver (``_resolve``, ``:48-58``), ``_ModelFunctionBase``
(``:60``, ``open`` ``:239``), ``ModelMapFunction`` (``:282-430``) and
``ModelWindowFunction`` (``:442``) on the list path (``process_window``
``:607``, timer hooks ``:689-716``), and the frozen-graph functions
``GraphWindowFunction`` and ``GraphMapFunction`` (``:728-889``), which
load a ``models.loaders.freeze_method`` graph at ``open()`` and run it
through the same runner.  A model source is a ``Model``, a
bundle path, a ``SavedModelLoader`` or a zero-argument callable; each
subtask resolves it at ``open()``, so a bundle is loaded once per
subtask (one model replica each).  ``open()`` builds a
:class:`~flink_tensorflow_tpu_torch.functions.runner.CompiledMethodRunner`
on the subtask's device (the job's device provider, else the GPU) and
runs the warmup batches; a fired window becomes one device call per
``fixed_batch`` (or largest bucket) chunk, with up to ``pipeline_depth``
batches in flight, so the transfer and launch of window k+1 overlap the
compute of window k.  In-flight batches are flushed at end of input and
before every state snapshot.

``ModelWindowFunction`` emits each batch's results to the collector of
the window that dispatched it, whichever later call drains them, and
``flush_in_flight`` drains them all: an event-time window operator calls
it before it forwards a watermark.  So every result carries its own
window's end.  The reference (``:607-624``) keeps only the latest
window's collector, so at ``pipeline_depth > 1`` an earlier window's
results left stamped with a later window's end.

Both functions poll for finished batches on a timer while batches are in
flight.  Unlike the reference (``:420``), a fire that only drains a
completed batch (a completion wake, deadline 0.0) does not restart that
timer: only the idle deadline proper does, so completions in a lull never
push out the dispatch of a buffered partial micro-batch.

Device-resident dataflow (``:69-70``, ``:259-265``, ``:345``): both
functions can leave a batch's outputs on the device as one
``DeviceBatch`` when the next fused operator consumes it
(``device_resident``: True forces it, False forbids it, None follows
``JobConfig.device_resident`` where the executor marked such a
consumer), and ``ModelMapFunction`` feeds an upstream ``DeviceBatch``
straight to its method.  :class:`DeviceMapFunction` (``:890-944``) is the
elementwise link of such a chain: a torch ``dict -> dict`` callable
applied to the batch on its device.

The transfer options (``:72-119``, ``:241-268``): ``transfer_lanes``
dispatch lanes (``pipeline_depth`` then defaults to ``2 *
transfer_lanes``), ``wire_dtype`` (None follows the job's, ``ctx.
wire_dtype``) and ``stamp_stages`` (per-record stage times in
``meta["__stages__"]``; the window operator adds ``__arrive_ts__``).

**The ring** (``:478-700``): with a fully static input schema and a
``fixed_batch`` policy (or an explicit ``ring_capacity``),
``ModelWindowFunction`` writes each record into a
:class:`~flink_tensorflow_tpu_torch.native.ring.TensorRing` at arrival
(``ingest_element``; the window buffer keeps a token), and a fire claims
contiguous ``[B, ...]`` views of the arena that ship as they lie
(``_fire_ring`` -> ``CompiledMethodRunner.dispatch_batch``): no assemble
copy.  On by default where eligible, as in the reference;
``use_ring=False`` takes the list path.  The arena holds
``(pipeline_depth + 2) * fixed_batch`` records, page-locked on the card.
A batch's slots are released when its results are collected, in
dispatch order, after its H2D event; a batch that would wrap around the
arena's end is copied out instead (after every earlier batch drains); the
last record is pushed again to pad a partial batch; and a snapshot first
turns buffered tokens back into records (``materialize_tokens``), so a
checkpoint never holds a token.  ``close()`` frees the arena only once
the runner's fetch thread has ended: if it is wedged, a reaper thread
waits for it (the reference frees the arena after a 10 s join whatever
the thread is doing).

**Plan-time hooks** (``:141-204``, ``:762-772``): the plan analyzer calls
``output_schema(input_schema)``, which checks the incoming schema against
the method's declared inputs (``plan_input_schema``) and derives the
output schema by running the method on meta tensors (no weights copied,
nothing allocated on a device); ``plan_policy`` is the bucket policy the
runner will take; ``is_jit_boundary`` marks where records become one
runner call (the reference's name for its jit boundary).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
import typing

import numpy as np
import torch

from flink_tensorflow_tpu_torch.core import functions as fn
from flink_tensorflow_tpu_torch.functions.runner import CompiledMethodRunner
from flink_tensorflow_tpu_torch.models.base import Model, ModelMethod, meta_module, numpy_dtype
from flink_tensorflow_tpu_torch.models.loaders import GraphLoader, SavedModelLoader
from flink_tensorflow_tpu_torch.native.ring import TensorRing
from flink_tensorflow_tpu_torch.ops.flash_attention import meta_calls
from flink_tensorflow_tpu_torch.parallel import collectives
from flink_tensorflow_tpu_torch.tensors.batching import Batch, BucketLadder, BucketPolicy
from flink_tensorflow_tpu_torch.tensors.coercion import coerce
from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, TensorSpec, check_compatible
from flink_tensorflow_tpu_torch.tensors.serde import normalize_wire_dtype
from flink_tensorflow_tpu_torch.tensors.transfer import DeviceBatch
from flink_tensorflow_tpu_torch.tensors.value import TensorValue
from flink_tensorflow_tpu_torch.utils.device import resolve_device

ModelSource = typing.Union[Model, str, SavedModelLoader, typing.Callable[[], Model]]
_UNKNOWN = object()


def _resolve(source: ModelSource) -> Model:
    if isinstance(source, Model):
        return source
    if isinstance(source, str):
        return SavedModelLoader(source).load()
    if isinstance(source, SavedModelLoader):
        return source.load()
    if callable(source):
        return source()
    raise TypeError(f"cannot resolve model source {type(source).__name__}")


class _ModelFunctionBase(fn.RichFunction):
    #: Residency markers (``analysis/chaining.py`` and the executor): the
    #: function can produce device batches, and consume them.
    device_capable = True
    accepts_device_batches = True
    #: Records become one runner call here (the plan analyzer's boundary).
    is_jit_boundary = True

    def __init__(
        self,
        model: ModelSource,
        method: str = "serve",
        *,
        policy: typing.Optional[BucketPolicy] = None,
        warmup_batches: typing.Sequence[int] = (),
        warmup_length_bucket: int = 128,
        outputs: typing.Optional[typing.Sequence[str]] = None,
        transfer_lanes: int = 1,
        stamp_stages: bool = False,
        device_resident: typing.Optional[bool] = None,
        wire_dtype: typing.Optional[str] = None,
        donate_inputs: bool = False,
        sharding_axes: typing.Optional[typing.Sequence[str]] = None,
        output_sharding_axes: typing.Optional[typing.Sequence[str]] = None,
    ):
        if transfer_lanes < 1:
            raise ValueError(f"transfer_lanes must be >= 1, got {transfer_lanes}")
        self._source = model
        self._method_name = method
        #: Declared layouts for the plan analyzers (JAX ``:87-105``): the
        #: ``sharding-axis`` rule and chaining read ``sharding_axes``;
        #: shardcheck's reshard audit compares an upstream's
        #: ``output_sharding_axes`` (default: the input axes) with its
        #: consumer's ``sharding_axes``.
        if sharding_axes is not None:
            self.sharding_axes = tuple(sharding_axes)
        self.output_sharding_axes = (
            tuple(output_sharding_axes) if output_sharding_axes is not None
            else (tuple(sharding_axes) if sharding_axes is not None else None))
        #: Donation, the port's meaning of the reference's
        #: ``donate_argnums``: the runner drops its last reference to each
        #: device batch it shipped as soon as the method returns, so the
        #: caching allocator can reuse those pages for the outputs of the
        #: batches that follow (XLA would alias them into this call's
        #: outputs).  Shardcheck's donation audit reads it.
        self._donate = donate_inputs
        self._policy = policy
        self._warmup = tuple(warmup_batches)
        self._warmup_length_bucket = warmup_length_bucket
        self._outputs = outputs
        self._transfer_lanes = transfer_lanes
        #: Stamp per-record stage times into ``meta["__stages__"]`` (the
        #: window operator reads it to stamp ``__arrive_ts__``).
        self.stamp_stages = stamp_stages
        #: The H2D wire dtype; None follows the job's (``ctx.wire_dtype``),
        #: and "f32" ships full width whatever the job's is.
        normalize_wire_dtype(wire_dtype)
        self._wire_dtype = wire_dtype
        #: True forces device-batch output, False forbids it, None follows
        #: JobConfig.device_resident where the next fused operator
        #: consumes device batches (``_device_chain_hint``, set by the
        #: executor).
        self._device_resident = device_resident
        self._device_chain_hint = False
        self.runner: typing.Optional[CompiledMethodRunner] = None
        self._out: typing.Optional[fn.Collector] = None
        self._derived_schema: typing.Any = _UNKNOWN

    # -- plan-time hooks (no model load, no device work) -------------------
    def plan_input_schema(self) -> typing.Optional[RecordSchema]:
        """The method's input schema when it is knowable without loading
        anything: only for a resolved Model (a bundle path, loader or
        factory would pay a load at plan time)."""
        if isinstance(self._source, Model):
            try:
                return self._source.method(self._method_name).input_schema
            except KeyError:
                return None
        return None

    def output_schema(self, input_schema):
        """The analyzer's hook: the incoming schema must satisfy the
        method's inputs (raises ``SchemaMismatch``); the output schema is
        derived on meta tensors, or None (unknown)."""
        expected = self.plan_input_schema()
        if expected is not None and input_schema is not None:
            check_compatible(expected, input_schema,
                             where=f"model method {self._method_name!r}")
        return self._derive_output_schema()

    def _derive_output_schema(self) -> typing.Optional[RecordSchema]:
        """The output RecordSchema (cached), or None: the method runs once
        on a batch of one of meta tensors over a meta copy of the module.
        Only for a resolved Model whose method takes no per-record lengths;
        dynamic dims run at the warmup length bucket (bucketing pins them
        before anything reaches the device)."""
        if self._derived_schema is not _UNKNOWN:
            return self._derived_schema
        self._derived_schema = None
        expected = self.plan_input_schema()
        if expected is None:
            return None
        try:
            method = self._source.method(self._method_name)
            if method.needs_lengths:
                return None
            inputs = expected.batched_struct(1, length_bucket=self._warmup_length_bucket)
            # Collectives count in a census of their own and move nothing.
            with torch.no_grad(), meta_calls(), collectives.census():
                outputs = method.fn(meta_module(self._source.params), inputs)
            fields = {}
            for name in self._outputs or method.output_names or sorted(outputs):
                out = outputs[name]
                if out.dim() == 0 or out.shape[0] != 1:
                    return None  # not batch-major: no per-record schema
                fields[name] = TensorSpec(tuple(out.shape[1:]), numpy_dtype(out.dtype))
            self._derived_schema = RecordSchema(fields)
        except Exception:  # noqa: BLE001 - plan-time best effort, never fatal
            self._derived_schema = None
        return self._derived_schema

    def plan_policy(self) -> BucketPolicy:
        """The bucket policy the runner will take at open()."""
        return self._policy or BucketPolicy()

    def clone(self) -> "fn.Function":
        # Subtasks share the host-side model (read-only); each builds its
        # own runner and device copy at open().
        import copy

        dup = copy.copy(self)
        dup.runner = None
        dup._out = None
        return dup

    def _poll_collect(self) -> None:
        """Emit every batch the runner's fetch thread has completed; never
        waits on the device."""
        if self.runner is None or self._out is None:
            return
        for record in self.runner.collect_available():
            self._out.collect(record)

    def service_time_estimate(self) -> typing.Optional[float]:
        """The runner's EWMA of dispatch -> results per batch: a latency
        budget trigger reserves it (``WindowOperator`` feeds it)."""
        return self.runner.service_ewma_s if self.runner is not None else None

    def open(self, ctx) -> None:
        model = _resolve(self._source)
        wire = (self._wire_dtype if self._wire_dtype is not None
                else getattr(ctx, "wire_dtype", None))
        self.runner = CompiledMethodRunner(model, self._method_name, policy=self._policy,
                                           output_names=self._outputs,
                                           dispatch_lanes=self._transfer_lanes,
                                           wire_dtype=wire, donate_inputs=self._donate)
        self.runner.open(ctx)
        # Leaving results on the device pays only where the next fused
        # operator consumes them: into a host consumer it would move the
        # same D2H onto the subtask thread.
        if self._device_resident is not None:
            self.runner.emit_device_batches = self._device_resident
        else:
            self.runner.emit_device_batches = bool(
                getattr(ctx, "device_resident", False) and self._device_chain_hint)
        # Stage stamps ride per-record host metadata, which a batch left on
        # the device does not have here.
        self.runner.stamp_stages = self.stamp_stages and not self.runner.emit_device_batches
        # Completed results wake the subtask loop at once.
        self.runner.on_results_ready = getattr(ctx, "wakeup", None)
        if self._warmup:
            self.runner.warmup(self._warmup, self._warmup_length_bucket)

    def close(self) -> None:
        if self.runner is not None:
            self.runner.close()
            self.runner = None


class ModelMapFunction(_ModelFunctionBase, fn.AsyncMapFunction):
    """Per-record inference: ``stream.map(ModelMapFunction(bundle))``.

    Arriving records gather into a micro-batch of at most ``micro_batch``
    that dispatches the moment it fills, and up to ``pipeline_depth``
    batches ride the runner's pipeline at once, so the transfer of batch
    k+1 overlaps the compute of batch k.  Results surface in arrival
    order.  In a lull the partial micro-batch dispatches ``idle_flush_s``
    after the last record; ``MapOperator`` flushes everything in flight
    at end of input and before every snapshot barrier.  ``micro_batch=1``
    is strict per-record dispatch, still pipelined.

    The default policy is ``BucketLadder.up_to(micro_batch)`` (1, 2, 4,
    ..., ``micro_batch``): a partial flush pads to the smallest bucket
    that holds it."""

    def __init__(self, model: ModelSource, method: str = "serve", *,
                 micro_batch: int = 8,
                 pipeline_depth: typing.Optional[int] = None,
                 idle_flush_s: float = 0.01, **kw):
        if micro_batch < 1:
            raise ValueError(f"micro_batch must be >= 1, got {micro_batch}")
        if "policy" not in kw:
            kw["policy"] = BucketPolicy(batch=BucketLadder.up_to(micro_batch))
        super().__init__(model, method, **kw)
        if pipeline_depth is None:
            pipeline_depth = max(2, 2 * self._transfer_lanes)
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        self._micro_batch = micro_batch
        self._max_in_flight = pipeline_depth - 1
        self._idle_flush_s = idle_flush_s
        self._buf: typing.List[typing.Any] = []
        self._last_activity: typing.Optional[float] = None
        self._last_poll: typing.Optional[float] = None

    def clone(self) -> "fn.Function":
        dup = super().clone()
        dup._buf = []
        dup._last_activity = None
        dup._last_poll = None
        return dup

    def map_async(self, value, out: fn.Collector):
        self._out = out
        if getattr(value, "is_device_batch", False):
            # A batch on the device from the fused upstream model: it
            # skips the micro-batch buffer and feeds the method as it is
            # (no D2H upstream, no H2D here).  The buffer goes first, so
            # results keep arrival order.
            self._dispatch_buf()
            if not self.runner.dispatch_device(value):
                # Not the method's schema: the D2H runs here, and the
                # records take the host path in micro-batches.
                records = value.materialize()
                for i in range(0, len(records), self._micro_batch):
                    self.runner.dispatch(records[i:i + self._micro_batch])
        else:
            self._buf.append(value)
            if len(self._buf) >= self._micro_batch:
                self._dispatch_buf()
        self._last_activity = time.monotonic()
        for record in self.runner.collect_progress(self._max_in_flight):
            out.collect(record)

    def _dispatch_buf(self) -> None:
        if self._buf:
            self.runner.dispatch(self._buf)
            self._buf = []

    def flush(self, out: fn.Collector):
        """Everything buffered or in flight, emitted now; ``MapOperator``
        calls it at end of input and before every snapshot."""
        if self.runner is None:
            return
        self._dispatch_buf()
        for record in self.runner.flush():
            out.collect(record)

    # -- the latency bound in a lull (MapOperator timer hooks) ------------
    def _idle_deadline(self) -> typing.Optional[float]:
        """The idle deadline proper: when the buffered partial micro-batch
        dispatches (and the in-flight ones are polled)."""
        if self._last_activity is None:
            return None
        if not self._buf and not (self.runner is not None and self.runner.in_flight):
            return None
        base = self._last_activity
        if self._last_poll is not None and self._last_poll > base:
            base = self._last_poll
        return base + self._idle_flush_s

    def next_deadline(self) -> typing.Optional[float]:
        if self.runner is not None and self.runner.has_completed():
            # Fetched results waiting: due at once (0.0 is in the past on
            # the monotonic clock, so the caller's earlier `now` passes).
            return 0.0
        return self._idle_deadline()

    def fire_due(self, now: float) -> None:
        d = self.next_deadline()
        if d is None or now < d:
            return
        # A completion wake (deadline 0.0) drains results only.  The
        # partial buffer dispatches, and the idle timer restarts, only
        # when the idle deadline proper expired: restarting it on every
        # completion would push the partial's dispatch out by
        # idle_flush_s per completed batch in a lull.
        idle = self._idle_deadline()
        if idle is not None and now >= idle:
            self._dispatch_buf()
            self._last_poll = now
        self._poll_collect()


class _RingToken:
    """A window buffer's placeholder for a record whose payload is in the
    ring's arena: its metadata only."""

    __slots__ = ("meta",)

    def __init__(self, meta):
        self.meta = meta


def _close_ring_after(thread: threading.Thread, ring: TensorRing) -> None:
    thread.join()
    ring.close()


class ModelWindowFunction(_ModelFunctionBase, fn.WindowFunction):
    """Micro-batch inference: one device call per fired window (chunked
    when the window exceeds the policy's biggest bucket); through the
    ring where eligible (``use_ring``, see the module docstring).  Traced,
    each batch's hand-off of its results downstream is a ``batch.emit``
    span on the subtask's track and an ``emit_s`` value."""

    #: A window counts elements: a device batch would count as one, so
    #: device batches materialize before they enter a window.  The
    #: function still produces them for a consumer fused behind it.
    accepts_device_batches = False

    def __init__(self, model, method: str = "serve", *,
                 pipeline_depth: typing.Optional[int] = None,
                 idle_flush_s: float = 0.05,
                 use_ring: typing.Optional[bool] = None,
                 ring_capacity: typing.Optional[int] = None, **kw):
        super().__init__(model, method, **kw)
        if pipeline_depth is None:
            pipeline_depth = 2 * self._transfer_lanes
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        self._max_in_flight = pipeline_depth - 1
        self._idle_flush_s = idle_flush_s
        self._last_dispatch: typing.Optional[float] = None
        self._last_poll: typing.Optional[float] = None
        #: Per dispatched batch, oldest first: ``[collector, records
        #: still owed]``.  Results go to the window that dispatched them.
        self._routes: typing.Deque[typing.List[typing.Any]] = collections.deque()
        self._use_ring = use_ring
        self._ring_capacity = ring_capacity
        self._ring: typing.Optional[TensorRing] = None
        self._last_ingested: typing.Optional[TensorValue] = None
        self._metrics = None
        #: Traced: the subtask's track and the ``emit_s`` histogram.
        self._tracer = None
        self._track: typing.Optional[str] = None
        self._emit_hist = None

    def clone(self) -> "fn.Function":
        dup = super().clone()
        dup._routes = collections.deque()
        dup._ring = None
        dup._last_ingested = None
        return dup

    # -- ring lifecycle ----------------------------------------------------
    def open(self, ctx) -> None:
        super().open(ctx)
        self._metrics = getattr(ctx, "metrics", None)
        self._tracer = getattr(ctx, "tracer", None)
        if self._tracer is not None:
            self._track = f"{ctx.task_name}.{ctx.subtask_index}"
            if self._metrics is not None:
                self._emit_hist = self._metrics.histogram("emit_s")
        if self._use_ring is False:
            return
        method = self.runner.method
        schema = method.input_schema
        # A donated batch is the runner's to drop, never the arena's (the
        # reference refuses the pair: its donated buffers may alias ring
        # slots).
        eligible = (all(d is not None for n in schema.names for d in schema[n].shape)
                    and not method.needs_lengths and not self._donate)
        if self._use_ring and self._donate:
            raise ValueError("use_ring=True is incompatible with donate_inputs=True "
                             "(donated buffers may alias the ring arena)")
        capacity = self._ring_capacity
        fixed = self.runner.policy.fixed_batch
        if capacity is None and fixed is not None:
            # A slot set per batch in flight, plus the window filling.
            capacity = (self._max_in_flight + 3) * fixed
        if self._use_ring and not eligible:
            raise ValueError("use_ring=True requires a fully static input schema "
                             "(dynamic-length fields batch through the list path)")
        if self._use_ring and capacity is None:
            raise ValueError("use_ring=True without fixed_batch needs ring_capacity")
        if eligible and capacity is not None:
            self._ring = TensorRing(schema, capacity,
                                    pinned=self.runner.device.type == "cuda")
            if self._metrics is not None:
                self._metrics.gauge("ring_pinned_bytes", lambda r=self._ring: r.pinned_bytes)

    def close(self) -> None:
        runner = self.runner
        super().close()
        ring, self._ring = self._ring, None
        if ring is None:
            return
        wedged = runner.wedged_fetcher if runner is not None else None
        if wedged is not None:
            # A batch may still read the arena: free it only after the
            # fetch thread ends.
            threading.Thread(target=_close_ring_after, args=(wedged, ring),
                             name="ring-reaper", daemon=True).start()
            return
        if ring.pinned_bytes:
            # No copy may still read the arena when it is freed.
            torch.cuda.synchronize(runner.device)
        ring.close()

    def _count(self, name: str) -> None:
        if self._metrics is not None:
            self._metrics.counter(name).inc()

    # -- per-element ingestion (WindowOperator hook) -----------------------
    def ingest_element(self, value, out: fn.Collector):
        """Write one record into the ring at arrival; the buffer token, or
        None to buffer the value itself (no ring, or the window alone
        fills it)."""
        if self._ring is None:
            return None
        tv = value if isinstance(value, TensorValue) else coerce(
            value, self.runner.method.input_schema)
        while not self._ring.try_push(tv.fields):
            # Full: completed batches hold slots until collected, so
            # collect them; else wait for the oldest batch in flight.
            drained = self.runner.collect_available()
            if drained:
                self._emit(drained)
                continue
            if not self.runner.in_flight:
                self._count("ring_list_buffered")
                return None
            self._emit(self.runner.collect_ready(self.runner.in_flight - 1))
        self._last_ingested = tv
        return _RingToken(tv.meta)

    def materialize_tokens(self, elements):
        """Tokens copied out of the ring into records (before a snapshot,
        and for a window that mixes tokens and records).  Every batch in
        flight drains first, so the ring's oldest slot is the first
        token's."""
        tokens = [e for e in elements if isinstance(e, _RingToken)]
        if not tokens:
            return list(elements)
        if self.runner is not None and (self.runner.in_flight or self.runner.has_completed()):
            self._emit(self.runner.flush())
        values = []
        while len(values) < len(tokens):
            views, n = self._ring.claim_batch(len(tokens) - len(values))
            if n == 0:
                raise RuntimeError("ring out of sync with the window buffer")
            for i in range(n):
                row = {}
                for f, v in views.items():
                    a = np.array(v[i])
                    a.setflags(write=False)
                    row[f] = a
                values.append(row)
            self._ring.release(n)
        it = iter(values)
        return [TensorValue(next(it), e.meta) if isinstance(e, _RingToken) else e
                for e in elements]

    # -- firing ------------------------------------------------------------
    def _emit(self, records) -> None:
        # Traced: a batch's hand-off runs from its first result leaving
        # ``collect_*`` to its last handed downstream.
        traced = self._tracer is not None
        t_first, n = None, 0
        for record in records:
            if traced and t_first is None:
                t_first = time.monotonic()
            route = self._routes[0]
            route[0].collect(record)
            # A device batch answers all its records at once.
            k = record.num_records if getattr(record, "is_device_batch", False) else 1
            n += k
            route[1] -= k
            if route[1] <= 0:
                self._routes.popleft()
                if traced:
                    self._trace_emit(t_first, n)
                t_first, n = None, 0

    def _trace_emit(self, t_first: float, n: int) -> None:
        t = time.monotonic()
        self._tracer.span(self._track, "batch.emit", t_first, t, args={"records": n})
        if self._emit_hist is not None:
            self._emit_hist.record(t - t_first)

    def process_window(self, key, window, elements, out: fn.Collector):
        elements = list(elements)
        if (elements and self._ring is not None
                and all(isinstance(e, _RingToken) for e in elements)):
            self._fire_ring(elements, out)
        else:
            if any(isinstance(e, _RingToken) for e in elements):
                # Restored records and fresh tokens: this window takes the
                # list path.
                elements = self.materialize_tokens(elements)
            policy = self.runner.policy
            cap = policy.fixed_batch or policy.batch.sizes[-1]
            for i in range(0, len(elements), cap):
                chunk = elements[i:i + cap]
                self.runner.dispatch(chunk)
                self._routes.append([out, len(chunk)])
                self._emit(self.runner.collect_progress(self._max_in_flight))
        self._last_dispatch = time.monotonic()

    def _fire_ring(self, tokens, out: fn.Collector) -> None:
        """Claim each chunk's contiguous views of the arena and dispatch
        them as they lie (JAX ``_fire_ring``, ``:626``)."""
        policy = self.runner.policy
        ring = self._ring
        cap = policy.fixed_batch or policy.batch.sizes[-1]
        for start in range(0, len(tokens), cap):
            chunk = tokens[start:start + cap]
            n = len(chunk)
            b = policy.batch_bucket(n)
            # Pad rows replay the last record; they follow the chunk.
            for _ in range(b - n):
                if not ring.try_push(self._last_ingested.fields):
                    self._emit(self.runner.flush())
                    if not ring.try_push(self._last_ingested.fields):
                        raise RuntimeError("ring cannot hold batch padding; "
                                           "raise ring_capacity")
            views, got = ring.claim_batch(b, wait=False)
            if got < b:
                # The batch wraps around the arena's end: copy it out.
                # Releases free the oldest claims first, so every earlier
                # batch drains before this one's slots are released.
                if self.runner.in_flight or self.runner.has_completed():
                    self._emit(self.runner.flush())
                t0 = time.monotonic()
                ring.wait_copied(ring.claimed)
                arrays = {f: np.empty((b, *v.shape[1:]), v.dtype) for f, v in views.items()}
                filled = 0
                while filled < b:
                    if filled:
                        views, got = ring.claim_batch(b - filled)
                        if got == 0:
                            raise RuntimeError("ring out of sync with the window buffer")
                    for f, v in views.items():
                        arrays[f][filled:filled + got] = v[:got]
                    ring.release(got)
                    filled += got
                copy_s = time.monotonic() - t0
                release = ready = None
                self._count("ring_copy_outs")
            else:
                arrays, copy_s = views, 0.0
                release = (lambda nn=b: ring.release(nn))
                # The ring's copier may still be writing the batch's rows:
                # the lane waits for them before the H2D reads them.
                ready = (lambda upto=ring.claimed: ring.wait_copied(upto))
            valid = np.zeros((b,), dtype=bool)
            valid[:n] = True
            batch = Batch(arrays=arrays, valid=valid, lengths={}, metas=[t.meta for t in chunk])
            self.runner.dispatch_batch(batch, assemble_s=copy_s, on_done=release, ready=ready)
            self._routes.append([out, n])
            self._count("ring_batches")
            self._emit(self.runner.collect_progress(self._max_in_flight))

    def _poll_collect(self) -> None:
        if self.runner is not None:
            self._emit(self.runner.collect_available())

    def flush_in_flight(self) -> None:
        if self.runner is not None:
            self._emit(self.runner.flush())

    # Timer hooks (WindowOperator.next_deadline / fire_due): while batches
    # are in flight, poll every idle_flush_s and emit what is ready
    # without blocking the subtask thread.
    def _poll_deadline(self) -> typing.Optional[float]:
        """The backstop poll: ``idle_flush_s`` after the last dispatch or
        the last poll, while batches are in flight."""
        if self.runner is None or not self.runner.in_flight or self._last_dispatch is None:
            return None
        base = self._last_dispatch
        if self._last_poll is not None and self._last_poll > base:
            base = self._last_poll
        return base + self._idle_flush_s

    def next_deadline(self) -> typing.Optional[float]:
        if self.runner is not None and self.runner.has_completed():
            # Due at once: 0.0 is in the past on the monotonic clock.
            return 0.0
        return self._poll_deadline()

    def fire_due(self, now: float) -> None:
        d = self.next_deadline()
        if d is None or now < d:
            return
        # Only the poll deadline proper restarts the poll timer; a
        # completion wake drains results and leaves it where it was.
        poll = self._poll_deadline()
        self._poll_collect()
        if poll is not None and now >= poll:
            self._last_poll = now

    def on_finish(self, out: fn.Collector):
        self.flush_in_flight()

    def snapshot_state(self):
        # Emit everything in flight before a snapshot is taken.
        self.flush_in_flight()
        return None


class FrozenGraph(torch.nn.Module):
    """A loaded frozen graph as a model's params: it owns no parameter or
    buffer (the program's weights are its constants), so the runner's
    ``.to()`` and ``.eval()`` leave it as it is, and a deep copy shares the
    read-only program (already on the subtask's device)."""

    def __init__(self, program: typing.Callable):
        super().__init__()
        object.__setattr__(self, "program", program)

    def __deepcopy__(self, memo):
        return self


def graph_model(source: typing.Union[str, bytes], *, input_schema, needs_lengths: bool,
                device) -> Model:
    """A frozen graph loaded onto ``device`` as a :class:`Model` with one
    method, ``serve``, that calls the program."""
    frozen = FrozenGraph(GraphLoader(source).load(device))

    def serve(module: FrozenGraph, inputs, lengths=None):
        return module.program(inputs, lengths) if needs_lengths else module.program(inputs)

    method = ModelMethod("serve", input_schema, (), serve, needs_lengths=needs_lengths)
    return Model("frozen_graph", frozen, {"serve": method})


class _GraphFunctionBase:
    """Runs a frozen graph (``models.loaders.freeze_method``) instead of a
    model, through the same runner, ring and lanes as the Model functions
    (JAX ``_GraphFunctionBase``, ``:728``).  A frozen graph is specialised
    to one batch and one length bucket, so the batch policy is forced to
    them: ``BucketPolicy(fixed_batch=batch,
    lengths=BucketLadder([length_bucket]))``.  Each subtask loads the graph
    onto its device at ``open()``."""

    def __init__(self, graph: typing.Union[str, bytes], *, batch: int, input_schema,
                 needs_lengths: bool = False, length_bucket: int = 128, **kw):
        self._graph_source = graph
        self._graph_schema = input_schema
        self._needs_lengths = needs_lengths
        kw["policy"] = BucketPolicy(fixed_batch=batch, lengths=BucketLadder([length_bucket]))
        kw.setdefault("warmup_length_bucket", length_bucket)
        super().__init__(None, "serve", **kw)

    def output_schema(self, input_schema):
        """Checks the incoming schema against the graph's declared inputs;
        the output shapes live inside the frozen program: unknown here."""
        if input_schema is not None:
            check_compatible(self._graph_schema, input_schema, where="frozen graph inputs")
        return None

    def open(self, ctx) -> None:
        device = resolve_device(getattr(ctx, "device", None))
        self._source = lambda: graph_model(self._graph_source, input_schema=self._graph_schema,
                                           needs_lengths=self._needs_lengths, device=device)
        super().open(ctx)


class GraphWindowFunction(_GraphFunctionBase, ModelWindowFunction):
    """A fired window through a frozen graph: one call per ``batch``
    records (a larger window is chunked, a smaller one padded).  Takes
    :class:`ModelWindowFunction`'s options besides the policy."""


class GraphMapFunction(_GraphFunctionBase, ModelMapFunction):
    """Per-record inference over a frozen graph of batch 1, pipelined: up
    to ``pipeline_depth`` records in flight, results in arrival order, a
    lull drained after ``idle_flush_s``, everything flushed at the end of
    input and before a barrier (JAX ``GraphMapFunction``, ``:785``)."""

    def __init__(self, graph, *, input_schema, needs_lengths: bool = False,
                 length_bucket: int = 128, pipeline_depth: int = 4,
                 idle_flush_s: float = 0.01, **kw):
        super().__init__(graph, batch=1, input_schema=input_schema,
                         needs_lengths=needs_lengths, length_bucket=length_bucket,
                         micro_batch=1, pipeline_depth=pipeline_depth,
                         idle_flush_s=idle_flush_s, **kw)


class DeviceMapFunction(fn.MapFunction):
    """Elementwise map on the device: the resident link of a chain.

    Wraps a torch ``dict -> dict`` callable over ``[B, ...]`` tensors.
    Fed a :class:`~flink_tensorflow_tpu_torch.tensors.transfer.DeviceBatch`
    (fused behind a device-resident model), it runs on the batch where it
    lies, on its own stream after the producer's, and passes a
    DeviceBatch on: the hop moves no bytes across the bus.  Fed a host
    record, it lifts the record to a batch of one on its device and
    returns a host record (counted as one ``h2d_batches`` and one
    ``d2h_batches``): the same answer, another residency.  The callable
    runs as written, under ``inference_mode``; it must not keep state."""

    device_capable = True
    accepts_device_batches = True

    def __init__(self, tensor_fn: typing.Callable[[typing.Mapping[str, torch.Tensor]],
                                                  typing.Mapping[str, torch.Tensor]]):
        self._fn = tensor_fn
        self.device: typing.Optional[torch.device] = None
        self._stream: typing.Optional[torch.cuda.Stream] = None
        self._metrics = None

    def clone(self) -> "fn.Function":
        import copy

        dup = copy.copy(self)
        dup._stream = None
        return dup

    def open(self, ctx) -> None:
        self.device = resolve_device(getattr(ctx, "device", None))
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
        self._metrics = getattr(ctx, "metrics", None)

    def close(self) -> None:
        self._stream = None

    def map(self, value):
        if getattr(value, "is_device_batch", False):
            return self._map_batch(value)
        if not isinstance(value, TensorValue):
            raise TypeError(f"DeviceMapFunction maps tensor records, got {type(value).__name__}")
        lifted = {n: torch.from_numpy(np.array(a)[None]).to(self.device)
                  for n, a in value.fields.items()}
        with torch.inference_mode():
            out = self._fn(lifted)
        host = {n: t[0].detach().cpu().numpy() for n, t in out.items()}
        m = self._metrics
        if m is not None:
            m.counter("h2d_batches").inc()
            m.counter("h2d_bytes").inc(sum(a.nbytes for a in value.fields.values()))
            m.counter("d2h_batches").inc()
            m.counter("d2h_bytes").inc(sum(a.nbytes for a in host.values()))
        return TensorValue(host, value.meta)

    def _map_batch(self, batch: DeviceBatch) -> DeviceBatch:
        stream = (torch.cuda.stream(self._stream) if self._stream is not None
                  else contextlib.nullcontext())
        ready = None
        with stream, torch.inference_mode():
            batch.wait_on(self._stream)
            out = self._fn({n: t.to(self.device) for n, t in batch.tensors.items()})
            if self._stream is not None:
                ready = torch.cuda.Event(blocking=True)
                ready.record(self._stream)
        return DeviceBatch(out, batch.valid, batch.metas, timestamp=batch.timestamp,
                           ready=ready, metrics=self._metrics)
