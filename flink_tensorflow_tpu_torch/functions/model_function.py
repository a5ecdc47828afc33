"""ModelWindowFunction and ModelMapFunction — models as stream operators.

Port of ``flink_tensorflow_tpu/functions/model_function.py``: the model
source resolver (``_resolve``, ``:48-58``), ``_ModelFunctionBase``
(``:60``, ``open`` ``:239``), ``ModelMapFunction`` (``:282-430``) and
``ModelWindowFunction`` (``:442``) on the list path (``process_window``
``:607``, timer hooks ``:689-716``).  A model source is a ``Model``, a
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

Options of the reference that this port does not have yet raise
``NotImplementedError`` instead of being ignored: the zero-copy
``TensorRing`` path (``use_ring=True``), ``transfer_lanes > 1``,
``wire_dtype`` and ``stamp_stages``.
"""

from __future__ import annotations

import collections
import contextlib
import time
import typing

import numpy as np
import torch

from flink_tensorflow_tpu_torch.core import functions as fn
from flink_tensorflow_tpu_torch.functions.runner import CompiledMethodRunner
from flink_tensorflow_tpu_torch.models.base import Model
from flink_tensorflow_tpu_torch.models.loaders import SavedModelLoader
from flink_tensorflow_tpu_torch.tensors.batching import BucketLadder, BucketPolicy
from flink_tensorflow_tpu_torch.tensors.transfer import DeviceBatch
from flink_tensorflow_tpu_torch.tensors.value import TensorValue
from flink_tensorflow_tpu_torch.utils.device import resolve_device

ModelSource = typing.Union[Model, str, SavedModelLoader, typing.Callable[[], Model]]


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


def _not_ported(option: str, reason: str) -> NotImplementedError:
    return NotImplementedError(f"{option} is not ported to the PyTorch port yet: {reason}")


class _ModelFunctionBase(fn.RichFunction):
    #: Residency markers (``analysis/chaining.py`` and the executor): the
    #: function can produce device batches, and consume them.
    device_capable = True
    accepts_device_batches = True

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
    ):
        if transfer_lanes != 1:
            raise _not_ported("transfer_lanes > 1", "the runner has one transfer lane pair")
        if stamp_stages:
            raise _not_ported("stamp_stages", "per-record stage stamps are not recorded")
        if wire_dtype is not None:
            raise _not_ported("wire_dtype", "the H2D ships the schema's dtype")
        self._source = model
        self._method_name = method
        self._policy = policy
        self._warmup = tuple(warmup_batches)
        self._warmup_length_bucket = warmup_length_bucket
        self._outputs = outputs
        #: True forces device-batch output, False forbids it, None follows
        #: JobConfig.device_resident where the next fused operator
        #: consumes device batches (``_device_chain_hint``, set by the
        #: executor).
        self._device_resident = device_resident
        self._device_chain_hint = False
        self.runner: typing.Optional[CompiledMethodRunner] = None
        self._out: typing.Optional[fn.Collector] = None

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

    def open(self, ctx) -> None:
        model = _resolve(self._source)
        self.runner = CompiledMethodRunner(model, self._method_name, policy=self._policy,
                                           output_names=self._outputs)
        self.runner.open(ctx)
        # Leaving results on the device pays only where the next fused
        # operator consumes them: into a host consumer it would move the
        # same D2H onto the subtask thread.
        if self._device_resident is not None:
            self.runner.emit_device_batches = self._device_resident
        else:
            self.runner.emit_device_batches = bool(
                getattr(ctx, "device_resident", False) and self._device_chain_hint)
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
            pipeline_depth = 2
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


class ModelWindowFunction(_ModelFunctionBase, fn.WindowFunction):
    """Micro-batch inference: one device call per fired window (chunked
    when the window exceeds the policy's biggest bucket)."""

    #: A window counts elements: a device batch would count as one, so
    #: device batches materialize before they enter a window.  The
    #: function still produces them for a consumer fused behind it.
    accepts_device_batches = False

    def __init__(self, model, method: str = "serve", *,
                 pipeline_depth: typing.Optional[int] = None,
                 idle_flush_s: float = 0.05,
                 use_ring: typing.Optional[bool] = None,
                 ring_capacity: typing.Optional[int] = None, **kw):
        if use_ring:
            raise _not_ported("use_ring=True", "the zero-copy TensorRing path is a later "
                              "slice; the list path (use_ring=None or False) is the one ported")
        if ring_capacity is not None:
            raise _not_ported("ring_capacity", "the TensorRing path is a later slice")
        super().__init__(model, method, **kw)
        if pipeline_depth is None:
            pipeline_depth = 2
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        self._max_in_flight = pipeline_depth - 1
        self._idle_flush_s = idle_flush_s
        self._last_dispatch: typing.Optional[float] = None
        self._last_poll: typing.Optional[float] = None
        #: Per dispatched batch, oldest first: ``[collector, records
        #: still owed]``.  Results go to the window that dispatched them.
        self._routes: typing.Deque[typing.List[typing.Any]] = collections.deque()

    def clone(self) -> "fn.Function":
        dup = super().clone()
        dup._routes = collections.deque()
        return dup

    def _emit(self, records) -> None:
        for record in records:
            route = self._routes[0]
            route[0].collect(record)
            # A device batch answers all its records at once.
            route[1] -= record.num_records if getattr(record, "is_device_batch", False) else 1
            if route[1] <= 0:
                self._routes.popleft()

    def process_window(self, key, window, elements, out: fn.Collector):
        elements = list(elements)
        policy = self.runner.policy
        cap = policy.fixed_batch or policy.batch.sizes[-1]
        for i in range(0, len(elements), cap):
            chunk = elements[i:i + cap]
            self.runner.dispatch(chunk)
            self._routes.append([out, len(chunk)])
            self._emit(self.runner.collect_progress(self._max_in_flight))
        self._last_dispatch = time.monotonic()

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
