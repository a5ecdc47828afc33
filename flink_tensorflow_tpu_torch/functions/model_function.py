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

Both functions poll for finished batches on a timer while batches are in
flight.  Unlike the reference (``:420``), a fire that only drains a
completed batch (a completion wake, deadline 0.0) does not restart that
timer: only the idle deadline proper does, so completions in a lull never
push out the dispatch of a buffered partial micro-batch.

Options of the reference that this port does not have yet raise
``NotImplementedError`` instead of being ignored: the zero-copy
``TensorRing`` path (``use_ring=True``), ``transfer_lanes > 1``,
``wire_dtype``, ``device_resident`` and ``stamp_stages``.
"""

from __future__ import annotations

import time
import typing

from flink_tensorflow_tpu_torch.core import functions as fn
from flink_tensorflow_tpu_torch.functions.runner import CompiledMethodRunner
from flink_tensorflow_tpu_torch.models.base import Model
from flink_tensorflow_tpu_torch.models.loaders import SavedModelLoader
from flink_tensorflow_tpu_torch.tensors.batching import BucketLadder, BucketPolicy

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
        if device_resident:
            raise _not_ported("device_resident", "results always return to the host")
        if wire_dtype is not None:
            raise _not_ported("wire_dtype", "the H2D ships the schema's dtype")
        self._source = model
        self._method_name = method
        self._policy = policy
        self._warmup = tuple(warmup_batches)
        self._warmup_length_bucket = warmup_length_bucket
        self._outputs = outputs
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

    def process_window(self, key, window, elements, out: fn.Collector):
        elements = list(elements)
        self._out = out
        policy = self.runner.policy
        cap = policy.fixed_batch or policy.batch.sizes[-1]
        for i in range(0, len(elements), cap):
            self.runner.dispatch(elements[i:i + cap])
            for record in self.runner.collect_progress(self._max_in_flight):
                out.collect(record)
        self._last_dispatch = time.monotonic()

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
        for record in self.runner.flush():
            out.collect(record)

    def snapshot_state(self):
        # Emit everything in flight before a snapshot is taken.
        if self.runner is not None and self._out is not None:
            for record in self.runner.flush():
                self._out.collect(record)
        return None
