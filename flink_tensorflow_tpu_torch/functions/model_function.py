"""ModelWindowFunction — a model as a windowed stream operator.

Port of ``flink_tensorflow_tpu/functions/model_function.py``:
``_ModelFunctionBase`` (``:60``, ``open`` ``:239``) and
``ModelWindowFunction`` (``:442``) on the list path (``process_window``
``:607``, timer hooks ``:689-716``).  ``open()`` builds a
:class:`~flink_tensorflow_tpu_torch.functions.runner.CompiledMethodRunner`
on the subtask's device (the job's device provider, else the GPU) and
runs the warmup batches; a fired window becomes one device call per
``fixed_batch`` (or largest bucket) chunk, with up to ``pipeline_depth``
batches in flight, so the transfer and launch of window k+1 overlap the
compute of window k.  In-flight batches are flushed at end of input and
before every state snapshot.

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
from flink_tensorflow_tpu_torch.tensors.batching import BucketPolicy


def _not_ported(option: str, reason: str) -> NotImplementedError:
    return NotImplementedError(f"{option} is not ported to the PyTorch port yet: {reason}")


class _ModelFunctionBase(fn.RichFunction):
    def __init__(
        self,
        model: typing.Union[Model, typing.Callable[[], Model]],
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
        model = self._source if isinstance(self._source, Model) else self._source()
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
    def next_deadline(self) -> typing.Optional[float]:
        if self.runner is None:
            return None
        if self.runner.has_completed():
            # Due at once: 0.0 is in the past on the monotonic clock.
            return 0.0
        if not self.runner.in_flight or self._last_dispatch is None:
            return None
        base = self._last_dispatch
        if self._last_poll is not None and self._last_poll > base:
            base = self._last_poll
        return base + self._idle_flush_s

    def fire_due(self, now: float) -> None:
        d = self.next_deadline()
        if d is None or now < d:
            return
        self._poll_collect()
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
