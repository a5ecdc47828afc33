"""Training as stream operators — online SGD and data-parallel gangs.

Port of ``flink_tensorflow_tpu/functions/training_function.py``
(``:52-563``):

- :class:`OnlineTrainFunction`: per-record/mini-batch SGD inside a
  (keyed) ProcessFunction — the Wide&Deep shape.  The TrainState is
  explicit function state (``scope="subtask"``) or keyed state
  (``scope="key"``), so checkpoint barriers snapshot params and optimizer
  natively.
- :class:`DPTrainWindowFunction`: a gang operator — parallelism 1, owning
  the mesh; each fired window is one train step — the ResNet shape.

Both run on ``cuda`` unless the caller asks for the CPU: the online
function on the job's device for its subtask (``set_device_provider``),
the gang on its mesh (``env.set_mesh(make_mesh({"data": 1}))``).  While
one is open on the card, cuDNN's timed algorithm search is held off
(``runner.hold_cudnn_heuristics``), so the subtask thread and any direct
call run the same algorithms.

Steps are dispatched without waiting: each step's metrics stay on the
device until ``pipeline_depth`` steps later, and the host counts steps
itself, so the hot path never reads a device value.  A barrier never
cuts a step: the operator snapshots between calls, after running staged
mini-batches and emitting every in-flight metric.  Snapshots are host
COPIES of the state (the gang updates its state in place, and on the CPU
``.cpu()`` would return the live tensors themselves).

The plan-time hooks (JAX ``:183-192``, ``:450-456``): ``output_schema``
checks the incoming schema against ``train_schema`` (the analyzer's
``schema-mismatch`` on the edge) and stops propagation (the per-step
metrics records are the function's own); ``plan_policy`` is the fixed
batch policy; ``is_jit_boundary`` marks the train step's call.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import time
import typing

import numpy as np
import torch

from flink_tensorflow_tpu_torch.core import functions as fn
from flink_tensorflow_tpu_torch.core.operators import StateNotRescalable
from flink_tensorflow_tpu_torch.core.state import StateDescriptor
from flink_tensorflow_tpu_torch.functions.runner import (
    hold_cudnn_heuristics,
    release_cudnn_heuristics,
)
from flink_tensorflow_tpu_torch.models.zoo.registry import ModelDef
from flink_tensorflow_tpu_torch.ops.batch_norm import batch_norm_train
from flink_tensorflow_tpu_torch.parallel import dp
from flink_tensorflow_tpu_torch.parallel.mesh import replicate, shard_batch, spans_processes
from flink_tensorflow_tpu_torch.parallel.optim import sgd
from flink_tensorflow_tpu_torch.tensors.batching import BucketPolicy, assemble
from flink_tensorflow_tpu_torch.tensors.coercion import coerce
from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, check_compatible
from flink_tensorflow_tpu_torch.tensors.value import TensorValue
from flink_tensorflow_tpu_torch.tracing.device_clock import DeviceClock, StreamTimeline, place, tile
from flink_tensorflow_tpu_torch.utils.device import resolve_device


def _host_copy(tree):
    """A host copy of every tensor in ``tree`` (never a view of it)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    return tree


def _on_device(tree, device: torch.device):
    """``tree`` with its tensors on ``device`` (no copy where they are)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _on_device(v, device) for k, v in tree.items()}
    return tree


def _validate_train_schema(schema: RecordSchema) -> RecordSchema:
    """The batch dict synthesizes ``<field>_len`` (dynamic fields) and
    ``valid`` keys; schema fields with those names would be silently
    clobbered — reject them at construction."""
    for name in schema.names:
        if name == "valid":
            raise ValueError(
                "train_schema field 'valid' collides with the synthesized "
                "batch-validity mask — rename the feature")
        if any(d is None for d in schema[name].shape) and f"{name}_len" in schema.names:
            raise ValueError(
                f"train_schema field {name + '_len'!r} collides with the "
                f"synthesized length array for dynamic field {name!r} — rename the feature")
    return schema


def _train_batch_arrays(records, schema: RecordSchema, policy: BucketPolicy):
    """Assemble training records -> ``(batch, arrays)`` with labels, the
    true lengths of dynamic fields as ``<field>_len`` and the ``valid``
    mask as f32 (pad rows replay record 0; the loss weights them out)."""
    tvs = [r if isinstance(r, TensorValue) else coerce(r, schema) for r in records]
    batch = assemble(tvs, schema, policy)
    arrays = dict(batch.arrays)
    for name, lengths in batch.lengths.items():
        arrays[f"{name}_len"] = lengths
    arrays["valid"] = batch.valid.astype(np.float32)
    return batch, arrays


def _to_device(arrays: typing.Mapping[str, np.ndarray], device: torch.device):
    return {n: torch.from_numpy(np.ascontiguousarray(a)).to(device, non_blocking=True)
            for n, a in arrays.items()}


class _CudnnHold:
    """Holds cuDNN's heuristic algorithm choice while a card is in use."""

    def __init__(self) -> None:
        self.held = False

    def acquire(self, device: torch.device) -> None:
        if device.type == "cuda" and not self.held:
            hold_cudnn_heuristics()
            self.held = True

    def release(self) -> None:
        if self.held:
            release_cudnn_heuristics()
            self.held = False


class OnlineTrainFunction(fn.ProcessFunction):
    """Per-key (or per-subtask) online SGD on a keyed stream.

    ``scope="subtask"`` (default): one TrainState per operator subtask —
    keys partition the data, the model is shared within the subtask.
    ``scope="key"``: one TrainState per key in keyed state — a model per
    key.  Emits one metrics record per mini-batch:
    ``TensorValue({"loss", "accuracy", "step"}, meta={"key": key})``.

    ``pipeline_depth``: steps in flight before their metrics are fetched.
    ``steps_per_dispatch``: mini-batches staged per key and run in one
    call (:func:`parallel.dp.make_multi_train_step`, exactly the
    sequential steps); a partial chunk runs step by step at end of input
    and before a snapshot."""

    #: Records feed the train step's call (the plan analyzer's boundary).
    is_jit_boundary = True
    #: The step returns a new TrainState and the old one stays live until
    #: its in-flight steps are fetched (``make_train_step(inplace=False)``),
    #: as the reference's undonated step: statecheck's train-state audit
    #: reads this.
    donates_train_state = False

    def __init__(self, model_def: ModelDef, optimizer=None, *, train_schema: RecordSchema,
                 scope: str = "subtask", mini_batch: int = 1, seed: int = 0,
                 pipeline_depth: int = 4, steps_per_dispatch: int = 1):
        if scope not in ("subtask", "key"):
            raise ValueError(f"scope must be 'subtask' or 'key', got {scope!r}")
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        if steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        self.model_def = model_def
        self.optimizer = optimizer
        self.train_schema = _validate_train_schema(train_schema)
        self.scope = scope
        self.mini_batch = mini_batch
        self.seed = seed
        self.pipeline_depth = pipeline_depth
        self.steps_per_dispatch = steps_per_dispatch
        self._policy = BucketPolicy(fixed_batch=mini_batch)
        self._reset()

    def _reset(self) -> None:
        self.ctx = None
        self.device: typing.Optional[torch.device] = None
        self._step_fn = None
        self._multi_fn = None
        self._cudnn = _CudnnHold()
        #: Per-key staged mini-batch arrays awaiting a fused dispatch.
        self._staged: typing.Dict[typing.Any, list] = {}
        self._state = None        # subtask scope
        self._key_state = None    # key scope (ValueState)
        self._buffers: typing.Dict[typing.Any, list] = {}
        #: In-flight (key, device metrics, first step, record counts, fused).
        self._pending: typing.Deque = collections.deque()
        #: Host step counters per key (None for subtask scope): the device
        #: ``state["step"]`` is never read on the hot path.
        self._steps: typing.Dict[typing.Any, int] = {}
        self._out: typing.Optional[fn.Collector] = None

    def clone(self):
        dup = copy.copy(self)
        dup._reset()
        return dup

    # -- lifecycle ---------------------------------------------------------
    # -- plan-time hooks ---------------------------------------------------
    def output_schema(self, input_schema):
        """Incoming records must satisfy the train schema; the emitted
        per-step metrics records are the function's own: unknown here."""
        if input_schema is not None:
            check_compatible(self.train_schema, input_schema, where="train_schema")
        return None

    def plan_policy(self) -> BucketPolicy:
        return self._policy

    def open(self, ctx) -> None:
        self.ctx = ctx
        self.device = resolve_device(ctx.device)
        if self.device.type == "cuda" and self.device.index is None:
            # As the state's tensors name it, so a step compares equal.
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._cudnn.acquire(self.device)
        if self.device.type == "cuda":
            # A restart must find the failed attempt's state released.
            ctx.metrics.histogram("device_bytes_at_open").record(
                torch.cuda.memory_allocated(self.device))
        optimizer = self.optimizer or sgd(0.01)
        self.optimizer = optimizer
        self._step_fn = dp.make_train_step(self.model_def, optimizer)
        if self.steps_per_dispatch > 1:
            self._multi_fn = dp.make_multi_train_step(self.model_def, optimizer)
        seed = dp.fold_in(self.seed, ctx.subtask_index)
        self._init = lambda: dp.init_train_state(self.model_def, optimizer, seed)
        if self.scope == "subtask":
            if self._state is None:  # not restored
                self._state = self._init()
        else:
            self._key_state = ctx.state(StateDescriptor("train_state"))

    def close(self) -> None:
        # The final state stays readable (current_params) from the host;
        # the device copy goes with the operator.
        if self._state is not None:
            self._state = _host_copy(self._state)
        self._cudnn.release()

    # -- processing --------------------------------------------------------
    def process_element(self, value, ctx, out: fn.Collector) -> None:
        self._out = out
        key = ctx.current_key
        buf = self._buffers.setdefault(key, [])
        buf.append(value)
        if len(buf) >= self.mini_batch:
            self._buffers[key] = []
            self._train(key, buf, out)

    def on_finish(self, out: fn.Collector) -> None:
        """Flush partial mini-batches: the valid-mask-weighted loss keeps
        pad rows out of the gradient, so short batches train correctly."""
        for key, buf in list(self._buffers.items()):
            if buf:
                self._buffers[key] = []
                self._train(key, buf, out)
        self._flush_staged()
        self._drain_pending(out, 0)

    def _train(self, key, records, out: fn.Collector) -> None:
        _, arrays = _train_batch_arrays(records, self.train_schema, self._policy)
        if self.steps_per_dispatch > 1:
            staged = self._staged.setdefault(key, [])
            staged.append((arrays, len(records)))
            if len(staged) >= self.steps_per_dispatch:
                self._staged[key] = []
                self._run_steps(key, staged, out)
            return
        self._run_steps(key, [(arrays, len(records))], out)

    def _flush_staged(self) -> None:
        """Run staged mini-batches (end of input / barrier) one step at a
        time; their metrics ride ``_pending``."""
        for key, staged in list(self._staged.items()):
            if staged:
                self._staged[key] = []
                for arrays, n in staged:
                    self._run_steps_fused(key, [(arrays, n)], fused=False)

    def _run_steps(self, key, chunk, out: fn.Collector) -> None:
        self._run_steps_fused(key, chunk, fused=len(chunk) > 1)
        self._drain_pending(out, self.pipeline_depth - 1)

    def _run_steps_fused(self, key, chunk, *, fused: bool) -> None:
        """Dispatch ``chunk`` (a list of ``(arrays, n)``) as one call: the
        multi-step over the stacked batches when fused, the single step
        otherwise.  Results are queued on ``_pending``."""
        # Scope keyed state to THIS key (on_finish flushes several keys
        # outside the per-element current-key window).
        scope = self.ctx.with_key(key) if self.scope == "key" else contextlib.nullcontext()
        counter_key = key if self.scope == "key" else None
        with scope:
            if self.scope == "key":
                state = self._key_state.value()
                if state is None:
                    state = self._init()
            else:
                state = self._state
            if counter_key not in self._steps:
                # First touch: the state is a fresh init or a restored
                # snapshot on the host, so this read costs nothing.
                self._steps[counter_key] = int(state["step"])
            if dp.state_device(state) != self.device:
                state = _on_device(state, self.device)
            done = self._steps[counter_key]
            if fused:
                stacked = _to_device({name: np.stack([arrays[name] for arrays, _ in chunk])
                                      for name in chunk[0][0]}, self.device)
                state, metrics = self._multi_fn(state, stacked, done)
            else:
                state, metrics = self._step_fn(state, _to_device(chunk[0][0], self.device), done)
            if self.scope == "key":
                self._key_state.update(state)
            else:
                self._state = state
        self._steps[counter_key] = done + len(chunk)
        self._pending.append((key, metrics, done + 1, [n for _, n in chunk], fused))

    def _drain_pending(self, out: fn.Collector, keep: int) -> None:
        while len(self._pending) > keep:
            key, metrics, first, counts, fused = self._pending.popleft()
            host = {k: v.cpu().numpy() for k, v in metrics.items()}
            for i, n in enumerate(counts):
                row = {k: (v[i] if fused else v) for k, v in host.items()}
                row["step"] = np.asarray(first + i, np.int64)
                out.collect(TensorValue(row, meta={"key": key}))
                if self.ctx is not None:
                    self.ctx.metrics.meter("train_records").mark(n)
                    self.ctx.metrics.counter("train_steps").inc()

    # -- snapshot (params ARE operator state) ------------------------------
    def snapshot_state(self):
        # Run staged mini-batches and emit all in-flight metrics BEFORE the
        # snapshot: their records precede the barrier, so a replay after
        # restore never regenerates them, and the state must hold their
        # steps.  Keyed scope rides the keyed-state snapshot (the runtime
        # copies device tensors to the host; states are never updated in
        # place, so a CPU state shared with the snapshot stays as it was).
        self._flush_staged()
        if self._pending and self._out is not None:
            self._drain_pending(self._out, 0)
        # The order in which keys first staged a mini-batch is state too:
        # the next barrier or end of input runs staged chunks key by key
        # in that order, which orders the steps of a subtask's shared
        # model.  (The reference restarts it empty after a restore, so a
        # restored run can order those steps unlike an uninterrupted one.)
        return {
            "state": _host_copy(self._state) if self._state is not None else None,
            "buffers": {k: list(v) for k, v in self._buffers.items()},
            "staged_keys": list(self._staged),
        }

    def restore_state(self, snap) -> None:
        self._state = snap["state"]
        self._buffers = {k: list(v) for k, v in snap["buffers"].items()}
        self._staged = {k: [] for k in snap["staged_keys"]}
        self._steps = {}  # re-read from the (host) restored state at first touch
        self._pending.clear()

    def rescale_state(self, states, mine):
        """Restore with changed parallelism: per-key mini-batch buffers
        redistribute by key group; a subtask-scoped TrainState cannot
        (every subtask owns an independent model replica)."""
        if any(s and s.get("state") is not None for s in states):
            raise StateNotRescalable(
                "OnlineTrainFunction(scope='subtask') keeps one model per "
                "subtask — rescaling would drop or duplicate replicas; use "
                "scope='key' or keep the operator's parallelism fixed")
        buffers: typing.Dict[typing.Any, list] = {}
        staged_keys: typing.List[typing.Any] = []
        for s in states:
            if not s:
                continue
            for key, buf in s["buffers"].items():
                if mine(key):
                    buffers.setdefault(key, []).extend(buf)
            staged_keys.extend(k for k in s["staged_keys"] if mine(k))
        return {"state": None, "buffers": buffers, "staged_keys": staged_keys}

    def current_params(self, key=None):
        """Latest variables, a host copy (for export)."""
        if self.scope == "key":
            raise ValueError("pass through keyed state for per-key params")
        return _host_copy(self._state["variables"])


class DPTrainWindowFunction(fn.WindowFunction):
    """Gang operator: each fired window is one data-parallel train step
    on the mesh.

    Use with parallelism 1 on a single-process executor — the gang owns
    the mesh (``env.set_mesh``) — or, on a ``DistributedExecutor``, with
    parallelism equal to ``num_processes``: one subtask per process, so
    every process joins the collective step (JAX
    ``functions/training_function.py:470-485``).
    The window is the global batch, padded to ``global_batch`` (which the
    mesh's data axis must divide).  The state is updated in place on the
    mesh device (the reference donates it).

    **Across processes** (a mesh over a ``torch.distributed`` cohort,
    ``parallel.multihost``; the reference's manual pattern,
    ``examples/multihost_dp_train.py`` worker mode): every process runs
    the same job with this gang at parallelism 1 on its own executor and
    feeds its own partition, ``global_batch // num_processes`` records per
    window (size the count window so).  Every process must fire the same
    number of windows, so feed equal partitions, and checkpoints must land
    at the same step on every process: use count-based triggers
    (``every_n_records``), which cut each partition at the same record.

    **Traced** (``ctx.tracer``), each step records on the subtask's track
    ``train.assemble`` (the records stacked into arrays), ``train.ship``
    (``shard_batch``), ``train.launch`` (the step's forward, backward and
    optimizer launches; its ``bn_launches`` arg counts the fused batch
    norm's, ``ops.batch_norm``), which tile ``step_dispatch_s``, and when its
    metrics are drained ``train.drain`` (the wait for them on the host)
    and ``train.emit`` (``out.collect``), with the histograms
    ``step_assemble_s``, ``step_ship_s``, ``step_launch_s`` and
    ``loss_wait_s``.  On the card a timing event goes onto the step's
    stream just before its H2D and one after its launches; once the drain
    has waited for the step (which it does anyway), the step is a
    ``device`` span on ``<track>.device``, and where the stream sat idle
    before it, a ``device.idle`` span names this thread's span when the
    stream went idle (``window``: between ``process_window`` calls) and
    ``step_gap_s`` takes the idle seconds (``tracing/device_clock.py``)."""

    #: The traced step's host spans that tile ``step_dispatch_s``, and
    #: their histograms.
    STEP_SPANS = ("train.assemble", "train.ship", "train.launch")
    STEP_HISTOGRAMS = ("step_assemble_s", "step_ship_s", "step_launch_s")

    #: The gang owns the mesh and blocks in its step: the chaining pass
    #: never fuses it with a neighbour (``analysis/chaining.py``).
    is_jit_boundary = True
    is_gang = True
    #: ``make_dp_train_step`` updates the state's tensors in place (the
    #: port's form of the reference's donated state): statecheck's
    #: train-state audit reads this.
    donates_train_state = True

    def __init__(self, model_def: ModelDef, optimizer=None, *, train_schema: RecordSchema,
                 global_batch: int, seed: int = 0, pipeline_depth: int = 2):
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        self.model_def = model_def
        self.optimizer = optimizer
        self.train_schema = _validate_train_schema(train_schema)
        self.global_batch = global_batch
        self.seed = seed
        #: Steps whose METRICS are still in flight: the next window's
        #: assembly and transfer overlap this step's device work.
        self.pipeline_depth = pipeline_depth
        self._policy = BucketPolicy(fixed_batch=global_batch)
        self._restored = None
        self._reset()

    def _reset(self) -> None:
        self.ctx = None
        self.mesh = None
        self._step_fn = None
        self._state = None
        self._pending: typing.Deque = collections.deque()
        self._step_no = 0
        self._out: typing.Optional[fn.Collector] = None
        self._cudnn = _CudnnHold()
        #: Traced: the tracer, this subtask's track, the recent host spans
        #: (a device gap's stage is read from them), and on the card the
        #: device clock and the step stream's timeline.
        self._tracer = None
        self._track: typing.Optional[str] = None
        self._host_spans: typing.Deque[typing.Tuple[str, float, float]] = collections.deque(
            maxlen=64)
        self._clock: typing.Optional[DeviceClock] = None
        self._timeline: typing.Optional[StreamTimeline] = None

    def clone(self):
        dup = copy.copy(self)
        dup._reset()
        return dup

    # -- plan-time hooks ---------------------------------------------------
    def output_schema(self, input_schema):
        """Incoming records must satisfy the train schema; the emitted
        per-step metrics records are the function's own: unknown here."""
        if input_schema is not None:
            check_compatible(self.train_schema, input_schema, where="train_schema")
        return None

    def plan_policy(self) -> BucketPolicy:
        return self._policy

    def open(self, ctx) -> None:
        if ctx.mesh is None:
            raise RuntimeError(
                "DPTrainWindowFunction needs env.set_mesh(...) — the gang owns the mesh")
        # Valid placements: parallelism 1 on a single-process executor
        # (one such executor per process in the manual pattern), or one
        # subtask per process on a record-plane cohort.  Anything else
        # leaves a process out of the collective step, which then hangs.
        if ctx.parallelism != ctx.num_processes:
            raise RuntimeError(
                f"gang operator parallelism must be {ctx.num_processes} (num_processes="
                f"{ctx.num_processes}) so every process joins the collective step; "
                f"got {ctx.parallelism}")
        self.ctx = ctx
        self.mesh = ctx.mesh
        data_size = self.mesh.shape.get("data", 1)
        if self.global_batch % data_size:
            raise ValueError(
                f"global_batch {self.global_batch} must be divisible by the "
                f"data-axis size {data_size}")
        n_proc = self.mesh.size if spans_processes(self.mesh) else 1
        if self.global_batch % n_proc:
            raise ValueError(
                f"global_batch {self.global_batch} must be divisible by the "
                f"process count {n_proc}")
        # Each process assembles only its rows of the global batch.
        self._policy = BucketPolicy(fixed_batch=self.global_batch // n_proc)
        optimizer = self.optimizer or sgd(0.01)
        self.optimizer = optimizer
        self._cudnn.acquire(self.mesh.device)
        self._step_fn = dp.make_dp_train_step(self.model_def, optimizer, self.mesh)
        state = self._restored or dp.init_train_state(self.model_def, optimizer, self.seed)
        self._restored = None
        # Read on the host (fresh init or restored snapshot); the device
        # step counter is never read after this.
        self._step_no = int(state["step"])
        self._state = replicate(self.mesh, state)
        self._tracer = getattr(ctx, "tracer", None)
        if self._tracer is not None:
            self._track = f"{ctx.task_name}.{ctx.subtask_index}"
            if self.mesh.device.type == "cuda":
                self._clock = DeviceClock.on(self.mesh.device)
                self._timeline = StreamTimeline()

    def close(self) -> None:
        if self._state is not None:
            self._state = _host_copy(self._state)
        self._cudnn.release()

    def process_window(self, key, window, elements, out: fn.Collector) -> None:
        self._out = out
        traced = self._tracer is not None
        t0 = time.monotonic()
        _, arrays = _train_batch_arrays(list(elements), self.train_schema, self._policy)
        if traced:
            stamps = [t0, time.monotonic()]
            started = self._step_event()
        batch = shard_batch(self.mesh, arrays)
        if traced:
            stamps.append(time.monotonic())
            bn0 = batch_norm_train.launches
        # Dispatch and go: the step is queued on the device; its metrics
        # are read pipeline_depth windows later.
        self._state, metrics = self._step_fn(self._state, batch, self._step_no)
        events = (started, self._step_event()) if traced and started is not None else None
        t1 = time.monotonic()
        # Host seconds to assemble, ship and launch the step.
        self.ctx.metrics.histogram("step_dispatch_s").record(t1 - t0)
        self._step_no += 1
        if traced:
            self._trace_dispatch(stamps + [t1], batch_norm_train.launches - bn0)
        self._pending.append((metrics, self._step_no, len(elements), events))
        self._drain(out, self.pipeline_depth - 1)

    def _drain(self, out: fn.Collector, keep: int) -> None:
        while len(self._pending) > keep:
            metrics, step_no, n, events = self._pending.popleft()
            traced = self._tracer is not None
            if traced:
                t0 = time.monotonic()
            host = {k: v.cpu().numpy() for k, v in metrics.items()}
            host["step"] = np.asarray(step_no, np.int64)
            if traced:
                t1 = time.monotonic()
            out.collect(TensorValue(host))
            if traced:
                self._trace_drain(step_no, events, t0, t1, time.monotonic())
            self.ctx.metrics.meter("train_records").mark(n)
            self.ctx.metrics.counter("train_steps").inc()

    # -- tracing (``ctx.tracer`` only) -------------------------------------
    def _step_event(self):
        """A timing event on the step's stream (traced on the card), else
        None."""
        if self._clock is None:
            return None
        return DeviceClock.record(torch.cuda.current_stream(self.mesh.device))

    def _host_span(self, name: str, t0: float, t1: float, args: dict) -> None:
        self._tracer.span(self._track, name, t0, t1, args=args)
        self._host_spans.append((name, t0, t1))

    def _trace_dispatch(self, stamps, bn_launches: int) -> None:
        """The step's three host spans and their histograms, cut at the
        stamps of its ``step_dispatch_s``; ``train.launch`` also carries
        the step's launches of the fused batch norm (``bn_launches``)."""
        args = {"step": self._step_no}
        for (name, a, b), hist in zip(tile(self.STEP_SPANS, stamps), self.STEP_HISTOGRAMS):
            if name == "train.launch":
                args = {**args, "bn_launches": bn_launches}
            self._host_span(name, a, b, args)
            self.ctx.metrics.histogram(hist).record(b - a)

    def _trace_drain(self, step_no: int, events, t0: float, t1: float, t2: float) -> None:
        """A drained step's ``train.drain`` (``t0``-``t1``, its loss wait)
        and ``train.emit`` spans, and on the card its device span.  The
        copy of its metrics to the host waited for every step launched so
        far, so its events have completed."""
        args = {"step": step_no}
        self._host_span("train.drain", t0, t1, args)
        self._host_span("train.emit", t1, t2, args)
        m = self.ctx.metrics
        m.histogram("loss_wait_s").record(t1 - t0)
        if events is not None:
            _, gap = place(self._clock, self._timeline, events[0], events[1], self._host_spans,
                           self._tracer, self._track, args)
            if gap is not None:
                m.histogram("step_gap_s").record(gap)

    def on_finish(self, out: fn.Collector) -> None:
        self._drain(out, 0)

    def snapshot_state(self):
        # Emit in-flight metrics before the barrier (their records precede
        # it and never replay), then copy the state, which the next step
        # would otherwise update under the snapshot.
        if self._pending and self._out is not None:
            self._drain(self._out, 0)
        return {"state": _host_copy(self._state) if self._state is not None else None}

    def restore_state(self, snap) -> None:
        # Restore runs before open(); open() places the state on the mesh.
        self._restored = snap["state"]

    def current_params(self):
        return _host_copy(self._state["variables"])
