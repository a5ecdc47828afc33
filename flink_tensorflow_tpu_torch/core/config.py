"""Typed job configuration.

Port of ``flink_tensorflow_tpu/core/config.py``: ``CheckpointConfig``
(``:27``) and ``JobConfig`` (``:85``) with the fields the ported runtime
reads, the gang operators' ``mesh`` (``:224``) among them, operator
``chaining`` (``:101-107``), ``device_resident`` (``:153-162``) and
``wire_dtype`` (``:170``, validated as ``:286-292``) with the reference's
defaults, and the record plane's ``wire_flush_bytes``, ``wire_flush_ms``,
``shm_channels``, ``flow_control`` (``:171-206``) and ``distributed``
(``:235-239``), validated as ``:278-322`` validates them: a distributed
job checkpoints with count-based triggers only.  The chaos and sanitizer
planes' ``faults``, ``sanitize`` and ``sanitize_log_path``
(``:108-123``, ``:207-213``; a fault plan is parsed at validation,
``:294``).  The observability planes' ``trace``, ``trace_path``,
``trace_sample_rate``, ``flight_recorder`` and ``flight_path``
(``:125-152``), ``metrics`` (``:241-244``), ``health`` (``:245-253``)
and ``roofline`` (``:254-261``), validated as ``:298-331`` validates
them.
"""

from __future__ import annotations

import dataclasses
import typing

from flink_tensorflow_tpu_torch.core.faults import FaultPlan
from flink_tensorflow_tpu_torch.metrics.health import HealthConfig
from flink_tensorflow_tpu_torch.metrics.reporters import MetricConfig
from flink_tensorflow_tpu_torch.tensors.serde import WIRE_DTYPES


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """Where and how often aligned snapshots persist."""

    #: Directory for persisted snapshots; None disables persistence.
    dir: typing.Optional[str] = None
    #: Periodic trigger interval; None means manual triggers only.
    interval_s: typing.Optional[float] = None
    #: Count-based triggers: each source injects barrier k after its
    #: k*N-th record, so barrier positions are a deterministic function
    #: of the stream.  Mutually exclusive with interval_s; disables manual
    #: triggers.
    every_n_records: typing.Optional[int] = None
    #: Budget for one aligned checkpoint to drain.
    timeout_s: float = 60.0
    #: Keep only the newest N completed checkpoints on disk (Flink's
    #: retained-checkpoints policy); None keeps everything.  Pruning runs
    #: after a newer checkpoint is durable.
    retain_last: typing.Optional[int] = None

    def validate(self) -> None:
        if self.interval_s is not None:
            if self.dir is None:
                raise ValueError("checkpoint.interval_s requires checkpoint.dir")
            if self.interval_s <= 0:
                raise ValueError(f"checkpoint.interval_s must be > 0, got {self.interval_s}")
        if self.every_n_records is not None:
            if self.dir is None:
                raise ValueError("checkpoint.every_n_records requires checkpoint.dir")
            if self.interval_s is not None:
                raise ValueError(
                    "checkpoint.every_n_records and interval_s are mutually "
                    "exclusive (count-based barriers must stay deterministic)")
            if self.every_n_records < 1:
                raise ValueError(
                    f"checkpoint.every_n_records must be >= 1, got {self.every_n_records}")
        if self.timeout_s <= 0:
            raise ValueError(f"checkpoint.timeout_s must be > 0, got {self.timeout_s}")
        if self.retain_last is not None:
            if self.dir is None:
                raise ValueError("checkpoint.retain_last requires checkpoint.dir")
            if self.retain_last < 1:
                raise ValueError(f"checkpoint.retain_last must be >= 1, got {self.retain_last}")


@dataclasses.dataclass(frozen=True)
class JobConfig:
    #: Default operator parallelism.
    parallelism: int = 1
    #: Key-group count (Flink's maxParallelism): the upper bound on keyed
    #: parallelism, fixed for the job's lifetime so keyed state can be
    #: redistributed when a restart changes parallelism.
    max_parallelism: int = 128
    #: Bounded capacity of inter-subtask channels (records).
    channel_capacity: int = 1024
    #: Operator chaining (``analysis/chaining.py``): forward neighbours at
    #: equal parallelism fuse into one subtask thread and records pass by
    #: direct call instead of a queue hop.  False is the comparison
    #: layout: one thread and one input gate per operator subtask.
    #: Per-operator opt-outs: ``stream.start_new_chain()`` /
    #: ``stream.disable_chaining()``.
    chaining: bool = True
    #: Debug-mode concurrency sanitizer (``core/sanitizer_rt.py``): the
    #: runtime's locks and condition variables (gates, source mailboxes,
    #: split and checkpoint coordinators) are instrumented, lock-order
    #: inversions and waits-for cycles are found, and the barrier protocol
    #: is checked (no record past a blocked channel during alignment,
    #: snapshot order equal to chain order, split assignment frozen while
    #: a barrier aligns).  Off, the runtime keeps plain ``threading``
    #: primitives.  ``FLINK_TPU_SANITIZE=1`` turns it on;
    #: ``FLINK_TPU_SANITIZE_STALL_S`` adds the stall watchdog.
    sanitize: bool = False
    #: Where the sanitizer's happens-before log is dumped (the input of
    #: ``core/sanitizer_stitch.py``); a cohort process inserts
    #: ``.proc<k>`` before the extension.  None keeps it in memory.
    #: ``FLINK_TPU_SANITIZE_LOG`` applies when this is None.
    sanitize_log_path: typing.Optional[str] = None
    #: End-to-end span tracing (``tracing/``): a per-record trace
    #: context from source admission through chains and channels, the
    #: model runners' ``lane_wait``/``h2d``/``compute``/``d2h`` and
    #: decode spans, checkpoint alignment and split lifecycle; spans land
    #: in per-thread rings and export as Chrome trace JSON (Perfetto).
    #: Off costs one ``is None`` test per hook site.  ``FLINK_TPU_TRACE=1``
    #: turns it on.
    trace: bool = False
    #: Where the Chrome trace is written when the job finishes or fails;
    #: None keeps spans in memory (``executor.tracer``).
    #: ``FLINK_TPU_TRACE_PATH`` overrides.
    trace_path: typing.Optional[str] = None
    #: Head-based sampling: every round(1/rate)-th record per source
    #: subtask is traced (deterministic given the metrics seed).
    trace_sample_rate: float = 1.0
    #: Flight recorder (``tracing/flight.py``): an always-on bounded ring
    #: of control-rate events (lifecycle, barrier injections, snapshots,
    #: faults, per-report metric deltas), dumped to ``flight_path`` on a
    #: crash, a sanitizer violation, SIGTERM/SIGINT or
    #: ``JobHandle.cancel``.  False is the allocation-free off path
    #: (``FLINK_TPU_FLIGHT`` overrides either way).
    flight_recorder: bool = True
    #: Where flight dumps land; None records in memory only.
    #: ``FLINK_TPU_FLIGHT_PATH`` overrides.
    flight_path: typing.Optional[str] = None
    #: Device-resident dataflow (``tensors/transfer.py:DeviceBatch``): a
    #: model fused ahead of an operator that consumes device batches
    #: (another model, a ``DeviceMapFunction``) hands it the batch on the
    #: card, with no D2H and no H2D in between; the first host-only
    #: consumer materializes it once.  Per-function override:
    #: ``ModelMapFunction(device_resident=True/False)``.
    device_resident: bool = False
    #: Narrower H2D dtype for float fields (``"bf16"``, ``"f16"``,
    #: ``"int8"``; None or ``"f32"`` ships them as they are): model
    #: runners narrow host-side into the pinned staging slot and widen
    #: back to the declared dtype as the first step of the call.  Per
    #: function: ``ModelWindowFunction(wire_dtype=...)``.  The environment
    #: variable ``FLINK_TPU_WIRE_DTYPE`` applies when this is None.
    wire_dtype: typing.Optional[str] = None
    #: Frame coalescing on the cross-process record plane
    #: (``core/shuffle.py``): records buffer until this many estimated
    #: payload bytes, then flush as one frame; 0 sends a frame per record.
    #: ``FLINK_TPU_WIRE_FLUSH_BYTES`` overrides.
    wire_flush_bytes: int = 64 * 1024
    #: Buffer timeout: a partly filled buffer flushes this many ms after
    #: its first record (barriers, watermarks and end-of-partition flush at
    #: once); 0 flushes every record.  ``FLINK_TPU_WIRE_FLUSH_MS`` overrides.
    wire_flush_ms: float = 5.0
    #: Same-host edges ride a shared-memory ring (``native/ring.py:
    #: ShmByteRing``) instead of loopback TCP; the socket stays as
    #: handshake, doorbell and liveness channel.  ``FLINK_TPU_SHM``
    #: overrides.
    shm_channels: bool = True
    #: Credit-based flow control on the record plane: receivers grant
    #: per-edge frame credits and replenish them as the gate drains,
    #: senders park at zero; barriers, watermarks, end-of-partition and the
    #: control channel bypass credit.  ``FLINK_TPU_FLOW_CONTROL`` overrides.
    flow_control: bool = True
    #: Deterministic fault plan (``core/faults.py``: a ``FaultPlan``, a
    #: spec string, or a sequence of ``FaultSpec``\ s or spec strings):
    #: kill, stall, sever, blackhole, delay and store_fail faults pinned
    #: to (restart epoch, stream position).  None costs nothing;
    #: ``FLINK_TPU_FAULTS`` overrides.
    faults: typing.Optional[typing.Any] = None
    #: Sleep between source emissions — test/backpressure pacing.
    source_throttle_s: float = 0.0
    #: ``(task_name, subtask_index) -> device`` (``"cpu"``, ``"cuda:0"``,
    #: a ``torch.device``).  None: model subtasks take
    #: ``utils.device.resolve_device(None)`` — the GPU, or an error.
    device_provider: typing.Optional[typing.Callable[[str, int], typing.Any]] = None
    #: ``parallel.mesh.Mesh`` shared with gang operators (the DP trainer);
    #: ``env.set_mesh``.  A shape-only mesh (``parallel.mesh.abstract_mesh``)
    #: declares a layout for the plan analyzers (``analysis/shardcheck.py``)
    #: on a machine that cannot build it; a job that needs its devices
    #: fails at ``open()``.
    mesh: typing.Optional[typing.Any] = None
    #: Per-device memory ceiling (bytes) of shardcheck's static budget:
    #: params + optimizer state + KV pool + peak activations per device
    #: under the mesh must fit, or the plan fails validation with an
    #: ERROR naming the operator (``env.set_hbm_budget``).  None: no gate.
    #: An H100 SXM card holds 80 GiB.
    hbm_budget_bytes: typing.Optional[int] = None
    #: User-level parameters, not interpreted by the framework (the
    #: reference's ``user_params``; ``env.job_config`` is its deprecated
    #: dict alias).
    user_params: typing.Mapping[str, typing.Any] = dataclasses.field(default_factory=dict)
    #: Aligned snapshots: directory, trigger mode, retention.
    checkpoint: CheckpointConfig = dataclasses.field(default_factory=CheckpointConfig)
    #: Cohort membership (``core.distributed.DistributedConfig``): subtasks
    #: placed over processes, keyed and rebalance edges spanning them
    #: through the record plane.  None runs in one process.
    distributed: typing.Optional[typing.Any] = None
    #: Reporter interval, sinks and registry seed
    #: (``metrics.reporters.MetricConfig``).  The default publishes
    #: nothing while the job runs: no reporter thread, metrics only in
    #: the ``JobResult``.
    metrics: MetricConfig = dataclasses.field(default_factory=MetricConfig)
    #: Health plane (``metrics.health.HealthConfig``): SLO rules evaluated
    #: over the metric snapshot (a cohort's merged one) each interval on
    #: process 0, published as ``health.*`` gauges, flight events and
    #: trace instants.  With ``health.autoscale``
    #: (``core.autoscale.AutoscaleConfig``) a sustained breach of a
    #: scaling rule writes a decision and stops the job for a rescale.
    #: None starts no evaluator thread.
    health: typing.Optional[HealthConfig] = None
    #: Roofline plane (``metrics.roofline.RooflineConfig``): the declared
    #: device peak (``"h100-sxm"`` by default) and drift tolerances; model
    #: runners join measured step times against ``roofline.cost_table``
    #: and publish per-operator ``roofline.*`` gauges and compile events.
    #: None costs nothing.
    roofline: typing.Optional[typing.Any] = None

    def validate(self) -> "JobConfig":
        if self.parallelism < 1:
            raise ValueError(f"parallelism must be >= 1, got {self.parallelism}")
        if self.max_parallelism < 1:
            raise ValueError(f"max_parallelism must be >= 1, got {self.max_parallelism}")
        if self.channel_capacity < 1:
            raise ValueError(f"channel_capacity must be >= 1, got {self.channel_capacity}")
        if self.wire_flush_bytes < 0:
            raise ValueError(f"wire_flush_bytes must be >= 0, got {self.wire_flush_bytes}")
        if self.wire_flush_ms < 0:
            raise ValueError(f"wire_flush_ms must be >= 0, got {self.wire_flush_ms}")
        for flag in ("chaining", "device_resident"):
            if not isinstance(getattr(self, flag), bool):
                raise ValueError(f"{flag} must be a bool, got {getattr(self, flag)!r}")
        if self.wire_dtype is not None and self.wire_dtype not in WIRE_DTYPES:
            raise ValueError(f"wire_dtype must be one of {WIRE_DTYPES} or None, "
                             f"got {self.wire_dtype!r}")
        if self.faults is not None:
            FaultPlan.resolve(self.faults)  # raises on a malformed spec
        if self.source_throttle_s < 0:
            raise ValueError(f"source_throttle_s must be >= 0, got {self.source_throttle_s}")
        if not (0.0 < self.trace_sample_rate <= 1.0):
            raise ValueError(
                f"trace_sample_rate must be in (0, 1], got {self.trace_sample_rate}")
        if self.device_provider is not None and not callable(self.device_provider):
            raise ValueError("device_provider must be callable (task, idx) -> device")
        if self.mesh is not None and not (hasattr(self.mesh, "shape")
                                          and hasattr(self.mesh, "devices")):
            raise ValueError("mesh must be a parallel.mesh.Mesh (make_mesh or "
                             f"abstract_mesh), got {type(self.mesh).__name__}")
        if self.hbm_budget_bytes is not None and self.hbm_budget_bytes < 1:
            raise ValueError(f"hbm_budget_bytes must be >= 1, got {self.hbm_budget_bytes}")
        if self.distributed is not None:
            self.distributed.validate()
            if self.checkpoint.interval_s is not None:
                raise ValueError(
                    "distributed jobs checkpoint with count-based triggers "
                    "(checkpoint.every_n_records), not interval_s — barrier "
                    "positions must be deterministic across the cohort")
        self.metrics.validate()
        self.checkpoint.validate()
        if self.health is not None:
            self.health.validate()
        if self.roofline is not None:
            self.roofline.validate()
        return self
