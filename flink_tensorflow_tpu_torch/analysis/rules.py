"""Lint rule registry — structural checks over the logical plan.

Port of ``flink_tensorflow_tpu/analysis/rules.py``: the
:class:`AnalysisContext`, the registry and all 33 rules of the reference,
with its rule ids, severities and report order — the 21 defined here and
the shardcheck and statecheck families, registered from the bottom of
this module as the reference registers them.  A model function marks
the boundary where records become one runner call with the reference's
name, ``is_jit_boundary``: a new batch shape there is a new launch
configuration (cuDNN plans, kernel builds, allocator growth), the
runner's counterpart of a recompile.

Each rule is a function ``(ctx, emit) -> None`` registered under a
stable id with a fixed severity; ``emit(message, node=..., edge=...)``
records one diagnostic.  Rules see the :class:`AnalysisContext`: the
graph, its topological order, one *uninitialized* operator instance per
transformation (factories are cheap — ``open()`` is never called, so no
device or model state is touched), the propagated schemas, and the
job config when the caller provided one.

"""

from __future__ import annotations

import dataclasses
import typing

from flink_tensorflow_tpu_torch.analysis.diagnostics import Diagnostic, Severity, edge_name
from flink_tensorflow_tpu_torch.core.graph import DataflowGraph, Edge, Transformation
from flink_tensorflow_tpu_torch.core.operators import Operator
from flink_tensorflow_tpu_torch.core.partitioning import ForwardPartitioner, HashPartitioner
from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema


@dataclasses.dataclass
class AnalysisContext:
    graph: DataflowGraph
    order: typing.List[Transformation]
    #: transformation id -> operator instance (or None if the factory
    #: could not run at plan time).
    operators: typing.Dict[int, typing.Optional[Operator]]
    #: transformation id -> sole propagated output schema (None = unknown
    #: or ambiguous).
    schemas: typing.Dict[int, typing.Optional[RecordSchema]]
    #: transformation id -> all distinct schemas flowing out of the node.
    schema_sets: typing.Dict[int, typing.List[RecordSchema]]
    #: JobConfig when analyzing through an environment; None for a bare
    #: graph (config-dependent rules skip themselves).
    config: typing.Optional[typing.Any] = None

    def function_of(self, t: Transformation):
        """The user function hosted by ``t``'s operator, if any."""
        return getattr(self.operators.get(t.id), "function", None)

    def input_schema(self, t: Transformation) -> typing.Optional[RecordSchema]:
        """Sole known schema arriving at ``t`` (None = unknown/ambiguous)."""
        arriving = self.input_schema_set(t)
        return arriving[0] if len(arriving) == 1 else None

    def input_schema_set(self, t: Transformation) -> typing.List[RecordSchema]:
        arriving: typing.List[RecordSchema] = []
        seen: typing.Set[RecordSchema] = set()
        for e in t.inputs:
            for s in self.schema_sets.get(e.upstream.id, []):
                if s not in seen:
                    seen.add(s)
                    arriving.append(s)
        return arriving

    def is_keyed(self, t: Transformation) -> bool:
        op = self.operators.get(t.id)
        if any(getattr(op, attr, None) is not None
               for attr in ("key_selector", "key_selector1")):
            return True
        # The port's two-input operators keep their selectors as a pair.
        return getattr(op, "key_selectors", (None,))[0] is not None


Emit = typing.Callable[..., None]
RuleFn = typing.Callable[[AnalysisContext, Emit], None]


@dataclasses.dataclass(frozen=True)
class LintRule:
    id: str
    severity: Severity
    doc: str
    fn: RuleFn


#: Registry, in registration (= report) order.
RULES: typing.Dict[str, LintRule] = {}


def rule(rule_id: str, severity: Severity):
    def register(fn: RuleFn) -> RuleFn:
        if rule_id in RULES:
            raise ValueError(f"duplicate lint rule id {rule_id!r}")
        RULES[rule_id] = LintRule(rule_id, severity, fn.__doc__ or "", fn)
        return fn

    return register


def run_rules(ctx: AnalysisContext) -> typing.List[Diagnostic]:
    diags: typing.List[Diagnostic] = []
    for lint in RULES.values():
        def emit(message: str, node: typing.Optional[str] = None,
                 edge: typing.Optional[str] = None,
                 severity: typing.Optional[Severity] = None) -> None:
            # NOT `severity or ...`: Severity.INFO is 0 and falsy.
            diags.append(Diagnostic(
                rule=lint.id,
                severity=lint.severity if severity is None else severity,
                message=message, node=node, edge=edge,
            ))
        lint.fn(ctx, emit)
    return diags


def _edge_str(e: Edge, t: Transformation) -> str:
    return edge_name(e.upstream.name, t.name)


def _is_open_loop(feed) -> bool:
    """An open-loop source offers records on its own arrival schedule
    (``PacedSplitSource`` sets ``is_open_loop``)."""
    return bool(getattr(feed, "is_open_loop", False))


def _open_loop_feed(op) -> typing.Any:
    """The open-loop source an operator hosts (its function, or a split
    source operator's source), or None."""
    for attr in ("function", "source"):
        feed = getattr(op, attr, None)
        if _is_open_loop(feed):
            return feed
    return None


def _plan_policy(function) -> typing.Optional[typing.Any]:
    """The function's plan-time BucketPolicy, via the ``plan_policy``
    hook or the conventional ``_policy`` attribute."""
    hook = getattr(function, "plan_policy", None)
    if hook is not None:
        return hook()
    return getattr(function, "_policy", None)


# ---------------------------------------------------------------------------
# Rules.  (Cycle detection lives in analyzer.analyze(): a cyclic graph has
# no topological order, so no other rule can run — it is reported alone.)
# ---------------------------------------------------------------------------


@rule("dangling-root", Severity.ERROR)
def _dangling_roots(ctx: AnalysisContext, emit: Emit) -> None:
    """A non-source operator with no inputs never receives a record (and
    never an end-of-partition): dead plan wiring."""
    for t in ctx.order:
        if not t.is_source and not t.inputs:
            emit(
                "operator has no inputs and is not a source — it will "
                "never receive records; wire an upstream edge or add it "
                "via from_source(...)",
                node=t.name,
            )


@rule("keyed-partitioning", Severity.ERROR)
def _keyed_partitioning(ctx: AnalysisContext, emit: Emit) -> None:
    """Keyed-state operators must be fed by hash edges: any other
    partitioner can route two records of the same key to different
    subtasks, silently splitting their keyed state."""
    for t in ctx.order:
        if not ctx.is_keyed(t):
            continue
        for e in t.inputs:
            if not isinstance(e.partitioner, HashPartitioner):
                emit(
                    f"keyed operator is fed by "
                    f"{type(e.partitioner).__name__} — records of one key "
                    "may land on different subtasks and split their keyed "
                    "state; partition this edge by key (key_by)",
                    node=t.name, edge=_edge_str(e, t),
                )


@rule("forward-parallelism", Severity.ERROR)
def _forward_parallelism(ctx: AnalysisContext, emit: Emit) -> None:
    """Forward (1:1) edges require equal upstream/downstream parallelism
    — the runtime rejects this at build; catch it at plan time."""
    for t in ctx.order:
        for e in t.inputs:
            if (isinstance(e.partitioner, ForwardPartitioner)
                    and e.upstream.parallelism != t.parallelism):
                emit(
                    f"forward edge requires equal parallelism "
                    f"({e.upstream.parallelism} vs {t.parallelism}); "
                    "rebalance() the hop or align the parallelisms",
                    node=t.name, edge=_edge_str(e, t),
                )


@rule("keyed-parallelism-bound", Severity.ERROR)
def _keyed_parallelism_bound(ctx: AnalysisContext, emit: Emit) -> None:
    """Keyed parallelism above max_parallelism leaves subtasks with no
    key group — they would idle forever (the runtime refuses too)."""
    if ctx.config is None:
        return
    bound = ctx.config.max_parallelism
    for t in ctx.order:
        if ctx.is_keyed(t) and t.parallelism > bound:
            emit(
                f"keyed operator parallelism {t.parallelism} exceeds "
                f"max_parallelism {bound} — key groups cannot cover all "
                "subtasks; raise JobConfig.max_parallelism",
                node=t.name,
            )


@rule("mesh-divisibility", Severity.ERROR)
def _mesh_divisibility(ctx: AnalysisContext, emit: Emit) -> None:
    """Device-bound gang stages (DP training) must fit the mesh: stream
    parallelism 1, a mesh configured, and the global batch dividing the
    mesh's data axis — otherwise open() fails (or worse, the first
    collective hangs) after the job already started."""
    for t in ctx.order:
        function = ctx.function_of(t)
        if not getattr(function, "is_gang", False):
            continue
        if t.parallelism != 1:
            emit(
                f"gang operator runs at stream parallelism "
                f"{t.parallelism}; a gang owns the whole mesh and must "
                "run at parallelism 1 (devices parallelize inside the "
                "gang's step, not across subtasks)",
                node=t.name,
            )
        if ctx.config is None:
            continue
        mesh = ctx.config.mesh
        if mesh is None:
            emit(
                "gang operator needs env.set_mesh(...) — it owns the "
                "device mesh and cannot open without one",
                node=t.name,
            )
            continue
        data_axis = dict(mesh.shape).get("data", 1)
        global_batch = getattr(function, "global_batch", None)
        if global_batch is not None and data_axis and global_batch % data_axis:
            emit(
                f"global_batch {global_batch} does not divide the mesh "
                f"data axis ({data_axis}) — per-device shards would be "
                "ragged; pick a multiple",
                node=t.name,
            )


@rule("dynamic-jit-boundary", Severity.ERROR)
def _dynamic_jit_boundary(ctx: AnalysisContext, emit: Emit) -> None:
    """Dynamic (None) dims reaching a runner boundary without a bucketing
    policy: every observed length would be a fresh launch configuration
    (new cuDNN plans and kernel builds, allocator growth) — the churn the
    static-shape invariant exists to prevent.  A length BucketLadder resolves it (INFO when present)."""
    for t in ctx.order:
        function = ctx.function_of(t)
        if not getattr(function, "is_jit_boundary", False):
            continue
        in_schema = ctx.input_schema(t)
        if in_schema is None or in_schema.is_static:
            continue
        dyn = [n for n in in_schema.names if not in_schema[n].is_static]
        policy = _plan_policy(function)
        ladder = getattr(policy, "lengths", None) if policy is not None else None
        if ladder is None or not getattr(ladder, "sizes", None):
            emit(
                f"dynamic dims on field(s) {dyn} reach this runner boundary "
                "with no length-bucketing policy — every distinct length "
                "is a new launch configuration; give the operator a "
                "BucketPolicy with a lengths ladder (or bucket upstream)",
                node=t.name,
            )
        else:
            emit(
                f"dynamic dims on field(s) {dyn} are resolved by the "
                f"length ladder {list(ladder.sizes)[:8]}",
                node=t.name, severity=Severity.INFO,
            )


@rule("watermark-missing-assigner", Severity.ERROR)
def _watermark_missing_assigner(ctx: AnalysisContext, emit: Emit) -> None:
    """Event-time window/session operators fire on watermarks and require
    every record to carry an event timestamp: with no timestamp assigner
    anywhere upstream the first record raises at runtime (and no
    watermark would ever fire a window).  The runtime's watermark-lag
    gauge (core/event_time) measures against the same provenance: the
    assigner is where event time enters the stream."""
    from flink_tensorflow_tpu_torch.core.event_time import (
        EventTimeWindowOperator,
        SessionWindowOperator,
        TimestampAssignerOperator,
    )

    for t in ctx.order:
        op = ctx.operators.get(t.id)
        if not isinstance(op, (EventTimeWindowOperator, SessionWindowOperator)):
            continue
        seen: typing.Set[int] = set()
        stack = list(t.inputs)
        found = False
        while stack and not found:
            upstream = stack.pop().upstream
            if upstream.id in seen:
                continue
            seen.add(upstream.id)
            if isinstance(ctx.operators.get(upstream.id), TimestampAssignerOperator):
                found = True
            else:
                stack.extend(upstream.inputs)
        if not found:
            emit(
                "event-time window has no timestamp assigner upstream — "
                "records arrive without event timestamps and the operator "
                "raises on the first one; add .assign_timestamps(ts_fn) "
                "before the window",
                node=t.name,
            )


@rule("watermark-async-flush", Severity.WARN)
def _watermark_async_flush(ctx: AnalysisContext, emit: Emit) -> None:
    """``watermark_every < micro_batch`` feeding an async map: the
    enclosing operator flushes its in-flight micro-batch before
    forwarding EVERY watermark (event-time safety — see MapOperator), so
    fine-grained watermarks degrade transparent micro-batching toward
    batch-of-1 dispatch.  Use ``watermark_every >= micro_batch`` so
    flushes land on batch boundaries."""
    from flink_tensorflow_tpu_torch.core.event_time import TimestampAssignerOperator
    from flink_tensorflow_tpu_torch.core.functions import AsyncMapFunction

    for t in ctx.order:
        op = ctx.operators.get(t.id)
        if not isinstance(op, TimestampAssignerOperator):
            continue
        seen: typing.Set[int] = set()
        stack = ctx.graph.downstream_of(t)
        while stack:
            d = stack.pop()
            if d.id in seen:
                continue
            seen.add(d.id)
            dop = ctx.operators.get(d.id)
            if isinstance(dop, TimestampAssignerOperator):
                continue  # a later assigner re-times the stream below it
            function = ctx.function_of(d)
            micro = getattr(function, "_micro_batch", None)
            if (isinstance(function, AsyncMapFunction) and micro
                    and op.watermark_every < micro):
                emit(
                    f"assigner {t.name!r} emits a watermark every "
                    f"{op.watermark_every} record(s) but this async map "
                    f"micro-batches {micro} — each watermark flushes the "
                    "partial batch, degrading dispatch toward batch-of-1; "
                    f"use watermark_every >= {micro} (or shrink micro_batch)",
                    node=d.name,
                )
            stack.extend(ctx.graph.downstream_of(d))


@rule("sharding-axis", Severity.ERROR)
def _sharding_axis(ctx: AnalysisContext, emit: Emit) -> None:
    """Sharding annotations must agree with the mesh BEFORE execution:
    a declared batch-dim sharding axis that doesn't exist on the mesh
    compiles against a silently-replicated (size-1) axis, and a batch
    that doesn't divide the sharded axes' device product makes the first
    gang call fail (or hang a collective) after the job already started.
    Shares its annotation vocabulary (``sharding_axes``, gang defaults)
    with the operator-chaining pass — analysis/chaining.py refuses to
    fuse across mismatched axes using the same helpers."""
    from flink_tensorflow_tpu_torch.analysis.chaining import (
        sharding_axes_of,
        sharding_fusion_conflict,
    )

    mesh = ctx.config.mesh if ctx.config is not None else None
    mesh_axes = dict(mesh.shape) if mesh is not None else None
    for t in ctx.order:
        function = ctx.function_of(t)
        axes = sharding_axes_of(function)
        if axes is None:
            continue
        is_gang = getattr(function, "is_gang", False)
        if mesh is None:
            if ctx.config is not None and not is_gang:
                # Gang ops get the missing-mesh ERROR from
                # mesh-divisibility; annotated non-gang ops need their own.
                emit(
                    f"operator declares sharding axes {list(axes)} but the "
                    "job has no mesh — annotate via env.set_mesh(...) or "
                    "drop the annotation",
                    node=t.name,
                )
            continue
        unknown = [a for a in axes if a not in mesh_axes]
        if unknown:
            emit(
                f"sharding axes {unknown} are not on the mesh "
                f"(mesh axes: {sorted(mesh_axes)}) — the annotation would "
                "compile against a silently-replicated axis; fix the "
                "annotation or add the axis to the mesh",
                node=t.name,
            )
            continue
        # Batch-dim divisibility over the DECLARED axes.  Gang functions'
        # global_batch vs the data axis is mesh-divisibility's finding;
        # this rule owns every other annotated operator.
        if is_gang:
            continue
        batch = getattr(function, "global_batch", None)
        if batch is None:
            policy = _plan_policy(function)
            batch = getattr(policy, "fixed_batch", None) if policy else None
        if batch is not None:
            shard_product = 1
            for a in axes:
                shard_product *= mesh_axes[a]
            if shard_product and batch % shard_product:
                emit(
                    f"batch {batch} does not divide the sharded axes' "
                    f"device product ({'x'.join(axes)} = {shard_product}) — "
                    "per-device shards would be ragged; pick a multiple",
                    node=t.name,
                )
    # The shared fusion check, surfaced as a lint: a forward edge whose
    # endpoints BOTH declare sharding — but disagree — cannot chain
    # (records would hop between differently-placed steps on the same
    # thread) and is usually an accidental annotation mismatch.  An
    # annotated operator next to a plain host-side one is normal and
    # stays quiet (the chaining pass still declines to fuse it).
    for t in ctx.order:
        for e in t.inputs:
            if not isinstance(e.partitioner, ForwardPartitioner):
                continue
            up_fn = ctx.function_of(e.upstream)
            down_fn = ctx.function_of(t)
            up_axes = sharding_axes_of(up_fn)
            down_axes = sharding_axes_of(down_fn)
            if (up_axes is not None and down_axes is not None
                    and up_axes != down_axes):
                conflict = sharding_fusion_conflict(
                    ctx.operators.get(e.upstream.id), ctx.operators.get(t.id))
                emit(
                    f"forward edge will not chain: {conflict}",
                    node=t.name, edge=_edge_str(e, t),
                    severity=Severity.WARN,
                )


@rule("source-split-parallelism", Severity.WARN)
def _source_split_parallelism(ctx: AnalysisContext, emit: Emit) -> None:
    """A bounded split source declaring fewer splits than its reader
    parallelism leaves subtasks that can never receive work: assignment
    is pull-based (sources/coordinator.py), so a reader without a split
    to pull idles for the whole job.  Uses the source's plan-time
    ``plan_split_count`` hook — sources whose count needs IO return None
    and are skipped."""
    for t in ctx.order:
        if not t.is_source:
            continue
        op = ctx.operators.get(t.id)
        if not getattr(op, "is_split_source", False):
            continue
        source = getattr(op, "source", None)
        if source is None or not getattr(source, "bounded", True):
            continue
        hook = getattr(source, "plan_split_count", None)
        count = hook() if hook is not None else None
        if count is not None and count < t.parallelism:
            emit(
                f"bounded split source declares {count} split(s) for "
                f"parallelism {t.parallelism} — {t.parallelism - count} "
                "subtask(s) will never be assigned work; add splits "
                "(more files / smaller records_per_split / higher "
                "num_splits) or lower the source parallelism",
                node=t.name,
            )


@rule("replay-purity", Severity.WARN)
def _replay_purity(ctx: AnalysisContext, emit: Emit) -> None:
    """Exactly-once recovery replays records through user functions and
    rebuilds state from that replay: a function that reads the wall
    clock, draws from a process-global RNG, mutates module globals,
    captures a mutable closure, or performs I/O computes DIFFERENT
    results on replay than it did before the failure — the restored
    state silently diverges from "processed the stream once".  Bytecode
    scan (analysis/sanitizer.py) over every user map/model/reader/key
    function; ERROR on keyed-state paths (replay divergence corrupts
    keyed state and repeats side effects per retained record), WARN
    elsewhere.  Framework code (paced sources' open-loop clock, seeded
    reservoirs) is exempt by construction — only user code is scanned."""
    from flink_tensorflow_tpu_torch.analysis.sanitizer import scan_operator

    for t in ctx.order:
        op = ctx.operators.get(t.id)
        if op is None:
            continue
        keyed = ctx.is_keyed(t)
        for f in scan_operator(op):
            hard = keyed and f.kind in (
                "wall-clock", "unseeded-random", "global-mutation", "io")
            emit(
                f.describe() + (
                    "; restore will not reproduce this operator's keyed "
                    "state — hoist the impurity out of the record path "
                    "(seed an RNG in open(), take time from record "
                    "timestamps, keep state in keyed state)"
                    if hard else
                    "; replay after restore will not reproduce the "
                    "original output for the replayed records"
                ),
                node=t.name,
                severity=Severity.ERROR if hard else Severity.WARN,
            )


@rule("legacy-source-timer-chain", Severity.WARN)
def _legacy_source_timer_chain(ctx: AnalysisContext, emit: Emit) -> None:
    """A LEGACY ``SourceFunction`` chain is cut before a timer-driven
    operator (the source loop blocks inside the user generator and
    cannot serve wall-clock deadlines), costing the hop a queue + thread
    wakeup that a split source would not pay: split-source heads
    (sources/, FLIP-27 model) wait on a wakeable mailbox bounded by the
    chain's earliest deadline, so timer-driven members fuse behind them.
    Flags exactly the edges the chaining pass refused (shared
    TIMER_CUT_REASON) and recommends the migration."""
    from flink_tensorflow_tpu_torch.analysis.chaining import (
        TIMER_CUT_REASON,
        compute_chains,
    )

    plan = compute_chains(ctx.graph, operators=ctx.operators)
    by_id = {t.id: t for t in ctx.order}
    for (uid, did), reason in plan.unchained_reasons.items():
        if reason != TIMER_CUT_REASON:
            continue
        up, down = by_id[uid], by_id[did]
        emit(
            f"chain is cut before timer-driven operator {down.name!r} "
            "because its head is a legacy SourceFunction — the hop pays "
            "a queue + thread wakeup per record; migrate the source to a "
            "SplitSource (sources/, wakeable mailbox) so the timer-driven "
            "member fuses into the source chain",
            node=up.name, edge=_edge_str(
                next(e for e in down.inputs if e.upstream.id == uid), down),
        )


@rule("device-residency", Severity.WARN)
def _device_residency(ctx: AnalysisContext, emit: Emit) -> None:
    """Under ``JobConfig.device_resident`` a chain of device-capable
    operators (model -> model, model -> elementwise device map) keeps
    batches HBM-resident: the d2h/h2d pair is elided per fused hop and
    the fetch is paid once, at the first host-only consumer.  This rule
    flags plans that silently give that elision back:

    - WARN: a host-only operator sandwiched between two device-capable
      operators INSIDE one chain (model -> host map -> model) — the
      mid-segment fetch + re-upload costs the wire twice where reordering
      the host step past the segment (or making it a DeviceMapFunction)
      would cost zero;
    - WARN: a forward edge between two device-capable operators that the
      chaining pass refused to fuse (parallelism change, escape hatch,
      fan-out) — the channel is a host boundary, so the segment cuts for
      a reason the plan could remove;
    - INFO: a keyed/broadcast/rebalance edge between device-capable
      operators — the cut is structural (records re-route between
      subtasks on the host plane), the fetch there is the designed
      "exactly once" boundary, not a plan smell.

    Skipped entirely when the job config is present and device
    residency is off (nothing is elided, so nothing is given back)."""
    from flink_tensorflow_tpu_torch.analysis.chaining import (
        accepts_device_op,
        compute_chains,
        device_capable_op,
    )

    if ctx.config is not None and not getattr(ctx.config, "device_resident", False):
        return
    plan = compute_chains(ctx.graph, operators=ctx.operators)
    # Host-only sandwich inside one chain.
    for chain in plan.chains:
        last_device: typing.Optional[Transformation] = None
        hosts_between: typing.List[Transformation] = []
        for t in chain:
            op = ctx.operators.get(t.id)
            if device_capable_op(op):
                if last_device is not None and hosts_between:
                    names = ", ".join(h.name for h in hosts_between)
                    emit(
                        f"host-only operator(s) {names} sandwiched between "
                        f"device-capable {last_device.name!r} and {t.name!r} "
                        "force a mid-segment fetch + re-upload — the chain "
                        "pays the wire twice where an HBM-resident handoff "
                        "would pay zero; reorder the host step out of the "
                        "segment or express it as a DeviceMapFunction",
                        node=hosts_between[0].name,
                    )
                last_device = t
                hosts_between = []
            elif last_device is not None:
                hosts_between.append(t)
    # Unfused edges between device-capable endpoints.  The downstream
    # side counts whether it consumes DeviceBatches or is merely
    # device-capable (a model window re-uploads what the upstream just
    # fetched — the cut costs the wire either way).
    for t in ctx.order:
        for e in t.inputs:
            up_op = ctx.operators.get(e.upstream.id)
            down_op = ctx.operators.get(t.id)
            if not device_capable_op(up_op):
                continue
            if not (device_capable_op(down_op) or accepts_device_op(down_op)):
                continue
            if (e.upstream.id, t.id) in plan.device_resident_edges:
                continue
            if isinstance(e.partitioner, ForwardPartitioner):
                reason = plan.unchained_reasons.get(
                    (e.upstream.id, t.id), "edge not fused")
                emit(
                    f"device-capable edge is not chained ({reason}) — the "
                    "channel is a host boundary, so the device-resident "
                    "segment cuts here and the hop pays d2h + h2d",
                    node=t.name, edge=_edge_str(e, t),
                )
            else:
                emit(
                    f"{type(e.partitioner).__name__} edge between "
                    "device-capable operators always cuts the device-"
                    "resident segment (records re-route on the host "
                    "plane); the fetch here is the designed host boundary",
                    node=t.name, edge=_edge_str(e, t),
                    severity=Severity.INFO,
                )


@rule("remote-edge-buffer-timeout", Severity.WARN)
def _remote_edge_buffer_timeout(ctx: AnalysisContext, emit: Emit) -> None:
    """Latency-sensitive plan behind a large remote buffer timeout: an
    open-loop paced source measures arrival-schedule latency, but every
    remote edge (cohort shuffle channel or RemoteSink) holds partially
    filled frames for up to ``wire_flush_ms`` before sending — the
    coalescing delay lands straight on the measured tail.  Flink's
    guidance for its equivalent knob (bufferTimeout) is the same: large
    values buy throughput for pipelines, small values serve
    latency-bound jobs.  Set ``JobConfig.wire_flush_ms`` low (or 0 =
    flush per record) for open-loop latency runs."""
    cfg = ctx.config
    if cfg is None:
        return
    flush_ms = getattr(cfg, "wire_flush_ms", None)
    if flush_ms is None or flush_ms <= 10.0:
        return
    # Remote edges exist when the job spans a cohort, or when a sink
    # ships records over the io/remote plane.
    def _is_remote_sink(t: Transformation) -> bool:
        function = ctx.function_of(t)
        return type(function).__name__ == "RemoteSink"

    has_remote = getattr(cfg, "distributed", None) is not None or any(
        _is_remote_sink(t) for t in ctx.order
    )
    if not has_remote:
        return
    for t in ctx.order:
        op = ctx.operators.get(t.id)
        if _is_open_loop(getattr(op, "source", None)):
            emit(
                f"open-loop paced source feeds a plan with remote edges "
                f"while wire_flush_ms={flush_ms:g} — up to {flush_ms:g}ms "
                "of coalescing delay is added to every measured arrival; "
                "lower JobConfig.wire_flush_ms (0 flushes per record) "
                "for latency-bound runs",
                node=t.name,
            )


@rule("flow-control", Severity.WARN)
def _flow_control_disabled(ctx: AnalysisContext, emit: Emit) -> None:
    """Checkpointed multi-process plan running with credit flow control
    DISABLED behind an open-loop paced source: the source keeps
    producing on its arrival schedule regardless of downstream pace, so
    when a consumer stalls (GC, slow commit, chaos fault) the sender's
    wire buffers grow without bound — exactly the overload the credit
    window (``JobConfig.flow_control``, on by default) exists to cap at
    a constant.  Worse, a checkpointed plan stalls ALIGNMENT behind
    those unbounded queues: barriers sit at the back of however many
    frames accumulated, so checkpoint durations creep with load instead
    of staying constant.  Re-enable flow_control (or close the loop at
    the source) before trusting this plan under overload."""
    cfg = ctx.config
    if cfg is None:
        return
    if getattr(cfg, "flow_control", True) is not False:
        return
    if getattr(cfg, "distributed", None) is None:
        return  # single-process: channels are in-memory and bounded
    checkpoint = getattr(cfg, "checkpoint", None)
    if checkpoint is None or getattr(checkpoint, "dir", None) is None:
        return  # no alignment to wedge; overload just slows the job
    for t in ctx.order:
        if not t.is_source:
            continue
        if _open_loop_feed(ctx.operators.get(t.id)) is not None:
            emit(
                "open-loop paced source feeds a checkpointed multi-"
                "process plan with flow_control=False — a stalled "
                "consumer lets sender queues (and checkpoint alignment "
                "time) grow without bound; re-enable "
                "JobConfig.flow_control so a zero-credit edge parks the "
                "producer within one credit window",
                node=t.name,
            )


@rule("cohort-telemetry", Severity.WARN)
def _cohort_telemetry(ctx: AnalysisContext, emit: Emit) -> None:
    """Distributed observability misconfiguration.  Two findings:

    1. A cohort plan enables tracing or metric reporting but disables
       the telemetry service (``telemetry_interval_s=0``): no clock
       sync means cross-process spans stay suppressed and the
       per-process trace files cannot stitch (``flink-tpu-trace
       --cohort``), and no metric pushes means ``flink-tpu-inspect
       --live --cohort`` / the autoscaling-supervisor feed see
       process 0 ONLY — the per-process reporters keep publishing
       disjoint files, which reads like cohort coverage but isn't.
    2. Full-rate tracing (``trace_sample_rate=1.0``) behind an
       open-loop paced source at high offered rate: every record on
       every cohort process pays span recording, and the coalesced
       trace rings rotate too fast to keep the window the post-mortem
       needs — sample instead (the head-based sampler keeps whole
       records)."""
    cfg = ctx.config
    dist = getattr(cfg, "distributed", None) if cfg is not None else None
    if cfg is None or dist is None or getattr(dist, "num_processes", 1) < 2:
        return
    metrics_cfg = getattr(cfg, "metrics", None)
    reporting = metrics_cfg is not None and (
        getattr(metrics_cfg, "report_interval_s", None) is not None
        or getattr(metrics_cfg, "jsonl_path", None)
        or getattr(metrics_cfg, "prometheus_path", None)
        or getattr(metrics_cfg, "http_port", None)
        or getattr(metrics_cfg, "reporters", ())
    )
    observing = bool(getattr(cfg, "trace", False)) or bool(reporting)
    if observing and getattr(dist, "telemetry_interval_s", 2.0) <= 0:
        emit(
            f"distributed plan ({dist.num_processes} processes) enables "
            "tracing/reporting but telemetry_interval_s=0 disables the "
            "cohort plane: no clock sync (cross-process spans stay "
            "suppressed, per-process trace files cannot stitch) and no "
            "metric pushes (--live --cohort and the supervisor feed see "
            "process 0 only); set DistributedConfig.telemetry_interval_s "
            "> 0",
        )
    if not getattr(cfg, "trace", False):
        return
    if getattr(cfg, "trace_sample_rate", 1.0) < 1.0:
        return
    for t in ctx.order:
        op = ctx.operators.get(t.id)
        source = getattr(op, "source", None)
        open_loop = _is_open_loop(source)
        rate_hz = getattr(source, "rate_hz", 0.0) or 0.0
        if open_loop and rate_hz >= 500.0:
            emit(
                f"trace_sample_rate=1.0 with an open-loop source offering "
                f"{rate_hz:g} rec/s per reader across a "
                f"{dist.num_processes}-process cohort — every record on "
                "every process pays span recording and the trace rings "
                "rotate in seconds; lower trace_sample_rate (head-based, "
                "keeps whole records) for high-rate cohort runs",
                node=t.name,
            )


@rule("slo-unmonitored", Severity.WARN)
def _slo_unmonitored(ctx: AnalysisContext, emit: Emit) -> None:
    """Health/autoscale plane wired to a dead feed.  A cohort plan
    configures ``JobConfig.health`` (SLO rules, possibly an autoscale
    actuator) but disables the telemetry service
    (``telemetry_interval_s=0``): the process-0 evaluator then scores
    ``merged_snapshot()`` over process 0's registry ONLY.  Per-edge
    backpressure on peers never trips a rule, and an autoscale decision
    fires (or fails to fire) on a fraction of the evidence — the loop
    looks closed but watches one process."""
    cfg = ctx.config
    health = getattr(cfg, "health", None) if cfg is not None else None
    if health is None:
        return
    dist = getattr(cfg, "distributed", None)
    if dist is None or getattr(dist, "num_processes", 1) < 2:
        return
    if getattr(dist, "telemetry_interval_s", 2.0) > 0:
        return
    autoscale = getattr(health, "autoscale", None)
    what = ("autoscale actuator" if autoscale is not None
            else "health evaluation")
    emit(
        f"JobConfig.health configures {what} for a "
        f"{dist.num_processes}-process cohort but "
        "telemetry_interval_s=0 disables metric pushes: the process-0 "
        "evaluator scores process 0 only, so peer backpressure never "
        "breaches and scaling decisions act on partial evidence; set "
        "DistributedConfig.telemetry_interval_s > 0 (or drop "
        "JobConfig.health)",
    )


@rule("serving-unkeyed-input", Severity.ERROR)
def _serving_unkeyed_input(ctx: AnalysisContext, emit: Emit) -> None:
    """The continuous-batching operator keys EVERYTHING on the session
    id: the KV cache, the generation progress, the admission queue all
    live in keyed state.  Fed by any partitioner other than a hash
    edge, two requests of one session (or a rescaled restore's replay)
    can land on different subtasks — each would prefill its own cache
    and the session's generation forks silently.  Stricter than the
    generic keyed-partitioning rule: it also fires when the operator
    was wired WITHOUT a key selector at all (a hand-built plan that
    bypassed ``serving.continuous_batching``)."""
    for t in ctx.order:
        op = ctx.operators.get(t.id)
        if not getattr(op, "is_continuous_batching", False):
            continue
        if getattr(op, "key_selector", None) is None:
            emit(
                "continuous-batching operator has no session key selector "
                "— requests cannot be routed consistently and keyed KV "
                "state never rescales; build the operator via "
                "serving.continuous_batching(stream.key_by(session_id), ...)",
                node=t.name,
            )
        for e in t.inputs:
            if not isinstance(e.partitioner, HashPartitioner):
                emit(
                    f"continuous-batching operator sits on a "
                    f"{type(e.partitioner).__name__} edge — requests of one "
                    "session may land on different subtasks and fork the "
                    "session's KV cache; key the edge by session id "
                    "(stream.key_by(lambda r: r.session_id))",
                    node=t.name, edge=_edge_str(e, t),
                )


@rule("serving-recompile-churn", Severity.WARN)
def _serving_recompile_churn(ctx: AnalysisContext, emit: Emit) -> None:
    """Serving shapes must quantize or every step recompiles: with
    ``ServingConfig.padding_buckets`` disabled, the decode step runs at
    the EXACT active-set size (a fresh executable per distinct count —
    up to ``max_active_seqs`` compiles churning as sessions come and
    go) and prefill at the exact prompt length (one compile per
    distinct length in the traffic).  The bucketed mode pays padding
    FLOPs for a bounded executable set: one decode shape ever, prefill
    on the admit x prompt-length bucket grid.  Covers both the
    continuous-batching operator and the fixed-window baseline arm
    (any operator/function carrying a ``serving_config``)."""
    for t in ctx.order:
        op = ctx.operators.get(t.id)
        cfg = getattr(op, "serving_config", None)
        if cfg is None:
            cfg = getattr(ctx.function_of(t), "serving_config", None)
        if cfg is None or cfg.padding_buckets:
            continue
        emit(
            "padding buckets are disabled (ServingConfig."
            "padding_buckets=False) — every distinct active-set size "
            "compiles a fresh decode executable and every distinct "
            "prompt length a fresh prefill; enable padding_buckets (or "
            "set explicit admit/prompt bucket ladders) so the set of "
            "launch shapes stays bounded",
            node=t.name,
        )


@rule("kv-pool-undersized", Severity.WARN)
def _kv_pool_undersized(ctx: AnalysisContext, emit: Emit) -> None:
    """Open-loop session traffic against a serving plane with no KV
    tier valve.  An open-loop paced source keeps offering NEW sessions
    on its arrival schedule regardless of completion pace, while
    admission is bounded by ``max_active_seqs`` slots per subtask: once
    the offered rate exceeds what those slots can possibly turn over
    (even at one full generation per slot per second), the backlog
    grows without bound — and every budget preemption parks another
    session's KV block (HBM-resident under the default
    ``device_resident_blocks``) with nothing draining it.  The paged
    plane exists for exactly this shape: ``ServingConfig.paged_kv``
    bounds HBM at ``hbm_pages`` and the tier ladder demotes cold
    sessions HBM -> host -> disk instead of accumulating them."""
    for t in ctx.order:
        op = ctx.operators.get(t.id)
        if not getattr(op, "is_continuous_batching", False):
            continue
        cfg = getattr(op, "serving_config", None)
        if cfg is None:
            continue
        tiered = bool(getattr(cfg, "paged_kv", False)) and bool(
            getattr(cfg, "tiering", True))
        if tiered:
            continue
        # Transitive upstream walk: the paced source may sit behind
        # key_by / map stages.
        stack = list(t.inputs)
        seen: typing.Set[int] = set()
        while stack:
            upstream = stack.pop().upstream
            if upstream.id in seen:
                continue
            seen.add(upstream.id)
            stack.extend(upstream.inputs)
            source = _open_loop_feed(ctx.operators.get(upstream.id))
            if source is None:
                continue
            rate_hz = getattr(source, "rate_hz", 0.0) or 0.0
            offered = rate_hz * max(1, upstream.parallelism)
            bound = cfg.max_active_seqs * max(1, t.parallelism)
            if offered > bound:
                fix = ("enable ServingConfig.paged_kv (+ tiering and a "
                       "spill_dir)"
                       if not getattr(cfg, "paged_kv", False)
                       else "re-enable ServingConfig.tiering")
                emit(
                    f"open-loop source offers ~{offered:g} sessions/s "
                    f"against {bound} admission slots "
                    f"({cfg.max_active_seqs} max_active_seqs x "
                    f"{t.parallelism} subtasks) with no KV tier valve — "
                    "the backlog's preempted caches accumulate without "
                    f"bound; {fix} so pressure demotes sessions "
                    "HBM -> host -> disk instead",
                    node=t.name,
                )


@rule("recompile-churn", Severity.WARN)
def _recompile_churn(ctx: AnalysisContext, emit: Emit) -> None:
    """Shape-signature churn at runner boundaries: several distinct
    schemas on one input (e.g. a union of differently-shaped streams)
    alternate launch configurations batch by batch; window fires reaching
    a runner with no batch bucketing take a new one per distinct fire
    size."""
    from flink_tensorflow_tpu_torch.core.operators import WindowOperator

    for t in ctx.order:
        function = ctx.function_of(t)
        if not getattr(function, "is_jit_boundary", False):
            continue
        arriving = ctx.input_schema_set(t)
        if len(arriving) > 1:
            emit(
                f"{len(arriving)} distinct schema signatures flow into "
                "this runner boundary — each alternation re-plans or "
                "round-robins launch shapes; split the streams or coerce "
                "to one schema upstream: "
                + "; ".join(repr(s) for s in arriving),
                node=t.name,
            )
        policy = _plan_policy(function)
        if (isinstance(ctx.operators.get(t.id), WindowOperator)
                and policy is None):
            emit(
                "window fires reach a runner boundary with no batch-bucket "
                "policy — partial fires (timeouts, end of input) each "
                "launch a fresh batch size; set a BucketPolicy",
                node=t.name,
            )


# ---------------------------------------------------------------------------
# shardcheck family (analysis/shardcheck.py): the layout / donation /
# device-memory budget / launch-signature verdicts register themselves here
# so analyze(), validate_plan() and every CLI carry them.  Imported at the
# bottom because shardcheck needs `rule` (defined above) at registration.
# ---------------------------------------------------------------------------

from flink_tensorflow_tpu_torch.analysis import shardcheck as _shardcheck  # noqa: E402

_shardcheck._register_rules()

# statecheck family (analysis/statecheck.py): hidden-state / train-state /
# rescale-safety / RNG-stream / page-keygroup verdicts plus the
# exactly-once dataflow pass register the same way.

from flink_tensorflow_tpu_torch.analysis import statecheck as _statecheck  # noqa: E402

_statecheck._register_rules()
