"""Shardcheck — the static layout, donation and device-memory analyzer.

Port of ``flink_tensorflow_tpu/analysis/shardcheck.py``.  The plan
analyzer stops at the dataflow graph and the sanitizer at the record
plane; this module looks inside the runner units a captured plan will
execute — ``ModelFunction`` methods, the ``OnlineTrainFunction`` /
``DPTrainWindowFunction`` steps, and the serving operator's decode
runners (the very functions ``functions/runner.py`` calls: ``dense_prefill``,
``paged_prefill``, ``paged_decode`` and the model's padded
``decode_step``) — against a declared mesh, which may be shape-only
(``parallel.mesh.abstract_mesh``), and derives six verdict families,
each its own lint rule with operator/edge provenance:

- ``shardcheck-collectives`` (INFO): the collectives per step of each
  unit, under the reference's primitive names (:data:`COLLECTIVE_NAMES`).
- ``shardcheck-reshard`` (WARN; ERROR on a device-resident chained edge):
  an upstream's declared output layout (``output_sharding_axes``) that
  differs from its consumer's ``sharding_axes``.
- ``shardcheck-donation`` (WARN): a large batch input with a matching
  output that is not donated, a donation with no output of its shape, a
  donation defeated by a dtype mismatch; and a decode step whose cache
  output cannot be written into the pool in place.
- ``shardcheck-partition`` (ERROR): a sharded dim that does not divide
  its mesh axes (the batch over ``data`` x ``fsdp``, params over
  ``fsdp`` / ``tp`` per :class:`SpecLayout`, the KV pool's heads over
  ``tp``).
- ``shardcheck-hbm-budget`` (ERROR against ``JobConfig.hbm_budget_bytes``;
  INFO summaries): params + optimizer state + KV pool + peak activations
  per device, the admission gate of ``execute(validate=True)``.
- ``shardcheck-signatures`` (WARN unbounded / INFO bounded): the launch
  shapes a plan can present, from ``ServingConfig.compile_signatures``
  and the bucket policies.

Where the reference walks closed jaxprs, the port runs each unit ONCE on
meta tensors (shapes and dtypes, no storage) under the pricer's
``TorchDispatchMode`` walk (``analysis/costmodel.py:cost_of_call``, K1
through ``ops.flash_attention.meta_calls``):

- the peak activation is the walk's ``peak_live_bytes``: the high-water
  mark of live op outputs (inputs and weights excluded, as the
  reference's liveness scan excludes them).  Torch frees a tensor at its
  last reference, where XLA plans buffers over the whole program, so the
  two peaks agree in size, not to the byte;
- the collectives are the port's own entry points
  (``parallel/collectives.py``), counted by the walk under
  ``collectives.census()`` (they count and move nothing on meta tensors).

In torch the KV pool is written in place by construction (the runner
hands the pool to the step and the step writes into it), so the
reference's "donated by construction" audit becomes "in place by
construction": the one way to lose it is a cache the step returns in
another dtype or shape than the pool's, which stays a donation finding.
The port's paged pool holds one page more than ``hbm_pages`` (the
scratch page sentinel table entries write to), and its ``kv_pool``
bytes count it, as the live runner allocates it.

Everything is fail-soft: a unit whose walk raises becomes a note on its
audit.  Front doors: ``analyze(graph)`` / ``env.validate_plan()`` (the
rules register from the bottom of ``analysis/rules.py``), ``python -m
flink_tensorflow_tpu_torch.analysis.shardcheck`` (the JSON report
``tracing/doctor.py --shardcheck`` folds in) and :func:`audit_plan`.
"""

from __future__ import annotations

import dataclasses
import math
import typing

from flink_tensorflow_tpu_torch.analysis.diagnostics import Severity, edge_name

if typing.TYPE_CHECKING:
    from flink_tensorflow_tpu_torch.analysis.rules import AnalysisContext

#: The port's collective entry points (``collectives.calls`` keys) under
#: the reference's primitive names: the census reads the same as the
#: reference's for the same program.
COLLECTIVE_NAMES = {
    "all_reduce": "psum", "all_gather": "all_gather", "all_to_all": "all_to_all",
    "send_recv": "ppermute", "broadcast": "pbroadcast",
}

#: Donation findings only fire for inputs at least this large: donating
#: a [B] int32 vector buys nothing, and the noise would drown the KV-pool
#: and weight traps the checker exists for.
DONATION_MIN_BYTES = 1 << 20


# ---------------------------------------------------------------------------
# SpecLayout — the fsdp x tp parameter-placement convention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SpecLayout:
    """Declarative fsdp x tp placement for a unit's params and batch.

    The batch shards over ``data`` (x ``fsdp`` when set), 2-D+ weights
    shard ``(fsdp, tp)`` on their trailing two dims — flipped to ``(tp,
    fsdp)`` for output projections, whose contracting dim is the sharded
    one — and 1-D params (biases, norm scales) replicate.  A function or
    operator opts in with a ``spec_layout`` attribute; without one,
    params replicate and only the batch divides over its declared
    ``sharding_axes``."""

    data_axis: str = "data"
    fsdp_axis: typing.Optional[str] = None
    tp_axis: typing.Optional[str] = None

    #: Param-name hints whose matmul places the sharded dim first
    #: (output projections: wo/w2/down_proj/out_proj/lm_head).
    out_proj_hints: typing.Tuple[str, ...] = (
        "wo", "w2", "down", "out", "head")

    def batch_axes(self) -> typing.Tuple[str, ...]:
        return tuple(a for a in (self.data_axis, self.fsdp_axis) if a)

    def param_spec(
        self, path: str, shape: typing.Sequence[int]
    ) -> typing.Tuple[typing.Optional[str], ...]:
        """Mesh axis (or None = replicated) per dim of one param leaf."""
        n = len(shape)
        if n < 2 or (self.fsdp_axis is None and self.tp_axis is None):
            return (None,) * n
        leaf = path.rsplit("/", 1)[-1].lower()
        flipped = any(h in leaf for h in self.out_proj_hints)
        spec: typing.List[typing.Optional[str]] = [None] * n
        first, second = ((self.tp_axis, self.fsdp_axis) if flipped
                         else (self.fsdp_axis, self.tp_axis))
        spec[-2], spec[-1] = first, second
        return tuple(spec)


# ---------------------------------------------------------------------------
# audit data model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Finding:
    """One shardcheck verdict, shaped for the Diagnostic plumbing."""

    rule: str
    severity: Severity
    message: str
    node: typing.Optional[str] = None
    edge: typing.Optional[str] = None

    def to_json(self) -> dict:
        return {"rule": self.rule, "severity": self.severity.name,
                "message": self.message, "node": self.node, "edge": self.edge}


@dataclasses.dataclass
class OpAudit:
    """Everything shardcheck derived about one operator's unit(s)."""

    node: str
    kind: str  # model | train | serving
    #: primitive name -> occurrences per step, summed over the units.
    collectives: typing.Dict[str, int] = dataclasses.field(default_factory=dict)
    #: per-device byte breakdown: params / optimizer / kv_pool / activations.
    hbm: typing.Dict[str, int] = dataclasses.field(default_factory=dict)
    #: bounded launch-signature count (None = unbounded/unknown).
    signatures: typing.Optional[int] = None
    #: predicted H2D bytes of one padded decode step (serving only): the
    #: runner's own ``decode_h2d_bytes``, what ``step_h2d_bytes`` counts.
    predicted_step_h2d_bytes: typing.Optional[int] = None
    #: why parts of the audit were skipped (fail-soft provenance).
    notes: typing.List[str] = dataclasses.field(default_factory=list)

    @property
    def hbm_total(self) -> int:
        return sum(self.hbm.values())

    def to_json(self) -> dict:
        return {
            "node": self.node, "kind": self.kind,
            "collectives": dict(self.collectives),
            "hbm_per_device_bytes": dict(self.hbm),
            "hbm_per_device_total": self.hbm_total,
            "signatures": self.signatures,
            "predicted_step_h2d_bytes": self.predicted_step_h2d_bytes,
            "notes": list(self.notes),
        }


@dataclasses.dataclass
class PlanAudit:
    """The full shardcheck result for one captured plan."""

    findings: typing.List[Finding]
    ops: typing.List[OpAudit]
    mesh_axes: typing.Optional[typing.Dict[str, int]]
    hbm_budget_bytes: typing.Optional[int]

    def op(self, node: str) -> typing.Optional[OpAudit]:
        for a in self.ops:
            if a.node == node:
                return a
        return None

    @property
    def total_hbm_per_device(self) -> int:
        return sum(a.hbm_total for a in self.ops)

    def to_json(self) -> dict:
        return {
            "mesh_axes": self.mesh_axes,
            "hbm_budget_bytes": self.hbm_budget_bytes,
            "hbm_per_device_total": self.total_hbm_per_device,
            "operators": [a.to_json() for a in self.ops],
            "findings": [f.to_json() for f in self.findings],
        }


# ---------------------------------------------------------------------------
# the unit walk
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class UnitWalk:
    """One unit run once on meta tensors."""

    peak_activation_bytes: int
    collectives: typing.Dict[str, int]
    result: typing.Any


def walk_unit(fn: typing.Callable, *args, **kwargs) -> UnitWalk:
    """Run ``fn(*args, **kwargs)`` once on meta tensors under the pricer's
    walk: its peak live output bytes and its collectives by the
    reference's names."""
    import torch

    from flink_tensorflow_tpu_torch.analysis.costmodel import cost_of_call

    box = []
    with torch.no_grad():
        cost = cost_of_call(lambda: box.append(fn(*args, **kwargs)))
    named: typing.Dict[str, int] = {}
    for kind, n in cost.collectives.items():
        name = COLLECTIVE_NAMES.get(kind, kind)
        named[name] = named.get(name, 0) + n
    return UnitWalk(cost.peak_live_bytes, named, box[0])


# ---------------------------------------------------------------------------
# per-device placement math
# ---------------------------------------------------------------------------


def _param_paths(params) -> typing.List[typing.Tuple[str, typing.Any]]:
    """(slash path, leaf) pairs of a module (its ``state_dict`` names, dots
    as slashes) or of a tree of dicts, lists and tuples."""
    import torch

    if isinstance(params, torch.nn.Module):
        named = list(params.named_parameters()) + list(params.named_buffers())
        return [(name.replace(".", "/"), t) for name, t in named]
    out: typing.List[typing.Tuple[str, typing.Any]] = []

    def walk(prefix: typing.Tuple[str, ...], node) -> None:
        if isinstance(node, typing.Mapping):
            for k, v in node.items():
                walk(prefix + (str(k),), v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(prefix + (str(i),), v)
        elif node is not None:
            out.append(("/".join(prefix) or "param", node))

    walk((), params)
    return out


def _leaf_shape_dtype(leaf):
    """(shape, torch dtype) of a tensor, a numpy array or a number."""
    import numpy as np
    import torch

    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), leaf.dtype
    arr = np.asarray(leaf)
    return tuple(arr.shape), torch.from_numpy(np.zeros((), arr.dtype)).dtype


def dtype_name(dtype) -> str:
    """``float32`` for ``torch.float32`` (numpy's spelling, the reference's)."""
    return str(dtype).replace("torch.", "")


def _nbytes(shape, dtype) -> int:
    return int(math.prod(shape)) * dtype.itemsize if shape else dtype.itemsize


def _params_per_device(
    params, layout: SpecLayout,
    mesh_axes: typing.Optional[typing.Dict[str, int]],
    node: str, what: str,
    findings: typing.List[Finding],
) -> int:
    """Per-device bytes of a params tree under ``layout``, with a
    ``shardcheck-partition`` finding per indivisible sharded dim, naming
    the buffer and the axis."""
    total = 0
    for path, leaf in _param_paths(params):
        shape, dtype = _leaf_shape_dtype(leaf)
        nbytes = _nbytes(shape, dtype)
        divide = 1
        if mesh_axes:
            for dim, axis in enumerate(layout.param_spec(path, shape)):
                size = mesh_axes.get(axis, 1) if axis else 1
                if size <= 1:
                    continue
                if shape[dim] % size:
                    findings.append(Finding(
                        rule="shardcheck-partition", severity=Severity.ERROR,
                        message=(
                            f"{what} buffer {path!r} dim {dim} "
                            f"({shape[dim]}) does not divide mesh axis "
                            f"{axis!r} ({size}) — the sharding is ragged "
                            "and the first call fails after the job "
                            "started; pad the dim or resize the axis"),
                        node=node))
                else:
                    divide *= size
        total += nbytes // divide
    return total


def _batch_axes_product(
    batch_axes: typing.Sequence[str],
    mesh_axes: typing.Optional[typing.Dict[str, int]],
) -> int:
    if not mesh_axes:
        return 1
    return math.prod(mesh_axes.get(a, 1) for a in batch_axes) or 1


def _check_batch_partition(
    batch: typing.Optional[int], batch_axes: typing.Sequence[str],
    mesh_axes: typing.Optional[typing.Dict[str, int]],
    node: str, findings: typing.List[Finding],
) -> int:
    """Divisibility of the batch dim over its sharding axes; returns the
    per-device divisor (1 when unsharded or indivisible)."""
    prod = _batch_axes_product(batch_axes, mesh_axes)
    if prod <= 1 or batch is None:
        return max(prod, 1)
    if batch % prod:
        findings.append(Finding(
            rule="shardcheck-partition", severity=Severity.ERROR,
            message=(
                f"batch {batch} does not divide the sharded batch axes' "
                f"device product ({'x'.join(batch_axes)} = {prod}) — "
                "per-device shards would be ragged; pick a multiple"),
            node=node))
        return 1
    return prod


# ---------------------------------------------------------------------------
# unit audits
# ---------------------------------------------------------------------------


def _donation_findings(
    *, donate: bool, inputs: typing.Mapping[str, typing.Any],
    outputs: typing.Mapping[str, typing.Any],
    node: str, where: str,
) -> typing.List[Finding]:
    """Donation verdicts for one unit's batch inputs (name -> tensor).

    A donated input is worth its pages only where an output of its shape
    and dtype can take them; without donation any such large pair keeps
    both buffers live across the call."""
    findings: typing.List[Finding] = []
    out_list = [(n, tuple(t.shape), t.dtype) for n, t in outputs.items()]
    for name, t in inputs.items():
        shape, dtype = tuple(t.shape), t.dtype
        nbytes = _nbytes(shape, dtype)
        if nbytes < DONATION_MIN_BYTES:
            continue
        exact = [o for o, osh, odt in out_list if osh == shape and odt == dtype]
        shape_only = [(o, odt) for o, osh, odt in out_list
                      if osh == shape and odt != dtype]
        mib = nbytes / 2**20
        if not donate and exact:
            findings.append(Finding(
                rule="shardcheck-donation", severity=Severity.WARN,
                message=(
                    f"{where}: arg {name!r} ({mib:.1f} MiB) has a shape/"
                    f"dtype-matching output ({exact[0]!r}) but is NOT "
                    "donated — both buffers stay live across the runner "
                    "call (2x HBM); pass donate_inputs=True so the runner "
                    "drops the batch as soon as the method returns"),
                node=node))
        elif donate and not exact and shape_only:
            o, odt = shape_only[0]
            findings.append(Finding(
                rule="shardcheck-donation", severity=Severity.WARN,
                message=(
                    f"{where}: donated arg {name!r} ({mib:.1f} MiB, "
                    f"{dtype_name(dtype)}) is DEFEATED by a dtype mismatch — "
                    f"the shape-matching output {o!r} is {dtype_name(odt)}, so "
                    "its pages cannot serve the output and both stay "
                    "allocated; align the dtypes to make the donation real"),
                node=node))
        elif donate and not exact:
            findings.append(Finding(
                rule="shardcheck-donation", severity=Severity.WARN,
                message=(
                    f"{where}: donated arg {name!r} ({mib:.1f} MiB) has "
                    "no shape-matching output to alias — the donation is "
                    "dead (the buffer is freed but nothing reuses it); drop "
                    "donate_inputs or return an updated buffer"),
                node=node))
    return findings


def _signature_count(
    function, in_schema, node: str, findings: typing.List[Finding],
) -> typing.Optional[int]:
    """Bounded launch-signature count for a bucket-policied runner
    boundary, or None (unbounded) with a WARN."""
    hook = getattr(function, "plan_policy", None)
    policy = hook() if hook is not None else getattr(function, "_policy", None)
    if policy is None:
        findings.append(Finding(
            rule="shardcheck-signatures", severity=Severity.WARN,
            message=("runner boundary has no bucket policy — every distinct "
                     "batch size is a fresh launch shape (unbounded "
                     "signature set); set a BucketPolicy"),
            node=node))
        return None
    if policy.fixed_batch is not None:
        batches = 1
    else:
        batches = len(getattr(policy.batch, "sizes", ()) or ()) or None
    if batches is None:
        findings.append(Finding(
            rule="shardcheck-signatures", severity=Severity.WARN,
            message=("batch bucket ladder is empty — the signature set is "
                     "unbounded; give the BucketPolicy a batch ladder"),
            node=node))
        return None
    dynamic = in_schema is not None and not in_schema.is_static
    if not dynamic:
        return batches
    lengths = len(getattr(policy.lengths, "sizes", ()) or ())
    if not lengths:
        findings.append(Finding(
            rule="shardcheck-signatures", severity=Severity.WARN,
            message=("dynamic input dims with no length ladder — every "
                     "observed length is a fresh launch shape (unbounded "
                     "signature set); set BucketPolicy.lengths"),
            node=node))
        return None
    return batches * lengths


def _tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _audit_model_function(
    t, function, in_schema,
    layout: SpecLayout,
    mesh_axes: typing.Optional[typing.Dict[str, int]],
    findings: typing.List[Finding],
) -> OpAudit:
    from flink_tensorflow_tpu_torch.analysis.chaining import sharding_axes_of
    from flink_tensorflow_tpu_torch.models.base import Model, meta_module

    audit = OpAudit(node=t.name, kind="model")
    source = getattr(function, "_source", None)
    schema = function.plan_input_schema() or in_schema
    audit.signatures = _signature_count(function, schema, t.name, findings)
    if not isinstance(source, Model):
        audit.notes.append("lazy model source — the runner unit is not "
                           "walkable at plan time (pass a resolved Model)")
        return audit
    try:
        method = source.method(function._method_name)
    except KeyError as ex:
        audit.notes.append(f"model method unresolvable: {ex}")
        return audit
    if schema is None:
        audit.notes.append("input schema unknown — the runner unit is skipped")
        return audit
    policy = function.plan_policy()
    sizes = getattr(policy.batch, "sizes", ()) or ()
    batch = policy.fixed_batch or (sizes[-1] if sizes else 1)
    axes = sharding_axes_of(function) or ()
    div = _check_batch_partition(batch, axes, mesh_axes, t.name, findings)
    audit.hbm["params"] = _params_per_device(
        source.params, layout, mesh_axes, t.name, "param", findings)
    if method.needs_lengths:
        audit.notes.append("method takes per-record lengths — the walk is "
                           "skipped (no schema slot to run it from)")
        return audit
    try:
        struct = schema.batched_struct(batch, length_bucket=function._warmup_length_bucket)
        walk = walk_unit(method.fn, meta_module(source.params), dict(struct))
        audit.collectives = walk.collectives
        audit.hbm["activations"] = (
            walk.peak_activation_bytes + _tensor_bytes(struct.values())) // div
        findings.extend(_donation_findings(
            donate=bool(getattr(function, "_donate", False)), inputs=struct,
            outputs={k: v for k, v in walk.result.items() if hasattr(v, "shape")},
            node=t.name, where=f"method {function._method_name!r}"))
    except Exception as ex:  # noqa: BLE001 - fail-soft by contract
        audit.notes.append(f"meta walk failed: {ex!r}")
    return audit


def _audit_serving_operator(
    t, op,
    layout: SpecLayout,
    mesh_axes: typing.Optional[typing.Dict[str, int]],
    findings: typing.List[Finding],
) -> OpAudit:
    import torch

    from flink_tensorflow_tpu_torch.analysis.costmodel import _meta
    from flink_tensorflow_tpu_torch.functions.runner import (
        decode_h2d_bytes,
        dense_prefill,
        paged_decode,
        paged_prefill,
    )
    from flink_tensorflow_tpu_torch.models.base import meta_module
    from flink_tensorflow_tpu_torch.ops.flash_attention import meta_calls
    from flink_tensorflow_tpu_torch.ops.paged_attention import pages_per_session

    audit = OpAudit(node=t.name, kind="serving")
    cfg = op.serving_config
    sigs = cfg.compile_signatures()
    if sigs is None:
        findings.append(Finding(
            rule="shardcheck-signatures", severity=Severity.WARN,
            message=(
                "padding_buckets=False makes the serving signature set "
                "unbounded — every distinct active-set size is a fresh "
                "decode launch shape and every distinct prompt length a "
                "fresh prefill; enable padding_buckets"),
            node=t.name))
    else:
        audit.signatures = len(sigs)
    model = op.model
    audit.hbm["params"] = _params_per_device(
        model.params, layout, mesh_axes, t.name, "param", findings)
    try:
        prefill = model.method("prefill")
        decode = model.method("decode_step")
        module = meta_module(model.params)
        S, C = cfg.max_active_seqs, cfg.capacity
        B = cfg.bucket_admit(S)
        T = min(cfg.bucket_prompt_len(C), C)
        i32 = torch.int32
        tok, lens = _meta((B, T), i32), _meta((B,), i32)
        with torch.no_grad(), meta_calls():
            k_like = prefill.fn(module, {"tokens": tok, "lengths": lens})["k_cache"]
        _, layers, _, heads, hd = k_like.shape  # [B, L, T, H, Dh]
        pool_dtype = k_like.dtype
        paged = bool(getattr(cfg, "paged_kv", False))
        if paged:
            # The paged budget is the PAGE pool, not seats x capacity (the
            # overflow lives in the host and disk tiers), plus the scratch
            # page the runner allocates beside it.
            pt = cfg.page_tokens
            Pc = pages_per_session(C, pt)
            pool_shape = (cfg.resolved_hbm_pages() + 1, layers, pt, heads, hd)
            step_shape = (S, layers, Pc * pt, heads, hd)  # the gathered view
        else:
            Pc = None
            pool_shape = step_shape = (S, layers, C, heads, hd)
        pool_bytes = 2 * int(math.prod(pool_shape)) * k_like.element_size()
        pool_div = 1
        if mesh_axes and layout.tp_axis:
            tp = mesh_axes.get(layout.tp_axis, 1)
            if tp > 1:
                if heads % tp:
                    findings.append(Finding(
                        rule="shardcheck-partition", severity=Severity.ERROR,
                        message=(
                            f"KV pool buffer 'k_cache' heads dim ({heads}) "
                            f"does not divide mesh axis "
                            f"{layout.tp_axis!r} ({tp}) — the pool "
                            "sharding is ragged; pad heads or resize the "
                            "axis"),
                        node=t.name))
                else:
                    pool_div = tp
        audit.hbm["kv_pool"] = pool_bytes // pool_div
        # The runner's own units, at the largest prefill bucket and the
        # padded step.
        kc, vc = _meta(pool_shape, pool_dtype), _meta(pool_shape, pool_dtype)
        s_tok, s_len = _meta((S,), i32), _meta((S,), i32)
        if paged:
            pf = walk_unit(paged_prefill, prefill, module, tok, lens,
                           _meta((B, Pc), torch.long), kc, vc, C, pt)
            st = walk_unit(paged_decode, decode, module, s_tok, s_len,
                           _meta((S, Pc), torch.long), kc, vc, pt)
        else:
            rows = _meta((B,), torch.long)
            pf = walk_unit(dense_prefill, prefill, module, tok, lens, kc, vc, rows, rows)
            st = walk_unit(decode.fn, module, {
                "token": s_tok, "lengths": s_len, "k_cache": kc, "v_cache": vc,
                "active": _meta((S,), torch.bool)})
        for walk in (pf, st):
            for name, n in walk.collectives.items():
                audit.collectives[name] = audit.collectives.get(name, 0) + n
        audit.hbm["activations"] = max(pf.peak_activation_bytes, st.peak_activation_bytes)
        # In place by construction: the step writes its cache into the
        # pool (the dense step into the pool itself, the paged one through
        # the gathered view it scatters back), so the one way to lose that
        # is a cache returned in another dtype or shape.
        out_k = st.result["k_cache"]
        if out_k.dtype != pool_dtype or tuple(out_k.shape) != step_shape:
            findings.append(Finding(
                rule="shardcheck-donation", severity=Severity.WARN,
                message=(
                    f"decode step: in-place KV pool 'k_cache' "
                    f"({dtype_name(pool_dtype)}, {pool_shape}) is DEFEATED — "
                    f"the step returns {dtype_name(out_k.dtype)} "
                    f"{tuple(out_k.shape)}, so the update cannot land in the "
                    "pool pages and a second copy stays live (2x HBM); align "
                    "the model's cache dtype"),
                node=t.name))
        # The runner's own per-step count (DecodeStepRunner.decode_step's
        # step_h2d_bytes): [S] tokens and lengths, int32, then the [S] bool
        # mask (dense) or the [S, C/page_tokens] int32 block tables
        # (paged).  Without padding buckets the step ships the active rows
        # only, which varies.
        if paged or cfg.padding_buckets:
            audit.predicted_step_h2d_bytes = decode_h2d_bytes(S, Pc)
    except Exception as ex:  # noqa: BLE001 - fail-soft by contract
        audit.notes.append(f"meta walk failed: {ex!r}")
    return audit


def _audit_train_function(
    t, function,
    layout: SpecLayout,
    mesh_axes: typing.Optional[typing.Dict[str, int]],
    findings: typing.List[Finding],
) -> OpAudit:
    import torch

    from flink_tensorflow_tpu_torch.analysis.chaining import sharding_axes_of
    from flink_tensorflow_tpu_torch.analysis.costmodel import _meta, _meta_train_state

    audit = OpAudit(node=t.name, kind="train")
    batch = (getattr(function, "global_batch", None)
             or getattr(function, "mini_batch", None) or 1)
    schema = function.train_schema
    audit.signatures = _signature_count(function, schema, t.name, findings)
    axes = sharding_axes_of(function) or ()
    div = _check_batch_partition(batch, axes, mesh_axes, t.name, findings)
    try:
        from flink_tensorflow_tpu_torch.parallel.dp import make_train_step
        from flink_tensorflow_tpu_torch.parallel.optim import sgd

        optimizer = function.optimizer or sgd(0.01)
        state = _meta_train_state(function.model_def, optimizer)
        audit.hbm["params"] = _params_per_device(
            state["variables"], layout, mesh_axes, t.name, "param", findings)
        audit.hbm["optimizer"] = _params_per_device(
            state["opt_state"], layout, mesh_axes, t.name, "optimizer-state", findings)
        # The train batch of _train_batch_arrays: the schema's fields at
        # [B, ...] (+ <field>_len int32 for dynamic fields) and a [B] f32
        # valid mask.
        struct = dict(schema.batched_struct(
            batch, length_bucket=getattr(function, "_warmup_length_bucket", 128)))
        for name in schema.names:
            if not schema[name].is_static:
                struct[f"{name}_len"] = _meta((batch,), torch.int32)
        struct["valid"] = _meta((batch,), torch.float32)
        step = make_train_step(function.model_def, optimizer)
        walk = walk_unit(step, state, struct, 0)
        audit.collectives = walk.collectives
        audit.hbm["activations"] = (
            walk.peak_activation_bytes + _tensor_bytes(struct.values())) // div
        if getattr(function, "is_gang", False) and mesh_axes and any(
                s > 1 for s in mesh_axes.values()):
            audit.notes.append(
                "gang step walked on one device (make_train_step); the "
                "gradient all-reduce of make_dp_train_step over the data "
                "axis is not in this count")
    except Exception as ex:  # noqa: BLE001 - fail-soft by contract
        audit.notes.append(f"meta walk failed: {ex!r}")
    return audit


# ---------------------------------------------------------------------------
# the plan walk
# ---------------------------------------------------------------------------


def _layout_of(op, function) -> SpecLayout:
    for holder in (function, op):
        layout = getattr(holder, "spec_layout", None)
        if layout is not None:
            return layout
    return SpecLayout()


def _reshard_findings(
    ctx: "AnalysisContext", findings: typing.List[Finding],
) -> None:
    """Edge-level reshard audit: an upstream's declared OUTPUT layout
    against its consumer's declared input sharding, an ERROR on a
    device-resident chained edge (where the reshard defeats the H2D
    elision the chain exists for)."""
    from flink_tensorflow_tpu_torch.analysis.chaining import (
        compute_chains,
        sharding_axes_of,
    )

    plan = compute_chains(ctx.graph, operators=ctx.operators)
    resident_on = ctx.config is None or getattr(ctx.config, "device_resident", False)
    for t in ctx.order:
        down_in = sharding_axes_of(ctx.function_of(t))
        if down_in is None:
            continue
        for e in t.inputs:
            up_fn = ctx.function_of(e.upstream)
            if up_fn is None:
                continue
            up_out = getattr(up_fn, "output_sharding_axes", None)
            if up_out is None:
                up_out = sharding_axes_of(up_fn)
            if up_out is None or tuple(up_out) == tuple(down_in):
                continue
            resident = (resident_on
                        and (e.upstream.id, t.id) in plan.device_resident_edges)
            findings.append(Finding(
                rule="shardcheck-reshard",
                severity=Severity.ERROR if resident else Severity.WARN,
                message=(
                    f"upstream emits batches laid out over axes "
                    f"{tuple(up_out)} but this operator expects "
                    f"{tuple(down_in)} — every batch crossing this edge is "
                    "resharded (all-to-all traffic)"
                    + ("; the edge is a device-resident chained hop, so the "
                       "reshard defeats the h2d elision the chain exists "
                       "for — align the layouts or cut the chain"
                       if resident else
                       "; align the upstream output_sharding_axes with the "
                       "consumer (or reshard once, upstream)")),
                node=t.name, edge=edge_name(e.upstream.name, t.name)))


def audit_plan(ctx: "AnalysisContext") -> PlanAudit:
    """Run the full shardcheck pass over an analysis context."""
    config = ctx.config
    mesh = getattr(config, "mesh", None) if config is not None else None
    mesh_axes = dict(mesh.shape) if mesh is not None else None
    budget = getattr(config, "hbm_budget_bytes", None) if config is not None else None
    findings: typing.List[Finding] = []
    ops: typing.List[OpAudit] = []
    for t in ctx.order:
        op = ctx.operators.get(t.id)
        if op is None:
            continue
        function = getattr(op, "function", None)
        layout = _layout_of(op, function)
        if getattr(op, "is_continuous_batching", False):
            ops.append(_audit_serving_operator(t, op, layout, mesh_axes, findings))
        elif hasattr(function, "model_def") and hasattr(function, "train_schema"):
            ops.append(_audit_train_function(t, function, layout, mesh_axes, findings))
        elif getattr(function, "is_jit_boundary", False) and hasattr(
                function, "plan_input_schema"):
            ops.append(_audit_model_function(
                t, function, ctx.input_schema(t), layout, mesh_axes, findings))
    _reshard_findings(ctx, findings)
    # Collective census: one INFO per unit that issues any.
    for a in ops:
        if a.collectives:
            census = ", ".join(f"{n}x{c}" for c, n in sorted(
                ((v, k) for k, v in a.collectives.items()), reverse=True))
            findings.append(Finding(
                rule="shardcheck-collectives", severity=Severity.INFO,
                message=f"per-step collectives in the runner unit: {census}",
                node=a.node))
    # The budget: an ERROR per operator over it, INFO summaries when a
    # mesh or a budget was declared (silent otherwise: no target, nothing
    # to gate).
    if budget is not None or mesh_axes is not None:
        for a in ops:
            if not a.hbm:
                continue
            breakdown = ", ".join(
                f"{k}={v / 2**20:.1f}MiB" for k, v in sorted(a.hbm.items()))
            total = a.hbm_total
            if budget is not None and total > budget:
                findings.append(Finding(
                    rule="shardcheck-hbm-budget", severity=Severity.ERROR,
                    message=(
                        f"static per-device HBM {total / 2**20:.1f} MiB "
                        f"exceeds hbm_budget_bytes "
                        f"({budget / 2**20:.1f} MiB): {breakdown} — shard "
                        "further (fsdp/tp), shrink the KV pool "
                        "(max_active_seqs/capacity), or raise the budget"),
                    node=a.node))
            else:
                findings.append(Finding(
                    rule="shardcheck-hbm-budget", severity=Severity.INFO,
                    message=(f"static per-device HBM "
                             f"{total / 2**20:.1f} MiB: {breakdown}"),
                    node=a.node))
        if budget is not None and len(ops) > 1:
            plan_total = sum(a.hbm_total for a in ops)
            findings.append(Finding(
                rule="shardcheck-hbm-budget",
                severity=Severity.ERROR if plan_total > budget else Severity.INFO,
                message=(
                    f"plan-total static per-device HBM "
                    f"{plan_total / 2**20:.1f} MiB vs budget "
                    f"{budget / 2**20:.1f} MiB (all runner units co-resident "
                    "on one device in the single-device placement)")))
    # Bounded-signature census (the unbounded WARNs were emitted inline).
    for a in ops:
        if a.signatures is not None:
            findings.append(Finding(
                rule="shardcheck-signatures", severity=Severity.INFO,
                message=(f"compile-signature set is bounded: "
                         f"{a.signatures} signature(s)"),
                node=a.node))
    return PlanAudit(findings=findings, ops=ops, mesh_axes=mesh_axes,
                     hbm_budget_bytes=budget)


def audit_of(ctx: "AnalysisContext") -> PlanAudit:
    """The audit of ``ctx``, computed once: the six rules (and the report)
    share one walk."""
    cached = ctx.__dict__.get("_shardcheck_audit")
    if cached is None:
        cached = audit_plan(ctx)
        ctx.__dict__["_shardcheck_audit"] = cached
    return cached


# ---------------------------------------------------------------------------
# lint registry wiring: each verdict family is its own rule id over the
# shared audit, registered from the bottom of analysis/rules.py
# ---------------------------------------------------------------------------


def _emit_family(ctx, emit, rule_id: str) -> None:
    for f in audit_of(ctx).findings:
        if f.rule == rule_id:
            emit(f.message, node=f.node, edge=f.edge, severity=f.severity)


def _register_rules() -> None:
    from flink_tensorflow_tpu_torch.analysis.rules import rule

    @rule("shardcheck-collectives", Severity.INFO)
    def _shardcheck_collectives(ctx, emit) -> None:
        """Collective census per runner unit: all-reduce / all-gather /
        all-to-all / send-recv counts under the reference's primitive
        names, from one meta walk of the unit — the per-step
        interconnect bill, visible before any run."""
        _emit_family(ctx, emit, "shardcheck-collectives")

    @rule("shardcheck-reshard", Severity.WARN)
    def _shardcheck_reshard(ctx, emit) -> None:
        """Reshard audit: an edge whose upstream output layout differs
        from the consumer's declared input sharding reshards EVERY
        batch; ERROR when the edge is a device-resident chained hop (the
        reshard defeats the h2d elision)."""
        _emit_family(ctx, emit, "shardcheck-reshard")

    @rule("shardcheck-donation", Severity.WARN)
    def _shardcheck_donation(ctx, emit) -> None:
        """Donation checker: large inputs not donated through a runner
        boundary (the 2x-memory trap), dead donations, donations
        defeated by a dtype or shape mismatch, and a decode step that
        cannot write its cache into the pool in place — each finding
        names the buffer."""
        _emit_family(ctx, emit, "shardcheck-donation")

    @rule("shardcheck-partition", Severity.ERROR)
    def _shardcheck_partition(ctx, emit) -> None:
        """Indivisible sharded dims under the declared mesh: a batch that
        does not divide its data x fsdp product, a param/KV dim that does
        not divide its fsdp/tp axis — ragged shards fail (or hang) the
        first call after the job already started."""
        _emit_family(ctx, emit, "shardcheck-partition")

    @rule("shardcheck-hbm-budget", Severity.ERROR)
    def _shardcheck_hbm_budget(ctx, emit) -> None:
        """Static per-device memory budget: params + optimizer state + KV
        pool + peak activations (the meta walk's live bytes) per device
        under the mesh, gated against JobConfig.hbm_budget_bytes."""
        _emit_family(ctx, emit, "shardcheck-hbm-budget")

    @rule("shardcheck-signatures", Severity.WARN)
    def _shardcheck_signatures(ctx, emit) -> None:
        """Launch-signature enumeration, the static twin of the runtime
        recompile-churn lints: bounded counts (INFO) from the
        ServingConfig / BucketPolicy ladders, WARN on unbounded sets."""
        _emit_family(ctx, emit, "shardcheck-signatures")


# ---------------------------------------------------------------------------
# report + CLI
# ---------------------------------------------------------------------------


def report_for_env(env, pipeline: typing.Optional[str] = None) -> dict:
    """The JSON shardcheck report for one captured plan — the reference's
    keys, which ``tracing/doctor.py --shardcheck`` folds in."""
    from flink_tensorflow_tpu_torch.analysis.costmodel import context_for_env

    audit = audit_of(context_for_env(env))
    report = audit.to_json()
    report["pipeline"] = pipeline
    report["errors"] = sum(1 for f in audit.findings if f.severity == Severity.ERROR)
    return report


def _parse_mesh(spec: str) -> typing.Dict[str, int]:
    axes: typing.Dict[str, int] = {}
    for part in spec.split(","):
        if not part.strip():
            continue
        name, _, size = part.partition("=")
        axes[name.strip()] = int(size)
    return axes


def main(argv=None) -> int:
    """``python -m flink_tensorflow_tpu_torch.analysis.shardcheck``: exit
    0 with no ERROR, 1 with one, 2 when a script could not be captured."""
    import argparse
    import dataclasses as dc
    import json
    import sys

    parser = argparse.ArgumentParser(
        prog="python -m flink_tensorflow_tpu_torch.analysis.shardcheck",
        description="Layout, donation and device-memory static analyzer: "
                    "walks every runner unit of a captured plan on meta "
                    "tensors against a declared (shape-only) mesh — no "
                    "devices, no execution.",
    )
    parser.add_argument("pipelines", nargs="+", metavar="pipeline.py",
                        help="pipeline script(s) defining main(argv)")
    parser.add_argument("--job-args", default="--smoke --cpu",
                        help="argv passed to each pipeline's main() while "
                             "building its graph (default: '--smoke --cpu')")
    parser.add_argument("--mesh", metavar="data=4,tp=2",
                        help="override the job's mesh with a shape-only mesh "
                             "of these axes")
    parser.add_argument("--hbm-budget-bytes", type=int, default=None,
                        help="override JobConfig.hbm_budget_bytes (an H100 SXM "
                             "holds 80 GiB)")
    parser.add_argument("--json", action="store_true",
                        help="emit one JSON report per pipeline")
    parser.add_argument("--out", metavar="REPORT.json",
                        help="also write the (last) JSON report here — the "
                             "file tracing/doctor.py --shardcheck reads")
    parser.add_argument("--cost-table", metavar="TABLE.json",
                        help="also price the (last) captured plan "
                             "(analysis/costmodel.py) and write its CostTable "
                             "here — the file the roofline plane reads")
    args = parser.parse_args(argv)

    from flink_tensorflow_tpu_torch.analysis.capture import capture_pipeline_file

    job_args = args.job_args.split()
    exit_code = 0
    report = None
    last_env = None
    for path in args.pipelines:
        try:
            env = capture_pipeline_file(path, job_args)
        except Exception as ex:  # noqa: BLE001 - report and keep going
            print(f"{path}: capture failed: {ex}", file=sys.stderr)
            exit_code = max(exit_code, 2)
            continue
        config = env.config
        if args.mesh:
            from flink_tensorflow_tpu_torch.parallel.mesh import abstract_mesh

            config = dc.replace(config, mesh=abstract_mesh(_parse_mesh(args.mesh)))
        if args.hbm_budget_bytes is not None:
            config = dc.replace(config, hbm_budget_bytes=args.hbm_budget_bytes)
        env.config = config
        last_env = env
        report = report_for_env(env, pipeline=path)
        if args.json:
            print(json.dumps(report))
        else:
            mesh = report["mesh_axes"]
            print(f"== {path} (mesh: {mesh or 'none declared'}, "
                  f"budget: {report['hbm_budget_bytes'] or 'none'}) ==")
            for a in report["operators"]:
                line = f"  [{a['kind']}] {a['node']}"
                if a["hbm_per_device_total"]:
                    line += f"  hbm/device={a['hbm_per_device_total'] / 2**20:.1f}MiB"
                if a["signatures"] is not None:
                    line += f"  signatures={a['signatures']}"
                if a["collectives"]:
                    line += f"  collectives={a['collectives']}"
                print(line)
                for note in a["notes"]:
                    print(f"      note: {note}")
            for f in report["findings"]:
                where = f" [{f['edge'] or f['node'] or 'plan'}]"
                print(f"  {f['severity']:5s} {f['rule']}{where}: {f['message']}")
        if report["errors"]:
            exit_code = max(exit_code, 1)
    if args.out and report is not None:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=2)
    if args.cost_table and last_env is not None:
        from flink_tensorflow_tpu_torch.analysis.costmodel import cost_table_for_env

        with open(args.cost_table, "w") as fh:
            json.dump(cost_table_for_env(last_env).to_json(), fh, indent=2)
        print(f"cost table -> {args.cost_table}")
    return exit_code


if __name__ == "__main__":
    import sys

    sys.exit(main())
