"""Static cost model — the plan-time half of the roofline plane.

Port of ``flink_tensorflow_tpu/analysis/costmodel.py``: the data classes
(``:95-192``) and the pricer (``:193-299``, ``:310-594``).  The pricer
prices every runner unit of a plan — one call of one method at one call
signature — without running it: the unit runs once on ``meta`` tensors
(shapes and dtypes, no storage: nothing is allocated on any device and no
weight is copied) under a ``TorchDispatchMode`` that sees every ATen op
the call reaches.  The result is a :class:`CostTable`, which
``JobConfig.roofline`` ships to every runner, where
``metrics/roofline.py`` joins it against measured step times (achieved
FLOP/s, MFU, bound) and diffs the predicted signature ladder against the
shapes met at run time.

Estimation contract (the reference's, over ATen ops instead of jaxpr
equations):

- FLOPs: matmuls and convolutions, forward and backward, by
  ``torch.utils.flop_counter``'s formulas (``2·M·N·K``; ``2·out_elems·
  kernel elems per output feature``); elementwise ops one FLOP per output
  element (a fused op by the primitives it stands for, e.g. four for an
  inference batch norm); reductions one per input element.
- K1 (``ops/flash_attention.py``) is charged by its own work,
  ``k1_cost``: visible ``(q, k)`` pairs × 4D FLOPs, q/k/v/o (+ lse)
  bytes.  The reference recurses into ``pallas_call``'s kernel jaxpr
  without multiplying by the grid, so it prices a flash-attention call by
  ONE grid step; the port does not copy that.
- HBM bytes: the un-fused in + out bytes of every op — an upper bound
  good for ranking memory- against compute-bound — with views and
  factories excluded (they never move data after fusion, as the
  reference excludes its layout primitives).
- Collective bytes: the output bytes of the c10d collectives.
- h2d/d2h: the port's runners' accounting, exactly.  A serving unit is
  the decode runners' own device function (``functions/runner.py``:
  ``dense_prefill``, ``paged_prefill``, ``paged_decode``, or the model's
  padded ``decode_step``), priced with the runners' own H2D count
  (``prefill_h2d_bytes``, ``decode_h2d_bytes``) and ``[b]`` / ``[S]``
  next tokens fetched; a ``CompiledMethodRunner`` ships the padded batch
  at the schema's dtypes and fetches the method's outputs.

Everything is fail-soft: a unit whose walk raises becomes a note on its
:class:`OperatorCost`, never a failed plan.  Front doors:
``cost_table_for_env(env)`` (what ``execute_async`` calls when
``JobConfig.roofline`` names no table) and ``cost_table_for_ctx``.
"""

from __future__ import annotations

import dataclasses
import math
import typing
import weakref

if typing.TYPE_CHECKING:
    from flink_tensorflow_tpu_torch.analysis.rules import AnalysisContext

#: Elementwise ops priced at one FLOP per output element — a modest set
#: (matmuls and convolutions dominate every MFU figure this table feeds);
#: it keeps units of pure vector work non-zero.
ELEMENTWISE_OPS = frozenset({
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "clamp", "clamp_min",
    "clamp_max", "pow", "exp", "log", "tanh", "sigmoid", "erf", "rsqrt", "sqrt", "neg",
    "abs", "where", "relu", "masked_fill", "reciprocal", "square", "lerp", "addcmul",
    "addcdiv",
})

#: Fused ops priced as the primitives they stand for, FLOPs per output
#: element (a gelu's tanh form; an inference batch norm's subtract,
#: scale, multiply and add).
COMPOSITE_OPS = {
    "gelu": 8, "silu": 4, "softplus": 3, "log_softmax": 4, "_log_softmax": 4,
    "softmax": 4, "_softmax": 4, "native_batch_norm": 4,
    "_native_batch_norm_legit": 4, "_native_batch_norm_legit_no_training": 4,
    "_native_batch_norm_legit_functional": 4, "native_layer_norm": 6,
}

#: Reductions priced at one FLOP per INPUT element.
REDUCE_OPS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax", "argmin",
    "cumsum", "logsumexp", "var", "var_mean", "std", "any", "all", "norm",
    "linalg_vector_norm",
})

#: Ops that move no data after fusion (the reference's layout primitives:
#: fills, iotas, aliases): excluded from the HBM estimate, as views are.
#: Casts and materialized transposes (``_to_copy``, ``clone``) move data
#: and count, as the reference's ``convert_element_type`` and
#: ``transpose`` do.
LAYOUT_OPS = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "zeros", "zeros_like", "ones", "ones_like", "full", "full_like", "new_zeros",
    "new_ones", "new_full", "arange", "scalar_tensor", "lift_fresh", "lift_fresh_copy",
    "detach", "alias", "_unsafe_view",
})

#: The c10d collectives (the reference's ``COLLECTIVE_PRIMS``): their
#: output bytes are collective bytes.
COLLECTIVE_OPS = frozenset({
    "allreduce_", "allgather_", "_allgather_base_", "reduce_scatter_",
    "_reduce_scatter_base_", "broadcast_", "alltoall_", "alltoall_base_",
    "all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor", "all_to_all_single",
})

#: Signature-ladder cap: pricing every (admit x prompt) prefill bucket
#: runs the model per combination; past this many the largest are kept
#: and the truncation noted (an unpriced signature joins with no MFU,
#: never a wrong one).
MAX_SIGNATURE_TRACES = 32


# ---------------------------------------------------------------------------
# data model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CostEntry:
    """The static price of ONE call of one jit unit at one signature."""

    unit: str             # prefill | decode_step | <method name> | train_step
    signature: str        # the runtime compile-signature name this prices
    flops: int = 0
    hbm_bytes: int = 0    # un-fused per-eqn traffic upper bound
    collective_bytes: int = 0
    h2d_bytes: int = 0    # expected host->device per call
    d2h_bytes: int = 0    # expected device->host per call

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, doc: dict) -> "CostEntry":
        return cls(**{f.name: doc.get(f.name, 0 if f.name not in
                                      ("unit", "signature") else "")
                      for f in dataclasses.fields(cls)})


@dataclasses.dataclass
class OperatorCost:
    """Every priced jit unit of one operator, plus its predicted
    compile-signature ladder (the runtime compile-event diff target)."""

    node: str
    kind: str  # model | train | serving
    entries: typing.List[CostEntry] = dataclasses.field(default_factory=list)
    #: Every signature the plan can legally present — a runtime jit
    #: cache miss OUTSIDE this ladder is a `roofline-recompile` finding.
    predicted_signatures: typing.Tuple[str, ...] = ()
    notes: typing.List[str] = dataclasses.field(default_factory=list)

    def entry(self, unit: str,
              signature: typing.Optional[str] = None
              ) -> typing.Optional[CostEntry]:
        """Exact (unit, signature) match, else the unit's sole entry."""
        of_unit = [e for e in self.entries if e.unit == unit]
        if signature is not None:
            for e in of_unit:
                if e.signature == signature:
                    return e
        return of_unit[0] if len(of_unit) == 1 else None

    def to_json(self) -> dict:
        return {
            "node": self.node, "kind": self.kind,
            "predicted_signatures": list(self.predicted_signatures),
            "entries": [e.to_json() for e in self.entries],
            "notes": list(self.notes),
        }

    @classmethod
    def from_json(cls, doc: dict) -> "OperatorCost":
        return cls(
            node=doc["node"], kind=doc.get("kind", "?"),
            entries=[CostEntry.from_json(e) for e in doc.get("entries", ())],
            predicted_signatures=tuple(doc.get("predicted_signatures", ())),
            notes=list(doc.get("notes", ())),
        )


@dataclasses.dataclass
class CostTable:
    """The full static cost export for one captured plan."""

    ops: typing.List[OperatorCost] = dataclasses.field(default_factory=list)
    mesh_axes: typing.Optional[typing.Dict[str, int]] = None

    def op(self, node: str) -> typing.Optional[OperatorCost]:
        for oc in self.ops:
            if oc.node == node:
                return oc
        return None

    def to_json(self) -> dict:
        return {
            "kind": "flink-tpu-cost-table",
            "mesh_axes": self.mesh_axes,
            "operators": [oc.to_json() for oc in self.ops],
        }

    @classmethod
    def from_json(cls, doc: dict) -> "CostTable":
        if doc.get("kind") not in (None, "flink-tpu-cost-table"):
            raise ValueError(f"not a cost table: kind={doc.get('kind')!r}")
        return cls(
            ops=[OperatorCost.from_json(o) for o in doc.get("operators", ())],
            mesh_axes=doc.get("mesh_axes"),
        )


def serving_signature(kind: str, batch: int, length: int) -> str:
    """The runtime compile-signature name for one
    ``ServingConfig.compile_signatures()`` tuple — shared by the
    plan-time ladder and ``DecodeStepRunner``'s observe hooks so the
    compile-event diff joins on equal strings."""
    if kind == "decode":
        return f"decode:{batch}"
    return f"{kind}:{batch}x{length}"


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class UnitCost:
    """What one call of one unit costs, FLOPs broken down by kind."""

    matmul_flops: int = 0
    conv_flops: int = 0
    other_flops: int = 0   # elementwise and reductions
    k1_flops: int = 0
    hbm_bytes: int = 0
    collective_bytes: int = 0
    #: High-water mark of the bytes of live op outputs: every tensor an op
    #: allocates (neither a view nor an in-place or ``out=`` alias of an
    #: input) counts from that op until it is freed; the call's inputs
    #: and weights do not count (shardcheck's peak activation).
    peak_live_bytes: int = 0
    #: The port's collectives the call issued, by ``collectives.calls``
    #: kind (counted under ``collectives.census``: on meta tensors they
    #: move nothing).
    collectives: typing.Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def flops(self) -> int:
        return self.matmul_flops + self.conv_flops + self.other_flops + self.k1_flops


def _tensors(tree) -> typing.Iterator[typing.Any]:
    import torch

    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _walk_mode():
    """A ``TorchDispatchMode`` that prices every ATen op it sees into a
    :class:`UnitCost` (built here so importing this module needs no
    torch)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    conv_ops = {"convolution", "_convolution", "convolution_backward", "cudnn_convolution",
                "convolution_overrideable", "_slow_conv2d_forward"}

    class _Walk(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.cost = UnitCost()
            self.live_bytes = 0

        def _freed(self, nbytes: int) -> None:
            self.live_bytes -= nbytes

        def _track(self, func, out) -> None:
            if func.is_view:
                return
            returns = func._schema.returns
            values = (list(out) if len(returns) > 1 and isinstance(out, (tuple, list))
                      else [out])
            for ret, value in zip(returns, values):
                if ret.alias_info is not None:
                    continue
                for t in _tensors(value):
                    n = _nbytes(t)
                    self.live_bytes += n
                    weakref.finalize(t, self._freed, n)
            self.cost.peak_live_bytes = max(self.cost.peak_live_bytes, self.live_bytes)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            result = out = func(*args, **kwargs)
            packet = func.overloadpacket
            base = packet.__name__
            # An in-place op (``add_``) costs what its functional form does,
            # and a ``_foreach_<op>`` what <op> does over every tensor of
            # its list (its in-place form writes that list back).
            foreach = base.startswith("_foreach_")
            name = base[len("_foreach_"):] if foreach else base
            if name.endswith("_") and not name.startswith("_"):
                name = name[:-1]
            if foreach and out is None:
                out = args[0]
            cost = self.cost
            counter = flop_registry.get(packet)
            if counter is not None:
                flops = int(counter(*args, **kwargs, out_val=out))
                if name in conv_ops:
                    cost.conv_flops += flops
                else:
                    cost.matmul_flops += flops
            elif name in ELEMENTWISE_OPS:
                cost.other_flops += sum(t.numel() for t in _tensors(out))
            elif name in COMPOSITE_OPS:
                first = next(_tensors(out), None)
                cost.other_flops += COMPOSITE_OPS[name] * (first.numel() if first is not None
                                                           else 0)
            elif name in REDUCE_OPS:
                first = next(_tensors(args), None)
                cost.other_flops += first.numel() if first is not None else 0
            if base in COLLECTIVE_OPS:
                cost.collective_bytes += sum(_nbytes(t) for t in _tensors(out))
            if not func.is_view and base not in LAYOUT_OPS:
                cost.hbm_bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
                cost.hbm_bytes += sum(_nbytes(t) for t in _tensors(out))
            self._track(func, result)
            return result

    return _Walk()


def cost_of_call(fn: typing.Callable, *args, **kwargs) -> UnitCost:
    """Price one call ``fn(*args, **kwargs)`` over meta tensors: every ATen
    op it reaches, plus each K1 call at ``k1_cost``."""
    from flink_tensorflow_tpu_torch.ops import flash_attention as fa
    from flink_tensorflow_tpu_torch.parallel import collectives

    mode = _walk_mode()

    def charge(flops: int, nbytes: int) -> None:
        mode.cost.k1_flops += flops
        mode.cost.hbm_bytes += nbytes

    with fa.meta_calls(charge), collectives.census() as counts, mode:
        fn(*args, **kwargs)
    mode.cost.collectives = dict(counts)
    return mode.cost


def _entry_of(unit: str, signature: str, cost: UnitCost, *, h2d_bytes: int,
              d2h_bytes: int) -> CostEntry:
    return CostEntry(unit=unit, signature=signature, flops=cost.flops,
                     hbm_bytes=cost.hbm_bytes, collective_bytes=cost.collective_bytes,
                     h2d_bytes=h2d_bytes, d2h_bytes=d2h_bytes)


def _meta(shape, dtype):
    import torch

    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# per-operator pricing
# ---------------------------------------------------------------------------


def _cost_serving(t, op) -> OperatorCost:
    import torch

    from flink_tensorflow_tpu_torch.functions.runner import (
        decode_h2d_bytes,
        dense_prefill,
        paged_decode,
        paged_prefill,
        prefill_h2d_bytes,
    )
    from flink_tensorflow_tpu_torch.models.base import meta_module
    from flink_tensorflow_tpu_torch.ops.flash_attention import meta_calls
    from flink_tensorflow_tpu_torch.ops.paged_attention import pages_per_session

    cost = OperatorCost(node=t.name, kind="serving")
    cfg = op.serving_config
    sigs = cfg.compile_signatures()
    if sigs is None:
        cost.notes.append(
            "padding_buckets off — the signature set is unbounded; no "
            "predicted ladder, every runtime compile is unpredicted by "
            "construction")
        return cost
    cost.predicted_signatures = tuple(serving_signature(k, b, n) for (k, b, n) in sigs)
    try:
        prefill = op.model.method("prefill")
        decode = op.model.method("decode_step")
        module = meta_module(op.model.params)
        S, C = cfg.max_active_seqs, cfg.capacity
        i32 = torch.int32
        with torch.no_grad(), meta_calls():
            like = prefill.fn(module, {
                "tokens": _meta((cfg.bucket_admit(S), min(cfg.bucket_prompt_len(C), C)), i32),
                "lengths": _meta((cfg.bucket_admit(S),), i32)})
        k_like, v_like = like["k_cache"], like["v_cache"]
        layers = k_like.shape[1]
        parts = (tuple(k_like.shape[3:]), tuple(v_like.shape[3:]))  # [B, L, T, *part]
        pool_dtype = k_like.dtype
        esz = k_like.element_size()
        paged = bool(cfg.paged_kv)
        if paged:
            pt = cfg.page_tokens
            Pc = pages_per_session(C, pt)  # table width per session
            P = cfg.resolved_hbm_pages()
            lead = (P + 1, layers, pt)  # + the sentinel page
        else:
            Pc = None  # no block tables
            lead = (S, layers, C)
        k_shape, v_shape = (lead + part for part in parts)
        combos = sorted({(b, min(n, C)) for (kind, b, n) in sigs if kind == "prefill"})
        if len(combos) > MAX_SIGNATURE_TRACES:
            cost.notes.append(
                f"prefill ladder has {len(combos)} signatures — priced the largest "
                f"{MAX_SIGNATURE_TRACES} (unpriced signatures join with no MFU, "
                "never a wrong one)")
            combos = combos[-MAX_SIGNATURE_TRACES:]
        with torch.no_grad():
            for b, n in combos:
                tok, lens = _meta((b, n), i32), _meta((b,), i32)
                kc, vc = _meta(k_shape, pool_dtype), _meta(v_shape, pool_dtype)
                if paged:
                    unit = cost_of_call(paged_prefill, prefill, module, tok, lens,
                                        _meta((b, Pc), torch.long), kc, vc, C, pt)
                else:
                    rows = _meta((b,), torch.long)
                    unit = cost_of_call(dense_prefill, prefill, module, tok, lens, kc, vc,
                                        rows, rows)
                cost.entries.append(_entry_of(
                    "prefill", serving_signature("prefill", b, n), unit,
                    h2d_bytes=prefill_h2d_bytes(b, n, Pc), d2h_bytes=b * 4))
            kc, vc = _meta(k_shape, pool_dtype), _meta(v_shape, pool_dtype)
            tok, lens = _meta((S,), i32), _meta((S,), i32)
            if paged:
                unit = cost_of_call(paged_decode, decode, module, tok, lens,
                                    _meta((S, Pc), torch.long), kc, vc, pt)
            else:
                unit = cost_of_call(decode.fn, module, {
                    "token": tok, "lengths": lens, "k_cache": kc, "v_cache": vc,
                    "active": _meta((S,), torch.bool)})
        cost.entries.append(_entry_of(
            "decode_step", serving_signature("decode", S, 1), unit,
            h2d_bytes=decode_h2d_bytes(S, Pc), d2h_bytes=S * 4))
        # cache_move entries price the tier machinery's data motion
        # (park/extract/insert/spill revival).  Transfers are not launch
        # shapes, so they stay OUT of predicted_signatures.
        if paged:
            per_token = sum(math.prod(part) for part in parts)
            page_bytes = layers * pt * per_token * esz
            for n_pages in range(1, Pc + 1):
                cost.entries.append(CostEntry(
                    unit="cache_move", signature=f"cache:pages:{n_pages}",
                    h2d_bytes=n_pages * page_bytes, d2h_bytes=n_pages * page_bytes))
        else:
            block_bytes = layers * C * sum(math.prod(part) for part in parts) * esz
            cost.entries.append(CostEntry(
                unit="cache_move", signature="cache:block",
                h2d_bytes=block_bytes, d2h_bytes=block_bytes))
    except Exception as ex:  # noqa: BLE001 - fail-soft by contract
        cost.notes.append(f"abstract pricing failed: {ex!r}")
    return cost


def _cost_model_function(t, function, in_schema) -> OperatorCost:
    import torch

    from flink_tensorflow_tpu_torch.models.base import Model, meta_module

    cost = OperatorCost(node=t.name, kind="model")
    source = getattr(function, "_source", None)
    schema = function.plan_input_schema() or in_schema
    if not isinstance(source, Model) or schema is None:
        cost.notes.append("lazy model source or unknown schema — the runner unit is not "
                          "priceable at plan time")
        return cost
    try:
        method = source.method(function._method_name)
    except KeyError as ex:
        cost.notes.append(f"model method unresolvable: {ex}")
        return cost
    if method.needs_lengths:
        cost.notes.append("method takes per-record lengths — pricing skipped (no schema "
                          "slot to run it from)")
        return cost
    policy = function.plan_policy()
    sizes = tuple(getattr(policy.batch, "sizes", ()) or ())
    batches = (policy.fixed_batch,) if policy.fixed_batch else sizes or (1,)
    if len(batches) > 8:
        cost.notes.append(f"batch ladder has {len(batches)} sizes — priced the largest 8")
        batches = batches[-8:]
    # The runtime signature (CompiledMethodRunner joins on the padded
    # batch alone) folds length buckets together; pricing takes the
    # warmup length bucket, noted when lengths are dynamic.
    if not schema.is_static:
        cost.notes.append("dynamic-length fields priced at the warmup length bucket; "
                          "runtime signatures key on padded batch only")
    cost.predicted_signatures = tuple(f"b{b}" for b in batches)
    select = getattr(function, "_outputs", None)
    module = meta_module(source.params)
    for b in batches:
        try:
            struct = schema.batched_struct(b, length_bucket=function._warmup_length_bucket)
            outputs = {}

            def call(x, _out=outputs):
                _out.update(method.fn(module, x))

            with torch.no_grad():
                unit = cost_of_call(call, struct)
            h2d = sum(_nbytes(x) for x in struct.values())
            fetched = [outputs[k] for k in select] if select else list(outputs.values())
            d2h = sum(_nbytes(v) for v in fetched if isinstance(v, torch.Tensor))
            cost.entries.append(_entry_of(method.name, f"b{b}", unit, h2d_bytes=h2d,
                                          d2h_bytes=d2h))
        except Exception as ex:  # noqa: BLE001 - fail-soft by contract
            cost.notes.append(f"abstract pricing failed at b{b}: {ex!r}")
            break
    return cost


def _meta_train_state(model_def, optimizer):
    """A TrainState of meta tensors (``parallel.dp.init_train_state``'s
    shapes; nothing initialised, nothing allocated)."""
    import torch

    from flink_tensorflow_tpu_torch.parallel.dp import module_variables

    with torch.device("meta"):
        variables = module_variables(model_def.make_module())
        return {"variables": variables, "opt_state": optimizer.init(variables["params"]),
                "step": torch.zeros((), dtype=torch.int32), "rng": 0}


def _cost_train(t, function) -> OperatorCost:
    import torch

    cost = OperatorCost(node=t.name, kind="train")
    batch = (getattr(function, "global_batch", None)
             or getattr(function, "mini_batch", None) or 1)
    sig = f"train:b{batch}"
    cost.predicted_signatures = (sig,)
    try:
        from flink_tensorflow_tpu_torch.parallel.dp import make_train_step
        from flink_tensorflow_tpu_torch.parallel.optim import sgd

        schema = function.train_schema
        optimizer = function.optimizer or sgd(0.01)
        struct = schema.batched_struct(batch, length_bucket=getattr(
            function, "_warmup_length_bucket", 128))
        for name in schema.names:
            if not schema[name].is_static:
                struct[f"{name}_len"] = _meta((batch,), torch.int32)
        struct["valid"] = _meta((batch,), torch.float32)
        step = make_train_step(function.model_def, optimizer)
        unit = cost_of_call(step, _meta_train_state(function.model_def, optimizer), struct, 0)
        h2d = sum(_nbytes(x) for x in struct.values())
        cost.entries.append(_entry_of("train_step", sig, unit, h2d_bytes=h2d, d2h_bytes=0))
    except Exception as ex:  # noqa: BLE001 - fail-soft by contract
        cost.notes.append(f"abstract pricing failed: {ex!r}")
    return cost


# ---------------------------------------------------------------------------
# the plan walk + front doors
# ---------------------------------------------------------------------------


def cost_table_for_ctx(ctx: "AnalysisContext") -> CostTable:
    """Price every runner unit of one analysis context (cached per ctx)."""
    cached = ctx.__dict__.get("_costmodel_table")
    if cached is not None:
        return cached
    config = ctx.config
    mesh = getattr(config, "mesh", None) if config is not None else None
    table = CostTable(mesh_axes=dict(mesh.shape) if mesh is not None else None)
    for t in ctx.order:
        op = ctx.operators.get(t.id)
        if op is None:
            continue
        function = getattr(op, "function", None)
        if getattr(op, "is_continuous_batching", False):
            table.ops.append(_cost_serving(t, op))
        elif hasattr(function, "model_def") and hasattr(function, "train_schema"):
            table.ops.append(_cost_train(t, function))
        elif getattr(function, "is_jit_boundary", False) and hasattr(
                function, "plan_input_schema"):
            table.ops.append(_cost_model_function(t, function, ctx.input_schema(t)))
    ctx.__dict__["_costmodel_table"] = table
    return table


def context_for_env(env) -> "AnalysisContext":
    """The analysis context of one environment's plan (operators built,
    schemas propagated), as ``analyze`` builds it: what the pricer and the
    shardcheck and statecheck reports read."""
    from flink_tensorflow_tpu_torch.analysis.rules import AnalysisContext
    from flink_tensorflow_tpu_torch.analysis.schema_prop import propagate

    graph = env.graph
    order = graph.topological_order()
    operators = {}
    for t in graph.transformations:
        try:
            operators[t.id] = t.operator_factory()
        except Exception:  # noqa: BLE001 - factory-error is the analyzer's finding
            operators[t.id] = None
    flow = propagate(graph, order, operators)
    return AnalysisContext(graph=graph, order=order, operators=operators,
                           schemas=flow.out, schema_sets=flow.out_sets, config=env.config)


def cost_table_for_env(env) -> CostTable:
    """Price every runner unit of one environment's plan — what
    ``execute_async`` calls when ``JobConfig.roofline`` names no table."""
    return cost_table_for_ctx(context_for_env(env))
