"""Statecheck — the exact-resume, RNG-stream and rescale-safety analyzer.

Port of ``flink_tensorflow_tpu/analysis/statecheck.py``.  A barrier
snapshot is an exact resume only if it holds every piece of state the
job updates: params, optimizer moments, RNG streams and paged KV state
alike.  This module rejects, at plan time, a plan whose snapshot is
incomplete or whose rescale is unsafe.  Its verdict families, each a
lint rule with operator/edge provenance:

- ``statecheck-hidden-state`` (ERROR): state in user function closure
  cells, instance ``__dict__`` and referenced module globals, OUTSIDE
  declared operator state (``snapshot_state`` / keyed state).  In torch
  every tensor is mutable in place, so any ``torch.Tensor`` is state (the
  finding names its device); so are a ``torch.Generator``, a TrainState
  (a dict of ``params``/``variables`` and ``opt_state``), the port's
  optimizer state (``parallel/optim.py``'s ``mu``/``nu`` dicts) and the
  reference's mutable containers holding any of those.  Numpy constants
  and configs stay inert.
- ``statecheck-train-state``: ``parallel.dp.init_train_state``'s state,
  built on meta tensors: moments that do not shard WITH their params
  under the declared :class:`~flink_tensorflow_tpu_torch.analysis.
  shardcheck.SpecLayout` (ERROR), dtype drift between a param and its
  moment (``adam(mu_dtype=...)``, WARN), and a large TrainState a step
  does not update in place (``donates_train_state``, WARN).
- ``statecheck-rescale``: a subtask-scoped TrainState under a
  checkpointed (worse: autoscaled) plan, and a gang's ``global_batch``
  against the whole power-of-two reshard ladder.
- ``statecheck-rng-stream``: per-key randomness must derive from keyed
  state through ``parallel.dp.fold_in``, never from a constant seed on
  the record path (``torch.manual_seed``, ``<generator>.manual_seed(<a
  constant>)``) nor from a process-global stream: the sanitizer's
  ``unseeded-random`` chains (numpy, ``random``) or a torch sampler
  (``torch.rand``, ``randn``, ``randint``, ``randperm``, ``normal``,
  ``bernoulli``, ``multinomial`` and their ``_like`` forms) called with
  no ``generator=`` keyword, read off the call's keyword names in the
  bytecode.  The sanitizer's own classification stays the reference's.
- ``exactly-once-boundary``: a dataflow pass that classifies every
  source (replayable / WAL-fronted / non-replayable), propagates the
  delivery guarantee along every edge of a checkpointed plan and ERRORs
  with the full path where at-least-once provenance reaches a sink that
  declares ``idempotent = False``.
- ``statecheck-page-keygroup``: the paged KV pool must partition along
  key groups (``ServingConfig.page_partition``) so a rescale moves whole
  key-group page sets, not sessions.

Everything is fail-soft.  Front doors: ``analyze(graph)`` /
``env.validate_plan()`` (the rules register from the bottom of
``analysis/rules.py``), ``python -m
flink_tensorflow_tpu_torch.analysis.statecheck`` (the JSON report
``tracing/doctor.py --statecheck`` folds in; exit codes 0/1/2 as
shardcheck's) and :func:`audit_plan`.
"""

from __future__ import annotations

import dataclasses
import dis
import math
import types
import typing

from flink_tensorflow_tpu_torch.analysis.diagnostics import Severity
from flink_tensorflow_tpu_torch.analysis.sanitizer import (
    _classify_chain,
    _is_user_code,
    _iter_code_objects,
    _MISSING,
    _MUTABLE_TYPES,
    _resolve_chain,
    _unwrap,
    collect_user_functions,
)
from flink_tensorflow_tpu_torch.analysis.shardcheck import (
    DONATION_MIN_BYTES,
    Finding,
    SpecLayout,
    _layout_of,
    _leaf_shape_dtype,
    _param_paths,
    dtype_name,
)

if typing.TYPE_CHECKING:
    from flink_tensorflow_tpu_torch.analysis.rules import AnalysisContext

#: Operator attributes that may host user-authored callables.
_SCAN_ATTRS = ("function", "key_selector", "key_selector1", "key_selector2",
               "ts_fn", "source")

#: Methods that run OUTSIDE the record path: a constant seed there is the
#: sanctioned pattern (seed once, fold per key and step afterwards).
_LIFECYCLE = frozenset({"open", "close", "clone", "__init__",
                        "snapshot_state", "restore_state", "rescale_state"})

#: torch's samplers on the process-global generator unless given one.
_TORCH_SAMPLERS = frozenset({
    "rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
    "randperm", "normal", "bernoulli", "multinomial",
})

_CALLS = frozenset({"CALL", "CALL_KW", "CALL_FUNCTION_EX"})


# ---------------------------------------------------------------------------
# audit data model
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OpStateAudit:
    """Everything statecheck derived about one operator."""

    node: str
    kind: str  # source | train | serving | operator
    #: sources only: replayable | wal-fronted | non-replayable.
    source_class: typing.Optional[str] = None
    #: delivery guarantee arriving at / leaving this node.
    guarantee: typing.Optional[str] = None
    #: hidden-state symbol descriptions (ERROR provenance).
    hidden_state: typing.List[str] = dataclasses.field(default_factory=list)
    #: the TrainState's bytes, params and moments (train ops only).
    train_state_bytes: typing.Optional[int] = None
    #: why parts of the audit were skipped (fail-soft provenance).
    notes: typing.List[str] = dataclasses.field(default_factory=list)

    def to_json(self) -> dict:
        return {
            "node": self.node, "kind": self.kind,
            "source_class": self.source_class,
            "guarantee": self.guarantee,
            "hidden_state": list(self.hidden_state),
            "train_state_bytes": self.train_state_bytes,
            "notes": list(self.notes),
        }


@dataclasses.dataclass
class PlanStateAudit:
    """The full statecheck result for one captured plan."""

    findings: typing.List[Finding]
    ops: typing.List[OpStateAudit]

    def op(self, node: str) -> typing.Optional[OpStateAudit]:
        for a in self.ops:
            if a.node == node:
                return a
        return None

    def to_json(self) -> dict:
        return {
            "operators": [a.to_json() for a in self.ops],
            "findings": [f.to_json() for f in self.findings],
        }


# ---------------------------------------------------------------------------
# hidden-state classification
# ---------------------------------------------------------------------------


def _classify_state(value: typing.Any, _depth: int = 0) -> typing.Optional[str]:
    """A description when ``value`` is checkpoint-relevant state (see the
    module docstring), else None: the audit stays quiet about everything
    a snapshot does not need."""
    import torch

    if isinstance(value, torch.Tensor):
        return (f"a tensor {dtype_name(value.dtype)}{list(value.shape)} "
                f"on {value.device}")
    if isinstance(value, torch.Generator):
        return f"a torch.Generator on {value.device}"
    if isinstance(value, dict):
        keys = set(value.keys())
        if {"variables", "opt_state"} <= keys or {"params", "opt_state"} <= keys:
            return "a TrainState pytree (params + optimizer moments)"
        if {"mu", "nu"} <= keys and _depth < 4:
            for item in (value["mu"], value["nu"]):
                inner = _classify_state(item, _depth + 1)
                if inner:
                    return f"optimizer state adam (holding {inner})"
    if isinstance(value, _MUTABLE_TYPES) and _depth < 4:
        items = value.values() if isinstance(value, dict) else value
        for i, item in enumerate(items):
            if i >= 64:
                break
            inner = _classify_state(item, _depth + 1)
            if inner:
                return f"a {type(value).__name__} holding {inner}"
    return None


def _referenced_global_names(code: types.CodeType) -> typing.Set[str]:
    names: typing.Set[str] = set()
    for co in _iter_code_objects(code):
        for instr in dis.get_instructions(co):
            if instr.opname in ("LOAD_GLOBAL", "LOAD_NAME"):
                names.add(instr.argval)
    return names


def _snapshot_covered_attrs(obj: typing.Any) -> typing.Optional[typing.Set[str]]:
    """Attribute names the object's USER-authored snapshot/restore methods
    touch, or None when it declares no user snapshot protocol at all
    (every stateful attribute is then hidden by definition)."""
    covered: typing.Optional[typing.Set[str]] = None
    for mname in ("snapshot_state", "restore_state"):
        fn = _unwrap(getattr(type(obj), mname, None))
        if fn is None or not _is_user_code(fn.__code__):
            continue
        if covered is None:
            covered = set()
        for co in _iter_code_objects(fn.__code__):
            for instr in dis.get_instructions(co):
                if instr.opname in ("LOAD_ATTR", "LOAD_METHOD", "STORE_ATTR"):
                    covered.add(instr.argval)
    return covered


_HIDDEN_TAIL = (
    "outside declared operator state — checkpoint barriers never see it, "
    "so a restored job resumes with stale (or doubly-applied) state: the "
    "reference's state-outside-snapshots failure; move it into "
    "snapshot_state()/keyed state"
)


def _hidden_state_findings(
    t, op, findings: typing.List[Finding], audit_syms: typing.List[str],
) -> None:
    seen: typing.Set[typing.Tuple[str, str]] = set()

    def hit(where: str, symbol: str, desc: str, how: str) -> None:
        if (where, symbol) in seen:
            return
        seen.add((where, symbol))
        audit_syms.append(f"{where}: {symbol}")
        findings.append(Finding(
            rule="statecheck-hidden-state", severity=Severity.ERROR,
            message=f"{where} {how} {symbol!r} — {desc} {_HIDDEN_TAIL}",
            node=t.name))

    for attr in _SCAN_ATTRS:
        target = getattr(op, attr, None)
        if target is None:
            continue
        for name, fn in collect_user_functions(target):
            for var, cell in zip(fn.__code__.co_freevars, fn.__closure__ or ()):
                try:
                    captured = cell.cell_contents
                except ValueError:  # pragma: no cover - empty cell
                    continue
                desc = _classify_state(captured)
                if desc:
                    hit(name, var, desc, "captures by closure")
            for gname in sorted(_referenced_global_names(fn.__code__)):
                val = fn.__globals__.get(gname, _MISSING)
                if val is _MISSING or isinstance(
                        val, (types.ModuleType, types.FunctionType, type)):
                    continue
                desc = _classify_state(val)
                if desc:
                    hit(name, gname, desc, "references module global")
        _instance_state_findings(target, hit)


def _instance_state_findings(obj: typing.Any, hit) -> None:
    """Stateful attributes in a USER class instance's ``__dict__`` that its
    snapshot protocol never touches.  Framework functions keep their
    state by construction (their snapshot methods are the contract) and
    are skipped wholesale."""
    if _unwrap(obj) is not None or not hasattr(obj, "__dict__"):
        return
    cls = type(obj)
    if cls.__module__.startswith("flink_tensorflow_tpu_torch.") or cls.__module__ in (
            "builtins", "functools"):
        return
    covered = _snapshot_covered_attrs(obj)
    for aname, val in vars(obj).items():
        desc = _classify_state(val)
        if desc is None:
            continue
        if covered is not None and aname in covered:
            continue
        hit(f"{cls.__qualname__}", f"self.{aname}", desc,
            "keeps instance attribute" if covered is None else
            "keeps snapshot-omitted instance attribute")


# ---------------------------------------------------------------------------
# RNG-stream discipline
# ---------------------------------------------------------------------------


def _is_fold(resolved) -> bool:
    from flink_tensorflow_tpu_torch.parallel.dp import fold_in

    return resolved is fold_in


def _classify_rng_chain(
    chain: typing.Sequence[str], globals_ns: typing.Optional[dict],
) -> typing.Optional[typing.Tuple[str, str]]:
    """('seed' | 'fold' | 'global-draw' | 'sampler', symbol) for an
    RNG-relevant attribute chain; None otherwise.  A 'sampler' is a
    global draw unless its call passes ``generator=``."""
    import torch

    symbol = ".".join(chain)
    resolved = _resolve_chain(chain, globals_ns)
    if resolved is not _MISSING:
        if resolved is torch.manual_seed:
            return "seed", symbol
        if _is_fold(resolved):
            return "fold", symbol
        if any(resolved is getattr(torch, n, None) for n in _TORCH_SAMPLERS):
            return "sampler", symbol
    elif chain[-1] == "fold_in" and len(chain) >= 2 and chain[-2] == "dp":
        return "fold", symbol
    elif chain[0] == "torch" and len(chain) == 2:
        if chain[1] == "manual_seed":
            return "seed", symbol
        if chain[1] in _TORCH_SAMPLERS:
            return "sampler", symbol
    # Process-global numpy.random / random draws: the purity scanner's
    # classification, re-judged here under the fold_in discipline.
    purity = _classify_chain(chain, globals_ns)
    if purity is not None and purity[0] == "unseeded-random":
        return "global-draw", symbol
    return None


def _call_of(instrs: typing.Sequence[dis.Instruction], start: int) -> typing.Optional[int]:
    """Index of the call that consumes the callable loaded by
    ``instrs[start:i]`` (the chain beginning at ``start``): the first call
    after which the stack is back to one value above where the chain
    began.  None when it cannot be told (a jump in between)."""
    depth = 0
    for i in range(start, len(instrs)):
        ins = instrs[i]
        if ins.opcode in dis.hasjrel or ins.opcode in dis.hasjabs:
            return None
        depth += dis.stack_effect(ins.opcode, ins.arg if ins.opcode >= dis.HAVE_ARGUMENT
                                  else None, jump=False)
        if ins.opname in _CALLS and depth <= 1:
            return i
    return None


def _keyword_names(instrs: typing.Sequence[dis.Instruction], call: int) -> typing.Tuple[str, ...]:
    """The keyword names of the call at ``instrs[call]``: a ``KW_NAMES``
    just before a ``CALL`` (3.12), or the constant tuple a ``CALL_KW``
    takes (3.13)."""
    ins = instrs[call]
    prev = instrs[call - 1] if call else None
    if ins.opname == "CALL" and prev is not None and prev.opname == "KW_NAMES":
        return tuple(prev.argval)
    if ins.opname == "CALL_KW" and prev is not None and prev.opname == "LOAD_CONST":
        return tuple(prev.argval)
    return ()


def _rng_uses(
    code: types.CodeType, globals_ns: typing.Optional[dict],
) -> typing.List[typing.Tuple[str, str, typing.Optional[int]]]:
    uses: typing.List[typing.Tuple[str, str, typing.Optional[int]]] = []
    for co in _iter_code_objects(code):
        instrs = [i for i in dis.get_instructions(co) if i.opname != "CACHE"]
        chain: typing.List[str] = []
        chain_at = 0
        chain_line: typing.Optional[int] = None
        called: typing.List[str] = []  # the chain the last call consumed
        line: typing.Optional[int] = None

        def flush() -> None:
            if not chain:
                return
            hitc = _classify_rng_chain(chain, globals_ns)
            if hitc is None:
                return
            cat, symbol = hitc
            if cat == "sampler":
                call = _call_of(instrs, chain_at)
                if call is None or instrs[call].opname == "CALL_FUNCTION_EX" or (
                        "generator" in _keyword_names(instrs, call)):
                    return
                cat = "global-draw"
            uses.append((cat, symbol, chain_line))

        for i, instr in enumerate(instrs):
            if instr.starts_line is not None:
                line = instr.starts_line
            if instr.opname in ("LOAD_GLOBAL", "LOAD_NAME"):
                flush()
                chain, chain_at, chain_line = [instr.argval], i, line
            elif instr.opname in ("LOAD_ATTR", "LOAD_METHOD") and chain:
                chain.append(instr.argval)
            elif instr.opname in ("LOAD_ATTR", "LOAD_METHOD") and instr.argval == "manual_seed":
                # <generator>.manual_seed(<a constant>): a re-seed on the
                # record path.
                nxt = instrs[i + 1:i + 3]
                if (len(nxt) == 2 and nxt[0].opname == "LOAD_CONST"
                        and nxt[1].opname == "CALL"):
                    owner = f"{'.'.join(called)}(...)" if called else "<generator>"
                    uses.append(("seed", f"{owner}.manual_seed", line))
            else:
                called = list(chain) if instr.opname in _CALLS else []
                flush()
                chain = []
        flush()
    return uses


def _rng_stream_findings(
    t, op, keyed: bool, findings: typing.List[Finding],
) -> None:
    severity = Severity.ERROR if keyed else Severity.WARN
    target = getattr(op, "function", None)
    if target is None:
        return
    for name, fn in collect_user_functions(target):
        if set(name.replace(" -> ", ".").split(".")) & _LIFECYCLE:
            continue  # seed-in-open is the sanctioned pattern
        uses = _rng_uses(fn.__code__, fn.__globals__)
        has_fold = any(cat == "fold" for cat, _, _ in uses)
        for cat, symbol, line in uses:
            loc = f"{name}" + (f":{line}" if line else "")
            if cat == "seed" and not has_fold:
                findings.append(Finding(
                    rule="statecheck-rng-stream", severity=severity,
                    message=(
                        f"{symbol} in {loc} re-seeds from a constant in the "
                        "record path with no parallel.dp.fold_in in sight — "
                        "every record (and every restored replica) draws "
                        "the SAME stream instead of a per-session one; "
                        "seed once in open() and derive per-key/per-step "
                        "seeds via fold_in from keyed state so a restored "
                        "session re-samples the identical continuation"),
                    node=t.name))
            elif cat == "global-draw":
                findings.append(Finding(
                    rule="statecheck-rng-stream", severity=severity,
                    message=(
                        f"{symbol} in {loc} draws from a process-global RNG "
                        "stream — after a restore the replayed records "
                        "re-sample a DIFFERENT continuation, so keyed state "
                        "rebuilt by replay diverges byte-for-byte from the "
                        "original run; derive per-key randomness via "
                        "fold_in from keyed state (a torch.Generator seeded "
                        "with it) instead"),
                    node=t.name))


# ---------------------------------------------------------------------------
# train-state audit
# ---------------------------------------------------------------------------


def _flat_leaves(tree) -> typing.List[typing.Tuple[str, tuple, typing.Any]]:
    out = []
    for path, leaf in _param_paths(tree):
        shape, dtype = _leaf_shape_dtype(leaf)
        out.append((path, shape, dtype))
    return out


def _match_param(
    params: typing.List[typing.Tuple[str, tuple, typing.Any]],
    mpath: str, mshape: tuple,
) -> typing.Optional[typing.Tuple[str, tuple, typing.Any]]:
    """The param leaf an optimizer-moment leaf mirrors: a path-suffix
    match wins, a same-leaf-name shape match next, a UNIQUE shape match
    last (the renamed-slot case the placement check exists for)."""
    same_shape = [p for p in params if p[1] == mshape]
    if not same_shape:
        return None
    for p in same_shape:
        if mpath == p[0] or mpath.endswith("/" + p[0]):
            return p
    mleaf = mpath.rsplit("/", 1)[-1]
    named = [p for p in same_shape if p[0].rsplit("/", 1)[-1] == mleaf]
    if named:
        def suffix_len(p):  # the longest shared path suffix wins
            msegs, psegs = mpath.split("/")[::-1], p[0].split("/")[::-1]
            return sum(1 for a, b in zip(msegs, psegs) if a == b)
        return max(named, key=suffix_len)
    if len(same_shape) == 1:
        return same_shape[0]
    return None


def _train_state_findings(
    t, function, layout: SpecLayout,
    mesh_axes: typing.Optional[typing.Dict[str, int]],
    findings: typing.List[Finding], audit: OpStateAudit,
) -> None:
    try:
        from flink_tensorflow_tpu_torch.analysis.costmodel import _meta_train_state
        from flink_tensorflow_tpu_torch.parallel.optim import sgd

        state = _meta_train_state(function.model_def, function.optimizer or sgd(0.01))
    except Exception as ex:  # noqa: BLE001 - fail-soft by contract
        audit.notes.append(f"meta train-state build failed: {ex!r}")
        return
    params = _flat_leaves(state["variables"])
    moments = _flat_leaves(state["opt_state"])
    total = 0
    for _, shape, dtype in params + moments:
        total += int(math.prod(shape)) * dtype.itemsize if shape else dtype.itemsize
    audit.train_state_bytes = total
    sharded_layout = mesh_axes is not None and (layout.fsdp_axis or layout.tp_axis)
    for mpath, mshape, mdtype in moments:
        match = _match_param(params, mpath, mshape)
        if match is None:
            continue  # counts, steps, factored slots: no mirrored param
        ppath, pshape, pdtype = match
        if mdtype != pdtype:
            findings.append(Finding(
                rule="statecheck-train-state", severity=Severity.WARN,
                message=(
                    f"optimizer moment {mpath!r} is {dtype_name(mdtype)} but its "
                    f"param {ppath!r} is {dtype_name(pdtype)} — dtype drift "
                    "between params and moments: the snapshot round-trips the "
                    "moment at a different precision than the param it "
                    "updates, so resumed training follows a different "
                    "trajectory than uninterrupted training; align mu_dtype "
                    "with the param dtype (or declare the drift deliberately)"),
                node=t.name))
        if sharded_layout:
            pspec = layout.param_spec(ppath, pshape)
            mspec = layout.param_spec(mpath, mshape)
            if pspec != mspec:
                findings.append(Finding(
                    rule="statecheck-train-state", severity=Severity.ERROR,
                    message=(
                        f"optimizer moment {mpath!r} would place as "
                        f"{mspec} but its param {ppath!r} places as "
                        f"{pspec} under the declared SpecLayout — the "
                        "moment does not shard WITH its param, so every "
                        "update step pays a reshard (and a rescale-restore "
                        "redistributes the two differently); keep the "
                        "param tree's leaf names inside the optimizer "
                        "state or adjust the SpecLayout hints"),
                    node=t.name))
    donates = getattr(function, "donates_train_state", None)
    if donates is False and total >= DONATION_MIN_BYTES:
        findings.append(Finding(
            rule="statecheck-train-state", severity=Severity.WARN,
            message=(
                f"TrainState ({total / 2**20:.1f} MiB params+moments) is "
                "not donated through the step — the step returns a new "
                "state while the previous one stays live (2x device memory "
                "for the whole TrainState); use the gang DP path "
                "(make_dp_train_step updates the state in place) or keep "
                "the model small enough that double-buffering is acceptable"),
            node=t.name))


# ---------------------------------------------------------------------------
# rescale safety (the p -> p' ladder)
# ---------------------------------------------------------------------------


def _rescale_findings(
    t, function, cfg, findings: typing.List[Finding],
) -> None:
    checkpoint = getattr(cfg, "checkpoint", None) if cfg is not None else None
    checkpointed = checkpoint is not None and getattr(checkpoint, "dir", None)
    health = getattr(cfg, "health", None) if cfg is not None else None
    autoscaled = health is not None and getattr(health, "autoscale", None)
    max_p = getattr(cfg, "max_parallelism", 128) if cfg is not None else 128
    scope = getattr(function, "scope", None)
    if scope == "subtask" and checkpointed:
        findings.append(Finding(
            rule="statecheck-rescale",
            severity=Severity.ERROR if autoscaled else Severity.WARN,
            message=(
                f"{type(function).__name__}(scope='subtask') keeps one "
                "independent model replica per subtask: a p→p′ "
                "rescale-restore raises StateNotRescalable at the restore "
                "nobody tests"
                + (" — and health.autoscale WILL rescale this plan on a "
                   "sustained breach, so the actuator's restore kills the "
                   "job; use scope='key' (state redistributes by key "
                   "group) or remove the train operator from the "
                   "autoscaled plan" if autoscaled else
                   "; pin the operator's parallelism across restores or "
                   "use scope='key' so state redistributes by key group")),
            node=t.name))
    elif scope == "key" and checkpointed:
        findings.append(Finding(
            rule="statecheck-rescale", severity=Severity.INFO,
            message=(
                "per-key TrainState redistributes by key group on rescale "
                f"(max_parallelism={max_p} key groups) — exact-resume "
                "holds for any p′ <= max_parallelism"),
            node=t.name))
    if getattr(function, "is_gang", False):
        batch = getattr(function, "global_batch", None)
        if not batch:
            return
        ladder: typing.List[int] = []
        p = 1
        while p <= min(max_p, batch):
            ladder.append(p)
            p *= 2
        bad = [p for p in ladder if batch % p]
        if bad:
            findings.append(Finding(
                rule="statecheck-rescale", severity=Severity.WARN,
                message=(
                    f"global_batch {batch} does not divide the "
                    f"data-parallel reshard ladder at p′={bad[0]} "
                    f"(powers of two up to max_parallelism={max_p}): a "
                    f"p→p′ rescale to {bad[0]} processes leaves ragged "
                    "per-process shards and the gang's open() rejects the "
                    "batch after the restore already happened; pick a "
                    "global_batch divisible through the ladder"),
                node=t.name))
        else:
            findings.append(Finding(
                rule="statecheck-rescale", severity=Severity.INFO,
                message=(
                    f"data-parallel reshard ladder divides cleanly: "
                    f"global_batch {batch} across p′ ∈ {{1..{ladder[-1]}}} "
                    f"(powers of two, max_parallelism={max_p})"),
                node=t.name))


# ---------------------------------------------------------------------------
# exactly-once dataflow pass
# ---------------------------------------------------------------------------


def _source_feed(op) -> typing.Optional[typing.Any]:
    for attr in ("function", "source"):
        feed = getattr(op, attr, None)
        if feed is not None:
            return feed
    return None


def _classify_source(feed) -> str:
    if getattr(feed, "replayable", True) is False:
        return "non-replayable"
    if getattr(feed, "wal_fronted", False):
        return "wal-fronted"
    return "replayable"


def _sink_idempotent(op) -> typing.Optional[bool]:
    for holder in (getattr(op, "function", None), op):
        val = getattr(holder, "idempotent", None)
        if val is not None:
            return bool(val)
    return None


def _exactly_once_findings(
    ctx: "AnalysisContext", findings: typing.List[Finding],
    ops: typing.List[OpStateAudit],
) -> None:
    cfg = ctx.config
    if cfg is None:
        return  # a bare graph claims no checkpoint/restart story
    checkpoint = getattr(cfg, "checkpoint", None)
    if checkpoint is None or getattr(checkpoint, "dir", None) is None:
        return
    children: typing.Dict[int, list] = {}
    for t in ctx.order:
        for e in t.inputs:
            children.setdefault(e.upstream.id, []).append(t)
    for t in ctx.order:
        if not t.is_source:
            continue
        op = ctx.operators.get(t.id)
        feed = _source_feed(op) if op is not None else None
        if feed is None:
            continue
        source_class = _classify_source(feed)
        ops.append(OpStateAudit(
            node=t.name, kind="source", source_class=source_class,
            guarantee=("at-least-once" if source_class == "non-replayable"
                       else "exactly-once")))
        if source_class != "non-replayable":
            continue
        findings.append(Finding(
            rule="exactly-once-boundary", severity=Severity.WARN,
            message=(
                f"source {t.name!r} ({type(feed).__name__}) is not "
                "replayable: after a restart-from-checkpoint its "
                "stream cannot be rewound, so delivery through this "
                "job is at-least-once (or lossy for in-flight "
                "records) regardless of sink transactionality — "
                "front it with a durable FileSplitSource-backed "
                "write-ahead log for end-to-end exactly-once"),
            node=t.name))
        # Propagate the degraded guarantee along every edge; judge it
        # where it terminates.
        parent: typing.Dict[int, typing.Optional[typing.Any]] = {t.id: None}
        frontier = [t]
        terminals = []
        while frontier:
            cur = frontier.pop()
            downs = children.get(cur.id, [])
            if not downs:
                terminals.append(cur)
            for child in downs:
                if child.id not in parent:
                    parent[child.id] = cur
                    frontier.append(child)
        for term in terminals:
            hops = []
            walk: typing.Optional[typing.Any] = term
            while walk is not None:
                hops.append(walk.name)
                walk = parent.get(walk.id)
            path = " -> ".join(reversed(hops))
            idem = _sink_idempotent(ctx.operators.get(term.id))
            if idem is False:
                findings.append(Finding(
                    rule="exactly-once-boundary", severity=Severity.ERROR,
                    message=(
                        "at-least-once provenance reaches a non-idempotent "
                        f"sink: the delivery guarantee degrades along "
                        f"{path} (source {t.name!r} is non-replayable) and "
                        f"sink {term.name!r} declares idempotent=False — "
                        "replayed records after a restore DUPLICATE its "
                        "side effect while in-flight records are lost "
                        "outright; front the source with a durable "
                        "FileSplitSource write-ahead log or make the sink "
                        "transactional (ExactlyOnceRecordFileSink)"),
                    node=term.name))
            elif idem is True:
                findings.append(Finding(
                    rule="exactly-once-boundary", severity=Severity.INFO,
                    message=(
                        f"at-least-once provenance along {path} is "
                        f"absorbed: sink {term.name!r} declares itself "
                        "idempotent/transactional, so replay duplicates "
                        "collapse (records lost in flight at the source "
                        "remain lost)"),
                    node=term.name))


# ---------------------------------------------------------------------------
# paged-KV key-group partition
# ---------------------------------------------------------------------------


def _page_keygroup_findings(
    t, op, cfg, findings: typing.List[Finding],
) -> None:
    scfg = getattr(op, "serving_config", None)
    if scfg is None or not getattr(scfg, "paged_kv", False):
        return
    key_groups = getattr(cfg, "max_parallelism", 128) if cfg is not None else 128
    per_group, rem = scfg.page_partition(key_groups)
    pages = scfg.resolved_hbm_pages()
    if rem:
        findings.append(Finding(
            rule="statecheck-page-keygroup", severity=Severity.WARN,
            message=(
                f"PagedKVPool ({pages} pages x page_tokens="
                f"{scfg.page_tokens}) does not partition along the "
                f"{key_groups} key groups ({rem} pages left over): a "
                "p→p′ rescale must then move SESSIONS (drop their pages "
                "and re-prefill on the new owner) instead of handing "
                "whole key-group page sets over — size hbm_pages to a "
                "multiple of max_parallelism so pages migrate with their "
                "key groups"),
            node=t.name))
    else:
        findings.append(Finding(
            rule="statecheck-page-keygroup", severity=Severity.INFO,
            message=(
                f"paged KV pool partitions along key groups: {per_group} "
                f"pages per key group x {key_groups} key groups "
                f"(page_tokens={scfg.page_tokens}) — a rescale moves "
                "pages, not sessions"),
            node=t.name))


# ---------------------------------------------------------------------------
# the plan walk
# ---------------------------------------------------------------------------


def audit_plan(ctx: "AnalysisContext") -> PlanStateAudit:
    """Run the full statecheck pass over an analysis context."""
    cfg = ctx.config
    mesh = getattr(cfg, "mesh", None) if cfg is not None else None
    mesh_axes = dict(mesh.shape) if mesh is not None else None
    findings: typing.List[Finding] = []
    ops: typing.List[OpStateAudit] = []
    for t in ctx.order:
        op = ctx.operators.get(t.id)
        if op is None:
            continue
        function = getattr(op, "function", None)
        hidden: typing.List[str] = []
        _hidden_state_findings(t, op, findings, hidden)
        _rng_stream_findings(t, op, ctx.is_keyed(t), findings)
        if hasattr(function, "model_def") and hasattr(function, "train_schema"):
            audit = OpStateAudit(node=t.name, kind="train", hidden_state=hidden)
            _train_state_findings(t, function, _layout_of(op, function),
                                  mesh_axes, findings, audit)
            _rescale_findings(t, function, cfg, findings)
            ops.append(audit)
        elif getattr(op, "is_continuous_batching", False):
            ops.append(OpStateAudit(node=t.name, kind="serving", hidden_state=hidden))
            _page_keygroup_findings(t, op, cfg, findings)
        elif hidden:
            ops.append(OpStateAudit(node=t.name, kind="operator", hidden_state=hidden))
    _exactly_once_findings(ctx, findings, ops)
    return PlanStateAudit(findings=findings, ops=ops)


def audit_of(ctx: "AnalysisContext") -> PlanStateAudit:
    """The audit of ``ctx``, computed once: the rules (and the report)
    share one pass."""
    cached = ctx.__dict__.get("_statecheck_audit")
    if cached is None:
        cached = audit_plan(ctx)
        ctx.__dict__["_statecheck_audit"] = cached
    return cached


# ---------------------------------------------------------------------------
# lint registry wiring (from the bottom of analysis/rules.py)
# ---------------------------------------------------------------------------


def _emit_family(ctx, emit, rule_id: str) -> None:
    for f in audit_of(ctx).findings:
        if f.rule == rule_id:
            emit(f.message, node=f.node, edge=f.edge, severity=f.severity)


def _register_rules() -> None:
    from flink_tensorflow_tpu_torch.analysis.rules import rule

    @rule("statecheck-hidden-state", Severity.ERROR)
    def _statecheck_hidden_state(ctx, emit) -> None:
        """Hidden-state audit: tensors (any device), generators,
        TrainState/optimizer state, or mutable containers holding them,
        in closure cells, instance attributes or module globals OUTSIDE
        declared operator state — the snapshot is incomplete and resume
        is not exact (caught before first run)."""
        _emit_family(ctx, emit, "statecheck-hidden-state")

    @rule("statecheck-train-state", Severity.WARN)
    def _statecheck_train_state(ctx, emit) -> None:
        """Train-state audit over the meta TrainState: optimizer moments
        must shard WITH their params under the declared SpecLayout
        (ERROR on a placement mismatch), param/moment dtype drift, and a
        large TrainState not updated in place by its step (2x memory)."""
        _emit_family(ctx, emit, "statecheck-train-state")

    @rule("statecheck-rescale", Severity.WARN)
    def _statecheck_rescale(ctx, emit) -> None:
        """Rescale safety: subtask-scoped TrainState under a checkpointed
        plan dies at a p→p′ rescale-restore (StateNotRescalable; ERROR
        when health.autoscale will drive that rescale), and a gang's
        global_batch must divide the whole power-of-two reshard ladder
        up to max_parallelism."""
        _emit_family(ctx, emit, "statecheck-rescale")

    @rule("statecheck-rng-stream", Severity.WARN)
    def _statecheck_rng_stream(ctx, emit) -> None:
        """RNG-stream discipline: per-session/per-key randomness must
        derive via parallel.dp.fold_in from keyed state — not constant
        seeds in the record path, not a process-global stream (numpy,
        random, or a torch sampler without generator=) — so a restored
        session re-samples the identical continuation (ERROR on
        keyed-state paths)."""
        _emit_family(ctx, emit, "statecheck-rng-stream")

    @rule("statecheck-page-keygroup", Severity.WARN)
    def _statecheck_page_keygroup(ctx, emit) -> None:
        """Paged-KV rescale economics: the device page pool must
        partition along key groups (hbm_pages % max_parallelism == 0) so
        a p→p′ rescale hands whole key-group page sets over instead of
        dropping sessions for re-prefill."""
        _emit_family(ctx, emit, "statecheck-page-keygroup")

    @rule("exactly-once-boundary", Severity.WARN)
    def _exactly_once_boundary(ctx, emit) -> None:
        """Exactly-once dataflow pass: classify every source (replayable
        / WAL-fronted / non-replayable), propagate the delivery guarantee
        along every edge of a checkpointed plan, WARN at the
        non-replayable boundary, and ERROR with the full offending path
        when at-least-once provenance reaches a sink declaring
        ``idempotent = False``."""
        _emit_family(ctx, emit, "exactly-once-boundary")


# ---------------------------------------------------------------------------
# report + CLI
# ---------------------------------------------------------------------------


def report_for_env(env, pipeline: typing.Optional[str] = None) -> dict:
    """The JSON statecheck report for one captured plan — the reference's
    keys, which ``tracing/doctor.py --statecheck`` folds in."""
    from flink_tensorflow_tpu_torch.analysis.costmodel import context_for_env

    audit = audit_of(context_for_env(env))
    report = audit.to_json()
    report["pipeline"] = pipeline
    report["errors"] = sum(1 for f in audit.findings if f.severity == Severity.ERROR)
    return report


def main(argv=None) -> int:
    """``python -m flink_tensorflow_tpu_torch.analysis.statecheck``: exit
    0 with no ERROR, 1 with one, 2 when a script could not be captured."""
    import argparse
    import dataclasses as dc
    import json
    import sys

    parser = argparse.ArgumentParser(
        prog="python -m flink_tensorflow_tpu_torch.analysis.statecheck",
        description="Exact-resume, RNG-stream and rescale-safety static "
                    "analyzer: audits a captured plan's snapshot "
                    "completeness, train-state placement, RNG discipline "
                    "and delivery guarantees — no devices, no execution.",
    )
    parser.add_argument("pipelines", nargs="+", metavar="pipeline.py",
                        help="pipeline script(s) defining main(argv)")
    parser.add_argument("--job-args", default="--smoke --cpu",
                        help="argv passed to each pipeline's main() while "
                             "building its graph (default: '--smoke --cpu')")
    parser.add_argument("--mesh", metavar="data=4,fsdp=2",
                        help="override the job's mesh with a shape-only mesh "
                             "of these axes (enables the optimizer-state "
                             "placement audit without devices)")
    parser.add_argument("--json", action="store_true",
                        help="emit one JSON report per pipeline")
    parser.add_argument("--out", metavar="REPORT.json",
                        help="also write the (last) JSON report here — the "
                             "file tracing/doctor.py --statecheck reads")
    args = parser.parse_args(argv)

    from flink_tensorflow_tpu_torch.analysis.capture import capture_pipeline_file

    job_args = args.job_args.split()
    exit_code = 0
    report = None
    for path in args.pipelines:
        try:
            env = capture_pipeline_file(path, job_args)
        except Exception as ex:  # noqa: BLE001 - report and keep going
            print(f"{path}: capture failed: {ex}", file=sys.stderr)
            exit_code = max(exit_code, 2)
            continue
        if args.mesh:
            from flink_tensorflow_tpu_torch.analysis.shardcheck import _parse_mesh
            from flink_tensorflow_tpu_torch.parallel.mesh import abstract_mesh

            env.config = dc.replace(env.config, mesh=abstract_mesh(_parse_mesh(args.mesh)))
        report = report_for_env(env, pipeline=path)
        if args.json:
            print(json.dumps(report))
        else:
            print(f"== {path} ==")
            for a in report["operators"]:
                line = f"  [{a['kind']}] {a['node']}"
                if a.get("source_class"):
                    line += f"  source={a['source_class']}"
                if a.get("guarantee"):
                    line += f"  guarantee={a['guarantee']}"
                if a.get("train_state_bytes"):
                    line += f"  train_state={a['train_state_bytes'] / 2**20:.1f}MiB"
                print(line)
                for sym in a["hidden_state"]:
                    print(f"      hidden: {sym}")
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
    return exit_code


if __name__ == "__main__":
    import sys

    sys.exit(main())
