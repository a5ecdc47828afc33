"""Replay-purity bytecode scanner, the plan-time half of the pipeline
sanitizer (the runtime half is ``core/sanitizer_rt.py``).

Port of ``flink_tensorflow_tpu/analysis/sanitizer.py``.  Exactly-once
recovery replays records through user functions after a restore, and
keyed and operator state is rebuilt by that replay.  A user function that
reads a wall clock, draws from a process-global generator, mutates module
globals, captures a mutable closure or does I/O computes something else
on the replay, and the checkpoint's promise breaks with no exception.

This module walks user function bytecode (``dis`` over ``__code__``,
nested lambdas and two levels of user helpers included) and reports those
sources as :class:`PurityFinding` findings.  Only user code is scanned: code
whose file lies inside this package (``flink_tensorflow_tpu_torch``) is
the framework's and is skipped.  Names are resolved through the
function's ``__globals__`` first (so ``from random import random`` and
``import numpy as anything`` are caught by identity), with a spelling
fallback for chains that do not resolve.  The classification is the
reference's, unchanged.
"""

from __future__ import annotations

import builtins
import dataclasses
import dis
import functools
import os
import types
import typing

#: .../flink_tensorflow_tpu_torch: code under here is framework, not user code.
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep

_MISSING = object()

#: time-module functions that read the wall/monotonic clock.
_TIME_FUNCS = frozenset({
    "time", "time_ns", "monotonic", "monotonic_ns", "perf_counter",
    "perf_counter_ns", "process_time", "process_time_ns", "localtime",
    "gmtime", "ctime",
})
_DATETIME_FUNCS = frozenset({"now", "utcnow", "today"})

#: numpy.random module-level constructors that produce SEEDED/owned
#: generators — using these is the recommended pattern, not a finding.
_NP_RANDOM_OK = frozenset({"RandomState", "default_rng", "Generator",
                           "SeedSequence", "PCG64", "Philox", "MT19937"})

#: modules whose use inside a streaming user function is I/O.
_IO_MODULES = frozenset({"socket", "requests", "urllib", "http", "subprocess"})
_OS_IO_FUNCS = frozenset({
    "remove", "unlink", "rename", "replace", "mkdir", "makedirs", "rmdir",
    "system", "popen", "open", "write", "truncate",
})

_MUTABLE_TYPES = (list, dict, set, bytearray)


@dataclasses.dataclass(frozen=True)
class PurityFinding:
    """One replay-purity impurity source found in user bytecode."""

    #: wall-clock | unseeded-random | global-mutation | mutable-closure | io
    kind: str
    #: The offending symbol as spelled in the code (``time.time``,
    #: ``np.random.rand``, ``global counter``, ...).
    symbol: str
    #: Qualified name of the function the finding is in.
    where: str
    #: 1-based source line when the bytecode carries one.
    line: typing.Optional[int] = None

    def describe(self) -> str:
        loc = f"{self.where}" + (f":{self.line}" if self.line else "")
        reason = {
            "wall-clock": "reads the wall clock — replay after restore sees a different time",
            "unseeded-random": "draws from a process-global RNG — replay sees a different stream",
            "global-mutation": "mutates a module global — state survives outside checkpoints",
            "mutable-closure": "captures a mutable object by closure — state survives outside checkpoints",
            "io": "performs I/O — replayed records repeat the side effect",
        }[self.kind]
        return f"{self.symbol} in {loc} {reason}"


def _is_user_code(code: types.CodeType) -> bool:
    filename = code.co_filename
    return bool(filename) and not os.path.abspath(filename).startswith(_PKG_DIR)


def _iter_code_objects(code: types.CodeType) -> typing.Iterator[types.CodeType]:
    """``code`` plus every code object nested in its constants (inner
    lambdas, comprehensions, local defs)."""
    yield code
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            yield from _iter_code_objects(const)


def _resolve_chain(
    chain: typing.Sequence[str], globals_ns: typing.Optional[dict]
) -> typing.Any:
    obj = (globals_ns or {}).get(chain[0], _MISSING)
    if obj is _MISSING:
        obj = getattr(builtins, chain[0], _MISSING)
    for attr in chain[1:]:
        if obj is _MISSING:
            return _MISSING
        obj = getattr(obj, attr, _MISSING)
    return obj


def _global_random_inst():
    import random

    return random._inst


def _np_global_state():
    try:
        import numpy as np

        return np.random.mtrand._rand
    except Exception:  # pragma: no cover - numpy always present here
        return None


def _classify_chain(
    chain: typing.Sequence[str], globals_ns: typing.Optional[dict]
) -> typing.Optional[typing.Tuple[str, str]]:
    """(kind, symbol) when the attribute chain names an impurity source."""
    symbol = ".".join(chain)
    resolved = _resolve_chain(chain, globals_ns)
    if resolved is not _MISSING:
        mod = getattr(resolved, "__module__", None)
        if mod == "time" and getattr(resolved, "__name__", "") in _TIME_FUNCS:
            return "wall-clock", symbol
        qual = getattr(resolved, "__qualname__", "")
        if mod == "datetime" and qual.split(".")[-1] in _DATETIME_FUNCS:
            return "wall-clock", symbol
        bound_self = getattr(resolved, "__self__", None)
        if bound_self is not None:
            if bound_self is _global_random_inst():
                return "unseeded-random", symbol
            if bound_self is _np_global_state():
                return "unseeded-random", symbol
        if resolved is builtins.open or resolved is builtins.input:
            return "io", symbol
        if isinstance(resolved, types.ModuleType):
            return None  # a bare module load is not a call
        root = (mod or "").split(".")[0]
        if root in _IO_MODULES:
            return "io", symbol
        if (root in ("os", "posix", "nt")
                and getattr(resolved, "__name__", "") in _OS_IO_FUNCS):
            return "io", symbol
        return None
    # Unresolvable (e.g. a method-local alias): fall back to spelling.
    if chain[0] == "time" and len(chain) > 1 and chain[1] in _TIME_FUNCS:
        return "wall-clock", symbol
    if (len(chain) >= 3 and chain[1] == "random"
            and chain[2] not in _NP_RANDOM_OK):
        return "unseeded-random", symbol
    if chain[0] in _IO_MODULES:
        return "io", symbol
    if len(chain) > 1 and chain[0] == "os" and chain[-1] in _OS_IO_FUNCS:
        return "io", symbol
    return None


#: Interprocedural depth: helpers called DIRECTLY from a scanned user
#: function are scanned, and so are THEIR helpers (two levels by
#: default — ``outer -> helper -> helper2`` provenance chains); deeper
#: callees are not.  Two levels cover the ubiquitous "map fn delegates
#: to a module helper which delegates to a shared util" split without
#: turning the scanner into a whole-program analysis; pass
#: ``max_depth=`` to :func:`scan_code` to tune it per call.
_MAX_CALL_DEPTH = 2

#: Memoized per-code local scans: id(code) -> (code, base, findings,
#: helpers).  The same helper reached from many operators (or many
#: outer functions) is disassembled ONCE; callers re-root the cached
#: findings' ``where`` onto their own provenance chain.  The value
#: holds a strong reference to the code object so its id cannot be
#: recycled while the cache entry lives.
_SCAN_CACHE: typing.Dict[int, tuple] = {}


def _helper_fn(
    chain: typing.Sequence[str], globals_ns: typing.Optional[dict]
) -> typing.Optional[types.FunctionType]:
    """The USER-DEFINED function a global attribute chain names, if any —
    the interprocedural edge.  Stdlib/framework callees resolve but live
    outside user code and are cut off here; unresolvable chains (locals,
    arguments) never form an edge."""
    resolved = _resolve_chain(chain, globals_ns)
    if resolved is _MISSING:
        return None
    fn = _unwrap(resolved)
    if fn is None or not _is_user_code(fn.__code__):
        return None
    return fn


def _scan_local(
    code: types.CodeType, globals_ns: typing.Optional[dict],
) -> typing.Tuple[str, typing.List[PurityFinding],
                  typing.List[types.FunctionType]]:
    """One code object's OWN findings (nested code included) plus the
    user-defined helpers it names — no recursion into them.  Memoized:
    findings carry a base-relative ``where`` (rooted at the code's own
    qualname) which :func:`scan_code` re-roots per caller."""
    cached = _SCAN_CACHE.get(id(code))
    if cached is not None and cached[0] is code:
        return cached[1], cached[2], cached[3]
    base = getattr(code, "co_qualname", code.co_name)
    findings: typing.List[PurityFinding] = []
    helpers: typing.List[types.FunctionType] = []
    for co in _iter_code_objects(code):
        qual = base if co is code else f"{base}.<{co.co_name}>"
        chain: typing.List[str] = []
        chain_line: typing.Optional[int] = None
        line: typing.Optional[int] = None
        for instr in dis.get_instructions(co):
            if instr.starts_line is not None:
                line = instr.starts_line
            op = instr.opname
            if op in ("LOAD_GLOBAL", "LOAD_NAME"):
                _flush(chain, chain_line, globals_ns, qual, findings, helpers)
                chain = [instr.argval]
                chain_line = line
            elif op in ("LOAD_ATTR", "LOAD_METHOD") and chain:
                chain.append(instr.argval)
            else:
                _flush(chain, chain_line, globals_ns, qual, findings, helpers)
                chain = []
                if op in ("STORE_GLOBAL", "DELETE_GLOBAL"):
                    findings.append(PurityFinding(
                        kind="global-mutation",
                        symbol=f"global {instr.argval}",
                        where=qual, line=line,
                    ))
        _flush(chain, chain_line, globals_ns, qual, findings, helpers)
    _SCAN_CACHE[id(code)] = (code, base, findings, helpers)
    return base, findings, helpers


def scan_code(
    code: types.CodeType,
    globals_ns: typing.Optional[dict] = None,
    where: typing.Optional[str] = None,
    *,
    max_depth: typing.Optional[int] = None,
    _depth: int = 0,
    _seen: typing.Optional[typing.Set[int]] = None,
) -> typing.List[PurityFinding]:
    """Purity findings for one code object (nested code included), plus
    — ``max_depth`` call levels deep (default :data:`_MAX_CALL_DEPTH`)
    — every user-defined helper it names, scanned with the same matrix
    and attributed along the full ``outer -> helper -> helper2``
    provenance chain.  Recursion is cut by a seen-set over code objects
    (the cycle guard), stdlib/framework callees by the user-code
    filter; per-code disassembly is memoized in :data:`_SCAN_CACHE`."""
    depth_cap = _MAX_CALL_DEPTH if max_depth is None else max_depth
    seen = _seen if _seen is not None else set()
    seen.add(id(code))
    top = where or getattr(code, "co_qualname", code.co_name)
    base, local, helpers = _scan_local(code, globals_ns)
    if top == base:
        findings = list(local)
    else:  # re-root the cached base-relative provenance onto this chain
        findings = [dataclasses.replace(f, where=top + f.where[len(base):])
                    for f in local]
    if _depth < depth_cap:
        for helper in helpers:
            if id(helper.__code__) in seen:
                continue  # recursion / already-scanned helper
            findings.extend(scan_code(
                helper.__code__, helper.__globals__,
                where=f"{top} -> {helper.__qualname__}",
                max_depth=depth_cap, _depth=_depth + 1, _seen=seen,
            ))
    return findings


def _flush(chain, chain_line, globals_ns, qual, findings, helpers) -> None:
    if not chain:
        return
    hit = _classify_chain(chain, globals_ns)
    if hit is not None:
        kind, symbol = hit
        findings.append(PurityFinding(kind=kind, symbol=symbol,
                                      where=qual, line=chain_line))
        return
    helper = _helper_fn(chain, globals_ns)
    if helper is not None:
        helpers.append(helper)


def _unwrap(member: typing.Any) -> typing.Optional[types.FunctionType]:
    if isinstance(member, (staticmethod, classmethod)):
        member = member.__func__
    if isinstance(member, functools.partial):
        member = member.func
    if isinstance(member, types.MethodType):
        member = member.__func__
    return member if isinstance(member, types.FunctionType) else None


def collect_user_functions(
    obj: typing.Any, _seen: typing.Optional[typing.Set[int]] = None
) -> typing.List[typing.Tuple[str, types.FunctionType]]:
    """(qualname, function) pairs of USER code reachable from ``obj``.

    ``obj`` may be a bare callable, a RichFunction/SourceFunction/
    SplitSource instance, or an operator: methods of non-framework
    classes in its MRO, plus callables stored in its instance ``__dict__``
    (where the framework's lambda wrappers keep the user's function),
    plus functions captured by closure — everything filtered to code
    objects living OUTSIDE the flink_tensorflow_tpu_torch package.
    """
    seen = _seen if _seen is not None else set()
    out: typing.List[typing.Tuple[str, types.FunctionType]] = []
    if obj is None or id(obj) in seen:
        return out
    if _unwrap(obj) is None:  # containers dedup by id; functions in add()
        seen.add(id(obj))

    def add(name: str, fn_obj: typing.Any) -> None:
        fn = _unwrap(fn_obj)
        if fn is None or id(fn) in seen:
            return
        seen.add(id(fn))
        if not _is_user_code(fn.__code__):
            return
        out.append((name, fn))
        for cell in fn.__closure__ or ():
            try:
                captured = cell.cell_contents
            except ValueError:  # pragma: no cover - empty cell
                continue
            if isinstance(captured, types.FunctionType):
                add(f"{name}.<closure>", captured)

    direct = _unwrap(obj)
    if direct is not None:
        add(getattr(direct, "__qualname__", direct.__name__), direct)
        return out

    for cls in type(obj).__mro__:
        if cls.__module__.startswith("flink_tensorflow_tpu_torch.") or cls is object:
            continue
        for name, member in vars(cls).items():
            add(f"{cls.__qualname__}.{name}", member)
    for name, member in vars(obj).items() if hasattr(obj, "__dict__") else ():
        if callable(member) and not isinstance(member, type):
            if _unwrap(member) is not None:
                add(f"{type(obj).__qualname__}.{name}", member)
            else:
                # A callable object stored on the instance (e.g. a user
                # function object wrapped by a framework one): recurse.
                out.extend(collect_user_functions(member, seen))
    return out


def scan_callable(obj: typing.Any) -> typing.List[PurityFinding]:
    """All purity findings for one user function/object: bytecode scan
    of every reachable user code object + mutable-closure captures."""
    findings: typing.List[PurityFinding] = []
    for name, fn in collect_user_functions(obj):
        findings.extend(scan_code(fn.__code__, fn.__globals__, where=name))
        for var, cell in zip(fn.__code__.co_freevars, fn.__closure__ or ()):
            try:
                captured = cell.cell_contents
            except ValueError:  # pragma: no cover - empty cell
                continue
            if isinstance(captured, _MUTABLE_TYPES):
                findings.append(PurityFinding(
                    kind="mutable-closure",
                    symbol=f"closure {var!r} ({type(captured).__name__})",
                    where=name,
                ))
    return findings


def scan_operator(op: typing.Any) -> typing.List[PurityFinding]:
    """Purity findings for everything user-authored an operator hosts:
    its function, key selectors, timestamp assigner, split source."""
    findings: typing.List[PurityFinding] = []
    seen_syms: typing.Set[typing.Tuple[str, str, str]] = set()
    for attr in ("function", "key_selector", "key_selector1", "key_selector2",
                 "ts_fn", "source"):
        target = getattr(op, attr, None)
        if target is None:
            continue
        for f in scan_callable(target):
            key = (f.kind, f.symbol, f.where)
            if key not in seen_syms:
                seen_syms.add(key)
                findings.append(f)
    return findings
