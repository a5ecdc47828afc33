"""Operator-chaining pass — fuse forward hops into single-thread chains.

Copy of ``flink_tensorflow_tpu/analysis/chaining.py`` (the rules
``:13-36``, ``device_capable_op`` ``:63``, the accepts test ``:73``,
``sharding_axes_of`` ``:78``, the cut reasons ``:106-109``, the plan with
``device_resident_edges`` ``:135-140`` and its ``->``/``=>`` print
``format_topology`` ``:157-170``, here ``describe``, the residency pass
``:307-315``).  The pass walks the
:class:`~flink_tensorflow_tpu_torch.core.graph.DataflowGraph` and groups
transformations into chains; ``core/runtime.py`` runs one subtask thread
per chain, whose ``ChainedOutput`` calls the next operator directly.

An edge ``u -> d`` fuses only when all of these hold:

- the partitioner is a plain forward hop (keyed, rebalance and
  broadcast edges re-route records between subtasks and never fuse);
- upstream and downstream parallelism are equal;
- ``d`` has exactly one input and ``u`` exactly one outgoing edge (the
  reference's "multi-input operator aligns several channels",
  ``:209-210``): a union, a connected stream or a join is always a chain
  head, and a window applied with a ``late_tag``, whose main stream and
  side-output tap both read it, always a chain tail;
- neither side opted out (``disable_chaining()``) and ``d`` was not
  pinned as a chain head (``start_new_chain()``);
- neither side is a gang operator (a gang owns the device mesh and
  blocks in its step), and their declared sharding axes agree;
- timer-driven operators (windows with wall-clock deadlines, async
  maps, process functions) never fuse into a legacy source chain: that
  source loop blocks inside the user function and cannot serve
  deadlines.  Behind a worker head they fuse: the worker loop waits
  until the chain's earliest deadline.  Behind a split source
  (``sources/``, whose operator is ``wakeable``) they fuse too: its
  mailbox loop parks until the chain's earliest deadline (``:273-280``).
"""

from __future__ import annotations

import dataclasses
import typing

from flink_tensorflow_tpu_torch.core.graph import DataflowGraph, Edge, Transformation
from flink_tensorflow_tpu_torch.core.partitioning import ForwardPartitioner

if typing.TYPE_CHECKING:
    from flink_tensorflow_tpu_torch.core.operators import Operator

#: The mesh's batch axis (``parallel/mesh.py``), the default of gangs.
DATA_AXIS = "data"

#: Why a source chain is cut before a timer-driven member.
TIMER_CUT_REASON = (
    "timer-driven operator cannot chain into a source "
    "loop (wall-clock deadlines would wait on the "
    "source's own sleeps)"
)


def device_capable_op(op: typing.Optional["Operator"]) -> bool:
    """Whether an operator's function can produce device batches (the
    ``device_capable`` marker)."""
    return bool(getattr(getattr(op, "function", None), "device_capable", False))


def accepts_device_op(op: typing.Optional["Operator"]) -> bool:
    """Whether an operator's function consumes device batches directly
    (the ``accepts_device_batches`` marker)."""
    return bool(getattr(getattr(op, "function", None), "accepts_device_batches", False))


def sharding_axes_of(function: typing.Any) -> typing.Optional[typing.Tuple[str, ...]]:
    """Mesh axes a function shards its batch over, or None for an
    unsharded one: its ``sharding_axes``, else ``("data",)`` for a gang."""
    if function is None:
        return None
    axes = getattr(function, "sharding_axes", None)
    if axes is not None:
        return tuple(axes)
    if getattr(function, "is_gang", False):
        return (DATA_AXIS,)
    return None


def sharding_fusion_conflict(up_op: typing.Optional["Operator"],
                             down_op: typing.Optional["Operator"]) -> typing.Optional[str]:
    """Why two adjacent operators must not share a thread on sharding
    grounds, or None."""
    up_fn = getattr(up_op, "function", None)
    down_fn = getattr(down_op, "function", None)
    if getattr(up_fn, "is_gang", False) or getattr(down_fn, "is_gang", False):
        return "gang operator owns the device mesh and never chains"
    up_axes = sharding_axes_of(up_fn)
    down_axes = sharding_axes_of(down_fn)
    if up_axes != down_axes and (up_axes is not None or down_axes is not None):
        return (f"mismatched sharding axes ({up_axes} vs {down_axes}) — the two "
                "steps place batches on different mesh axes")
    return None


@dataclasses.dataclass
class ChainPlan:
    """The chaining decision for one graph.

    ``chains`` lists every chain in topological order, head first;
    unchained operators are chains of one, so the lists partition the
    graph."""

    chains: typing.List[typing.List[Transformation]]
    #: ``(upstream id, downstream id)`` -> why that forward edge stayed a
    #: channel (keyed and rebalance edges are not listed).
    unchained_reasons: typing.Dict[typing.Tuple[int, int], str]
    #: Fused edges whose upstream produces device batches and whose
    #: downstream consumes them: the runtime skips the D2H/H2D pair on
    #: exactly these hops when ``JobConfig.device_resident`` is on.
    device_resident_edges: typing.Set[typing.Tuple[int, int]] = dataclasses.field(
        default_factory=set)

    def chain_of(self, t: Transformation) -> typing.List[Transformation]:
        """The chain ``t`` runs in."""
        for chain in self.chains:
            if any(member.id == t.id for member in chain):
                return chain
        raise KeyError(t.name)

    @property
    def chained_edge_count(self) -> int:
        return sum(len(c) - 1 for c in self.chains)

    def names(self) -> typing.List[typing.List[str]]:
        return [[t.name for t in chain] for chain in self.chains]

    def describe(self) -> str:
        """One line per chain; ``=>`` marks a fused edge that stays on the
        device under ``device_resident`` (``->`` is a host-record hop)."""
        lines = []
        for chain in self.chains:
            members = chain[0].name
            for up, down in zip(chain, chain[1:]):
                arrow = "=>" if (up.id, down.id) in self.device_resident_edges else "->"
                members += f" {arrow} {down.name}"
            fused = f", {len(chain) - 1} fused edge(s)" if len(chain) > 1 else ""
            lines.append(f"chain [x{chain[0].parallelism}{fused}]: {members}")
        return "\n".join(lines)


def _instantiate_quietly(graph: DataflowGraph) -> typing.Dict[int, typing.Optional["Operator"]]:
    ops: typing.Dict[int, typing.Optional["Operator"]] = {}
    for t in graph.transformations:
        try:
            ops[t.id] = t.operator_factory()
        except Exception:  # noqa: BLE001 - a broken factory is unchainable
            ops[t.id] = None
    return ops


def chainable_edge(edge: Edge, downstream: Transformation, *, out_degree: int,
                   up_op: typing.Optional["Operator"],
                   down_op: typing.Optional["Operator"]) -> typing.Optional[str]:
    """Why ``edge`` must stay a channel, or None when it can fuse.
    ``up_op`` / ``down_op`` are plan-time instances (never opened); None
    for a factory that failed, which blocks fusion."""
    u = edge.upstream
    if not isinstance(edge.partitioner, ForwardPartitioner):
        return f"{type(edge.partitioner).__name__} edge re-routes records"
    if u.parallelism != downstream.parallelism:
        return f"parallelism changes ({u.parallelism} -> {downstream.parallelism})"
    if len(downstream.inputs) != 1:
        return "multi-input operator aligns several channels"
    if out_degree != 1:
        return "upstream fans out to several edges"
    if not u.chainable:
        return f"{u.name} has chaining disabled"
    if not downstream.chainable:
        return f"{downstream.name} has chaining disabled"
    if downstream.chain_start:
        return f"{downstream.name} starts a new chain"
    if up_op is None or down_op is None:
        return "operator factory failed at plan time"
    return sharding_fusion_conflict(up_op, down_op)


def compute_chains(graph: DataflowGraph, *,
                   operators: typing.Optional[typing.Dict[int, typing.Optional["Operator"]]] = None,
                   enabled: bool = True) -> ChainPlan:
    """Group the graph's transformations into execution chains.

    ``operators`` reuses the plan analyzer's instances; omitted, the
    factories run here once each, to read the operators' markers (cheap:
    ``open()`` never runs).  ``enabled=False`` gives the degenerate plan,
    every operator a chain of its own."""
    order = graph.topological_order()
    if operators is None:
        operators = _instantiate_quietly(graph) if enabled else {}
    out_degree: typing.Dict[int, int] = {t.id: 0 for t in order}
    for t in order:
        for e in t.inputs:
            out_degree[e.upstream.id] += 1

    next_of: typing.Dict[int, Transformation] = {}
    reasons: typing.Dict[typing.Tuple[int, int], str] = {}
    if enabled:
        for t in order:
            for e in t.inputs:
                reason = chainable_edge(e, t, out_degree=out_degree[e.upstream.id],
                                        up_op=operators.get(e.upstream.id),
                                        down_op=operators.get(t.id))
                if reason is None:
                    next_of[e.upstream.id] = t
                elif isinstance(e.partitioner, ForwardPartitioner):
                    reasons[(e.upstream.id, t.id)] = reason

    # A legacy source chain is cut before its first timer-driven member,
    # wherever it sits: source -> map -> window(timeout) splits at map |
    # window, leaving the window a worker head that waits until its
    # deadline.  A split source is exempt (its head is ``wakeable``): its
    # loop parks on a mailbox bounded by the chain's earliest deadline.
    for t in order:
        if not t.is_source:
            continue
        head_op = operators.get(t.id)
        if head_op is not None and getattr(head_op, "wakeable", False):
            continue
        prev, cur = t, next_of.get(t.id)
        while cur is not None:
            op = operators.get(cur.id)
            if op is not None and op.uses_timers:
                del next_of[prev.id]
                reasons[(prev.id, cur.id)] = TIMER_CUT_REASON
                break
            prev, cur = cur, next_of.get(cur.id)

    chained_into = {d.id for d in next_of.values()}
    chains: typing.List[typing.List[Transformation]] = []
    for t in order:
        if t.id in chained_into:
            continue
        chain = [t]
        cur = t
        while cur.id in next_of:
            cur = next_of[cur.id]
            chain.append(cur)
        chains.append(chain)
    device_edges: typing.Set[typing.Tuple[int, int]] = set()
    for chain in chains:
        for up, down in zip(chain, chain[1:]):
            if device_capable_op(operators.get(up.id)) and accepts_device_op(operators.get(down.id)):
                device_edges.add((up.id, down.id))
    return ChainPlan(chains=chains, unchained_reasons=reasons,
                     device_resident_edges=device_edges)
