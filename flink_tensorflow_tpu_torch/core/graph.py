"""Logical dataflow graph (the JobGraph equivalent).

Copy of ``flink_tensorflow_tpu/core/graph.py`` (``DataflowGraph`` ``:73``)
without the plan-analysis fields: transformations record an operator
factory, a parallelism, input edges and the two chaining opt-outs; the
executor instantiates one operator per subtask, fuses chains
(``analysis/chaining.py``) and wires channels per partitioner.  A
transformation may have several input edges (a union, a connected
stream, a join); the runtime hands each record to its operator with the
index of the edge it came through.  A side output is no edge of its
own: ``DataStream.side_output(tag)`` adds a filtering ``flat_map`` that
reads the producing transformation.
"""

from __future__ import annotations

import dataclasses
import typing

from flink_tensorflow_tpu_torch.core.partitioning import Partitioner

if typing.TYPE_CHECKING:
    from flink_tensorflow_tpu_torch.core.operators import Operator


class CycleError(RuntimeError):
    """The graph is cyclic; carries the names on the cycle."""

    def __init__(self, cycle_names: typing.Sequence[str]):
        self.cycle_names = list(cycle_names)
        super().__init__("dataflow graph contains a cycle: " + " -> ".join(self.cycle_names))


@dataclasses.dataclass
class Edge:
    upstream: "Transformation"
    partitioner: Partitioner


@dataclasses.dataclass
class Transformation:
    """One logical operator in the dataflow graph."""

    id: int
    name: str
    operator_factory: typing.Callable[[], "Operator"]
    parallelism: int
    inputs: typing.List[Edge] = dataclasses.field(default_factory=list)
    is_source: bool = False
    #: Chaining opt-outs (Flink's startNewChain / disableChaining):
    #: ``chain_start`` pins this operator as the head of a new chain (its
    #: input edge never fuses); ``chainable=False`` keeps it out of
    #: chains on both sides.
    chain_start: bool = False
    chainable: bool = True

    def __hash__(self) -> int:
        return self.id

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Transformation) and other.id == self.id


class DataflowGraph:
    def __init__(self) -> None:
        self.transformations: typing.List[Transformation] = []
        self._next_id = 0
        self._names: typing.Set[str] = set()

    def add(
        self,
        name: str,
        operator_factory: typing.Callable[[], "Operator"],
        parallelism: int,
        inputs: typing.Optional[typing.List[Edge]] = None,
        is_source: bool = False,
    ) -> Transformation:
        if parallelism <= 0:
            raise ValueError(f"parallelism must be positive, got {parallelism}")
        # Task names key metric scopes: a collision gets a suffix.
        unique = name
        n = 2
        while unique in self._names:
            unique = f"{name}_{n}"
            n += 1
        self._names.add(unique)
        t = Transformation(id=self._next_id, name=unique, operator_factory=operator_factory,
                           parallelism=parallelism, inputs=list(inputs or []),
                           is_source=is_source)
        self._next_id += 1
        self.transformations.append(t)
        return t

    def topological_order(self) -> typing.List[Transformation]:
        """Upstream-before-downstream order; raises :class:`CycleError`."""
        order: typing.List[Transformation] = []
        done: typing.Set[int] = set()
        on_path: typing.Set[int] = set()

        def visit(t: Transformation, path: typing.List[Transformation]) -> None:
            if t.id in done:
                return
            if t.id in on_path:
                start = next(i for i, p in enumerate(path) if p.id == t.id)
                raise CycleError([p.name for p in path[start:]] + [t.name])
            on_path.add(t.id)
            path.append(t)
            for edge in t.inputs:
                visit(edge.upstream, path)
            path.pop()
            on_path.discard(t.id)
            done.add(t.id)
            order.append(t)

        for t in self.transformations:
            visit(t, [])
        return order
