"""``analyze(graph)`` — the plan-time analysis pass.

Port of ``flink_tensorflow_tpu/analysis/analyzer.py``.

Walks ``DataflowGraph.topological_order()``, instantiates one operator
per transformation (factories only construct host-side objects; neither
``open()`` nor any device work runs), propagates RecordSchemas, and runs
the lint registry.  Returns diagnostics sorted most-severe-first; it
never raises on a bad plan — gating on ERROR is the caller's choice
(``execute(validate=True)``, the CLI's exit code).
"""

from __future__ import annotations

import typing

from flink_tensorflow_tpu_torch.analysis.diagnostics import (
    Diagnostic,
    Severity,
)
from flink_tensorflow_tpu_torch.analysis.rules import AnalysisContext, run_rules
from flink_tensorflow_tpu_torch.analysis.schema_prop import propagate
from flink_tensorflow_tpu_torch.core.graph import CycleError, DataflowGraph, Transformation
from flink_tensorflow_tpu_torch.core.operators import Operator


def _instantiate(
    graph: DataflowGraph,
) -> typing.Tuple[typing.Dict[int, typing.Optional[Operator]], typing.List[Diagnostic]]:
    operators: typing.Dict[int, typing.Optional[Operator]] = {}
    diags: typing.List[Diagnostic] = []
    for t in graph.transformations:
        try:
            operators[t.id] = t.operator_factory()
        except Exception as ex:  # noqa: BLE001 - a broken factory is itself a finding
            operators[t.id] = None
            diags.append(Diagnostic(
                rule="factory-error", severity=Severity.WARN,
                message=f"operator factory raised at plan time: {ex!r} — "
                        "operator-level lints are skipped for this node",
                node=t.name,
            ))
    return operators, diags


def analyze(
    graph: DataflowGraph,
    *,
    config: typing.Optional[typing.Any] = None,
) -> typing.List[Diagnostic]:
    """Analyze a logical plan; returns diagnostics, most severe first.

    ``config`` (a JobConfig) enables the config-dependent rules —
    mesh divisibility and the keyed max-parallelism bound.
    """
    try:
        order: typing.List[Transformation] = graph.topological_order()
    except CycleError as cycle:
        # No topological order exists: nothing else is analyzable.
        return [Diagnostic(
            rule="cycle", severity=Severity.ERROR,
            message=str(cycle), node=cycle.cycle_names[0],
        )]

    operators, diags = _instantiate(graph)
    flow = propagate(graph, order, operators)
    diags.extend(flow.diagnostics)
    ctx = AnalysisContext(
        graph=graph, order=order, operators=operators,
        schemas=flow.out, schema_sets=flow.out_sets, config=config,
    )
    diags.extend(run_rules(ctx))
    diags.sort(key=lambda d: -int(d.severity))
    return diags


def has_errors(diagnostics: typing.Sequence[Diagnostic]) -> bool:
    return any(d.severity == Severity.ERROR for d in diagnostics)
