"""Plan-time RecordSchema propagation over the dataflow graph.

Port of ``flink_tensorflow_tpu/analysis/schema_prop.py``.  The
TypeInformation role Flink's job-graph translation plays: sources
declare the schema of the records they emit
(``Transformation.declared_schema``), every downstream operator may
declare a transform (``Transformation.schema_fn``, usually wired from
the function's optional ``output_schema(input_schema)`` hook), and this
pass walks the topological order applying them — validating without
executing (a model function derives its output by running its method on
meta tensors, ``RecordSchema.batched_struct``).

Propagation tracks the SET of distinct schemas flowing on each node's
output, not just one: a union of two differently-shaped streams legally
carries both signatures, and only a downstream runner boundary turns
that into recompilation churn (a lint rule's job, not propagation's).  A
``schema_fn`` that raises :class:`SchemaMismatch` produces an ERROR
diagnostic naming the exact edge the offending schema arrived on.
"""

from __future__ import annotations

import dataclasses
import typing

from flink_tensorflow_tpu_torch.analysis.diagnostics import Diagnostic, Severity, edge_name
from flink_tensorflow_tpu_torch.core.graph import DataflowGraph, Transformation
from flink_tensorflow_tpu_torch.core.operators import Operator
from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, SchemaMismatch


@dataclasses.dataclass
class SchemaFlow:
    """Propagation result.

    ``out``: node id -> the node's sole output schema, or None when it is
    unknown or ambiguous (several signatures flow).
    ``out_sets``: node id -> every distinct schema known to flow out of
    the node (empty = unknown).
    """

    out: typing.Dict[int, typing.Optional[RecordSchema]]
    out_sets: typing.Dict[int, typing.List[RecordSchema]]
    diagnostics: typing.List[Diagnostic]


def is_two_input(op: typing.Optional[Operator]) -> bool:
    """Two-input operators (connect/join) dispatch per logical edge and
    legitimately see a different schema per input."""
    if op is None:
        return False
    return type(op).process_record_from is not Operator.process_record_from


def _apply(schema_fn, input_schema):
    """A schema_fn is either a callable transform or a constant schema."""
    if isinstance(schema_fn, RecordSchema):
        return schema_fn
    return schema_fn(input_schema)


def propagate(
    graph: DataflowGraph,
    order: typing.Sequence[Transformation],
    operators: typing.Mapping[int, typing.Optional[Operator]],
) -> SchemaFlow:
    diags: typing.List[Diagnostic] = []
    # Ordered sets (dict keys) so diagnostics are deterministic.
    out_sets: typing.Dict[int, typing.Dict[RecordSchema, None]] = {}

    for t in order:
        if t.is_source:
            if t.declared_schema is None:
                diags.append(Diagnostic(
                    rule="source-schema-unknown",
                    severity=Severity.INFO,
                    message="source declares no RecordSchema; schema "
                            "propagation is disabled downstream of it "
                            "(pass schema=... to from_source/from_collection)",
                    node=t.name,
                ))
                out_sets[t.id] = {}
            else:
                out_sets[t.id] = {t.declared_schema: None}
            continue

        # Distinct incoming schemas with the direct edge each arrived on.
        incoming: typing.List[typing.Tuple[RecordSchema, str]] = []
        seen: typing.Set[RecordSchema] = set()
        for e in t.inputs:
            for s in out_sets.get(e.upstream.id, {}):
                if s not in seen:
                    seen.add(s)
                    incoming.append((s, e.upstream.name))

        outs: typing.Dict[RecordSchema, None] = {}
        if t.schema_fn is None:
            pass  # no contract declared: output unknown
        elif is_two_input(operators.get(t.id)):
            per_edge = tuple(
                next(iter(out_sets.get(e.upstream.id, {})), None)
                for e in t.inputs
            )
            try:
                r = _apply(t.schema_fn, per_edge)
                if r is not None:
                    outs[r] = None
            except SchemaMismatch as m:
                diags.append(Diagnostic(
                    rule="schema-mismatch", severity=Severity.ERROR,
                    message=str(m), node=t.name,
                    edge=edge_name(t.inputs[0].upstream.name, t.name),
                ))
            except Exception as ex:  # noqa: BLE001 - hook bugs must not kill analysis
                diags.append(Diagnostic(
                    rule="schema-hook-error", severity=Severity.WARN,
                    message=f"output_schema hook raised {ex!r}", node=t.name,
                ))
        elif not incoming:
            # Unknown input: a hook can still declare a constant output
            # (and must tolerate input_schema=None).
            try:
                r = _apply(t.schema_fn, None)
                if r is not None:
                    outs[r] = None
            except SchemaMismatch:
                pass  # nothing to validate against — stay unknown
            except Exception as ex:  # noqa: BLE001
                diags.append(Diagnostic(
                    rule="schema-hook-error", severity=Severity.WARN,
                    message=f"output_schema hook raised {ex!r}", node=t.name,
                ))
        else:
            for s, upstream_name in incoming:
                try:
                    r = _apply(t.schema_fn, s)
                    if r is not None:
                        outs.setdefault(r)
                except SchemaMismatch as m:
                    diags.append(Diagnostic(
                        rule="schema-mismatch", severity=Severity.ERROR,
                        message=str(m), node=t.name,
                        edge=edge_name(upstream_name, t.name),
                    ))
                except Exception as ex:  # noqa: BLE001
                    diags.append(Diagnostic(
                        rule="schema-hook-error", severity=Severity.WARN,
                        message=f"output_schema hook raised {ex!r}",
                        node=t.name,
                        edge=edge_name(upstream_name, t.name),
                    ))
        out_sets[t.id] = outs

    return SchemaFlow(
        out={
            tid: next(iter(s)) if len(s) == 1 else None
            for tid, s in out_sets.items()
        },
        out_sets={tid: list(s) for tid, s in out_sets.items()},
        diagnostics=diags,
    )
