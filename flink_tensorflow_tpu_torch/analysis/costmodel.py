"""Static cost model — the data half.

Port of the data classes of ``flink_tensorflow_tpu/analysis/costmodel.py``
(``:95-192``): :class:`CostEntry` (the static price of ONE call of one
unit at one signature: FLOPs, HBM bytes, collective bytes, expected
h2d/d2h bytes), :class:`OperatorCost` (every priced unit of one operator
plus its predicted signature ladder) and :class:`CostTable` (the export
for one plan), with the same JSON form, so a table written by either
package loads in the other.  ``metrics/roofline.py`` joins a table
against measured step times.

The pricer (the reference walks jaxprs; here it would walk the torch
modules) is not ported: a ``RooflineConfig`` without a ``cost_table``
runs the fail-soft path, and a table comes only from JSON
(``CostTable.from_json``) or is built by hand.
"""

from __future__ import annotations

import dataclasses
import typing


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
