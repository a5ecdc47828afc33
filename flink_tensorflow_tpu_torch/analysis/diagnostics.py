"""Diagnostics — the analyzer's output vocabulary.

Copy of ``flink_tensorflow_tpu/analysis/diagnostics.py``.

A :class:`Diagnostic` pins one finding to a node and (when the finding
is about a connection rather than an operator) to the exact edge it
occurred on, spelled ``upstream -> downstream``.  Severity drives the
gates: ``execute(validate=True)`` and the CLI fail only on ERROR;
WARN/INFO are advisory.
"""

from __future__ import annotations

import dataclasses
import enum
import typing


class Severity(enum.IntEnum):
    INFO = 0
    WARN = 1
    ERROR = 2


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One analyzer finding."""

    rule: str
    severity: Severity
    message: str
    #: Transformation the finding is attached to.
    node: typing.Optional[str] = None
    #: Edge-level provenance, ``"upstream -> downstream"`` — set when the
    #: finding is about what flows BETWEEN two operators.
    edge: typing.Optional[str] = None

    def format(self) -> str:
        loc = self.edge or self.node or "<graph>"
        return f"{self.severity.name:5s} [{self.rule}] {loc}: {self.message}"


def edge_name(upstream_name: str, downstream_name: str) -> str:
    """Canonical edge spelling shared by diagnostics and tests."""
    return f"{upstream_name} -> {downstream_name}"


def format_diagnostics(diagnostics: typing.Sequence[Diagnostic]) -> str:
    if not diagnostics:
        return "no diagnostics"
    return "\n".join(d.format() for d in diagnostics)


def worst_severity(
    diagnostics: typing.Sequence[Diagnostic],
) -> typing.Optional[Severity]:
    return max((d.severity for d in diagnostics), default=None)


class PlanValidationError(RuntimeError):
    """Raised by ``execute(validate=True)`` when the plan has ERROR
    diagnostics — the job never reaches the executor."""

    def __init__(self, diagnostics: typing.Sequence[Diagnostic]):
        self.diagnostics = list(diagnostics)
        errors = [d for d in self.diagnostics if d.severity == Severity.ERROR]
        super().__init__(
            f"plan validation failed with {len(errors)} error(s):\n"
            + format_diagnostics(self.diagnostics)
        )
