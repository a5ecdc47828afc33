"""Plan-time passes over the dataflow graph.

Port of ``flink_tensorflow_tpu/analysis/__init__.py``: operator chaining
(``chaining``), the plan analyzer (schema propagation, the lint registry
and its 33 rules; ``analyze``), plan capture, the replay-purity scanner,
the cost model (``costmodel``), and the two audits whose families ride
the registry: ``shardcheck`` (layout, donation, device-memory budget,
launch signatures) and ``statecheck`` (hidden state, train state,
rescale safety, RNG streams, the exactly-once dataflow pass).  Three
front doors run the analyzer before a record is emitted or a device is
touched:

- ``analyze(graph, config=...) -> list[Diagnostic]``
- ``env.execute(..., validate=True)`` (raises PlanValidationError on ERROR)
- ``python -m flink_tensorflow_tpu_torch.analysis <pipeline>.py``
  (and ``.analysis.shardcheck`` / ``.analysis.statecheck`` for the two
  audits' JSON reports)

The exports are the reference's.  Names resolve at first use, so ``core.environment`` can import
``analysis.chaining`` while this package's capture imports the
environment.
"""

import importlib

_EXPORTS = {
    "analyze": "analyzer", "has_errors": "analyzer",
    "ChainPlan": "chaining", "chainable_edge": "chaining", "compute_chains": "chaining",
    "sharding_axes_of": "chaining", "sharding_fusion_conflict": "chaining",
    "PlanCaptured": "capture", "capture_pipeline_file": "capture", "capture_plan": "capture",
    "capturing_execution": "capture",
    "Diagnostic": "diagnostics", "PlanValidationError": "diagnostics",
    "Severity": "diagnostics", "edge_name": "diagnostics",
    "format_diagnostics": "diagnostics", "worst_severity": "diagnostics",
    "RULES": "rules", "AnalysisContext": "rules", "LintRule": "rules", "rule": "rules",
    "PurityFinding": "sanitizer", "scan_callable": "sanitizer", "scan_code": "sanitizer",
    "scan_operator": "sanitizer",
    "SchemaFlow": "schema_prop", "propagate": "schema_prop",
    "OpAudit": "shardcheck", "PlanAudit": "shardcheck", "SpecLayout": "shardcheck",
    "audit_of": "shardcheck", "audit_plan": "shardcheck", "report_for_env": "shardcheck",
    "OpStateAudit": "statecheck", "PlanStateAudit": "statecheck",
}

#: The reference's ``statecheck_*`` aliases of statecheck's front doors.
_ALIASES = {
    "statecheck_audit_of": ("statecheck", "audit_of"),
    "statecheck_audit_plan": ("statecheck", "audit_plan"),
    "statecheck_report_for_env": ("statecheck", "report_for_env"),
}

__all__ = sorted([*_EXPORTS, *_ALIASES])


def __getattr__(name):
    module, attr = _ALIASES.get(name, (_EXPORTS.get(name), name))
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), attr)
