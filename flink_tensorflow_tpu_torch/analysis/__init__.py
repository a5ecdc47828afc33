"""Plan-time passes over the dataflow graph.

Port of ``flink_tensorflow_tpu/analysis/__init__.py``: operator chaining
(``chaining``), the plan analyzer (schema propagation, the lint registry
and its 21 rules; ``analyze``), plan capture, the replay-purity scanner
and the cost model (``costmodel``).  Three front doors run the analyzer
before a record is emitted or a device is touched:

- ``analyze(graph, config=...) -> list[Diagnostic]``
- ``env.execute(..., validate=True)`` (raises PlanValidationError on ERROR)
- ``python -m flink_tensorflow_tpu_torch.analysis <pipeline>.py``

The reference's shardcheck and statecheck exports are not here yet.
Names resolve at first use, so ``core.environment`` can import
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
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
