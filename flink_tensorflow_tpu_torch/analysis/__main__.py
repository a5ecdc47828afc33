"""CLI: analyze pipeline scripts without executing them.

Port of ``flink_tensorflow_tpu/analysis/__main__.py``::

    python -m flink_tensorflow_tpu_torch.analysis pipeline.py [more.py ...] [--json]

Builds each script's DataflowGraph (its ``main(argv)`` runs under
execute-capture, ``analysis/capture.py``, so the stream job never
starts), runs the plan analyzer, and prints diagnostics with edge-level
provenance.  Exit code 0 = no ERROR diagnostics anywhere, 1 = at least
one ERROR, 2 = a script could not be captured at all.
"""

from __future__ import annotations

import argparse
import json
import sys

from flink_tensorflow_tpu_torch.analysis.analyzer import analyze, has_errors
from flink_tensorflow_tpu_torch.analysis.capture import capture_pipeline_file
from flink_tensorflow_tpu_torch.analysis.chaining import compute_chains
from flink_tensorflow_tpu_torch.analysis.diagnostics import format_diagnostics


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m flink_tensorflow_tpu_torch.analysis",
        description="Plan-time analyzer: schema propagation + graph lints "
                    "over a pipeline script's DataflowGraph, without "
                    "executing the job.",
    )
    parser.add_argument("pipelines", nargs="+", metavar="pipeline.py",
                        help="pipeline script(s) defining main(argv)")
    parser.add_argument("--job-args", default="--smoke --cpu",
                        help="argv passed to each pipeline's main() while "
                             "building its graph (default: '--smoke --cpu')")
    parser.add_argument("--json", action="store_true",
                        help="emit one JSON object per pipeline")
    args = parser.parse_args(argv)

    job_args = args.job_args.split()
    exit_code = 0
    for path in args.pipelines:
        try:
            env = capture_pipeline_file(path, job_args)
        except Exception as ex:  # noqa: BLE001 - report and keep going
            print(f"{path}: capture failed: {ex}", file=sys.stderr)
            exit_code = max(exit_code, 2)
            continue
        diags = analyze(env.graph, config=env.config)
        plan = compute_chains(env.graph, enabled=env.config.chaining)
        if args.json:
            print(json.dumps({
                "pipeline": path,
                "operators": len(env.graph.transformations),
                "chains": plan.names(),
                "chained_edges": plan.chained_edge_count,
                "diagnostics": [
                    {"rule": d.rule, "severity": d.severity.name,
                     "message": d.message, "node": d.node, "edge": d.edge}
                    for d in diags
                ],
            }))
        else:
            n = len(env.graph.transformations)
            print(f"== {path} ({n} operators, {len(plan.chains)} chain(s)) ==")
            print(plan.describe())
            print(format_diagnostics(diags))
        if has_errors(diags):
            exit_code = max(exit_code, 1)
    return exit_code


if __name__ == "__main__":
    sys.exit(main())
