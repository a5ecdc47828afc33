"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names; the references import nothing of the program."""

import ast
import os
import subprocess
import sys

from benchmark import run
from benchmark.tests.tiny import BENCH, ROOT


def test_forbidden_names_are_compared_whole():
    assert run.forbidden_modules(["flink_tensorflow_tpu_torch", "flink_tensorflow_tpu_torch.core",
                                  "jax_like", "jaxtyping", "numpy"]) == []
    assert run.forbidden_modules(["flink_tensorflow_tpu.core.stream", "jaxlib.xla_client",
                                  "jax", "flax.linen", "optax"]) == [
        "flax", "flink_tensorflow_tpu", "jax", "jaxlib", "optax"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_name_no_forbidden_module_and_references_nothing_of_the_program():
    for base, _, files in os.walk(BENCH):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(base, name)
            tops = {m.split(".")[0] for m in _imports(path)}
            assert not tops & set(run.FORBIDDEN), path
            if os.sep + "reference" in path:
                assert "flink_tensorflow_tpu_torch" not in tops, path


_PROBE = """
import sys
sys.modules["flink_tensorflow_tpu_torch"] = None   # any import of the program fails
import benchmark.reference.inception_v3, benchmark.reference.resnet50
import benchmark.reference.count, benchmark.reference.arith
del sys.modules["flink_tensorflow_tpu_torch"]
import benchmark.run, benchmark.jobs, benchmark.control, benchmark.check
import benchmark.kinds.stream, benchmark.kinds.train
print(sorted({m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "flax", "optax",
                                                       "flink_tensorflow_tpu"}))
"""


def test_harness_loads_no_jax_and_references_load_without_the_program():
    env = {**os.environ, "PYTHONPATH": ROOT}
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_checkout_holding_only_the_benchmark_fails_without_a_result(tmp_path):
    """Without the program beside it (only ``BENCHMARK.json`` and the
    benchmark's folder), a run exits non-zero and prints no result."""
    import shutil

    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "resnet50-train",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300)
    assert out.returncode != 0 and '"correct"' not in out.stdout
