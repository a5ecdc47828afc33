"""Build a pipeline's plan WITHOUT executing it.

Port of ``flink_tensorflow_tpu/analysis/capture.py`` over the port's
``StreamExecutionEnvironment``.

Example jobs (and most real pipelines) construct their graph and then
call ``env.execute(...)`` in one main().  To analyze the plan the CLI
runs the job's main with ``execute``/``execute_async`` patched to raise
:class:`PlanCaptured` carrying the environment — graph construction
(including model setup on the host) runs normally, stream execution
never starts, and post-execute code (result assertions) is skipped.
"""

from __future__ import annotations

import contextlib
import importlib.util
import pathlib
import sys
import typing

from flink_tensorflow_tpu_torch.core.environment import StreamExecutionEnvironment


class PlanCaptured(BaseException):
    """Control-flow signal, not an error — derives from BaseException so
    job code's ``except Exception`` cleanup cannot swallow it."""

    def __init__(self, env: StreamExecutionEnvironment):
        self.env = env
        super().__init__("plan captured; execution skipped")


@contextlib.contextmanager
def capturing_execution() -> typing.Iterator[None]:
    """Patch StreamExecutionEnvironment so any execute() raises
    :class:`PlanCaptured` with the environment."""

    def _capture(self, *args, **kwargs):
        raise PlanCaptured(self)

    saved = (StreamExecutionEnvironment.execute,
             StreamExecutionEnvironment.execute_async)
    StreamExecutionEnvironment.execute = _capture
    StreamExecutionEnvironment.execute_async = _capture
    try:
        yield
    finally:
        (StreamExecutionEnvironment.execute,
         StreamExecutionEnvironment.execute_async) = saved


def capture_plan(
    job: typing.Callable[[], typing.Any],
) -> StreamExecutionEnvironment:
    """Run ``job()`` under capture; returns the environment whose
    execute() it reached.  Raises RuntimeError if it never executed."""
    with capturing_execution():
        try:
            job()
        except PlanCaptured as captured:
            return captured.env
    raise RuntimeError(
        "pipeline returned without calling execute()/execute_async() — "
        "no plan to analyze"
    )


def capture_pipeline_file(
    path: str, job_args: typing.Sequence[str] = ("--smoke", "--cpu")
) -> StreamExecutionEnvironment:
    """Import a pipeline script by path and capture the plan its
    ``main(argv)`` builds.

    The script's directory's parent is put on sys.path (examples import
    ``examples._common``), and ``main`` is called with ``job_args``
    (defaults to the CI-safe smoke/cpu flags).
    """
    script = pathlib.Path(path).resolve()
    if not script.exists():
        raise FileNotFoundError(str(script))
    for entry in (str(script.parent.parent), str(script.parent)):
        if entry not in sys.path:
            sys.path.insert(0, entry)
    mod_name = f"_ftt_analysis_{script.stem}"
    spec = importlib.util.spec_from_file_location(mod_name, script)
    module = importlib.util.module_from_spec(spec)
    # Register before exec so decorators/dataclasses inside resolve.
    sys.modules[mod_name] = module
    try:
        with capturing_execution():
            try:
                spec.loader.exec_module(module)
                main = getattr(module, "main", None)
                if main is None:
                    raise RuntimeError(
                        f"{script} defines no main(argv) entry point"
                    )
                main(list(job_args))
            except PlanCaptured as captured:
                return captured.env
    finally:
        sys.modules.pop(mod_name, None)
    raise RuntimeError(
        f"{script} never called execute()/execute_async() — no plan to analyze"
    )
