"""What the streaming-inference cells share: running a job into a timed
sink, and the steady-state rate ``bench.py`` reports.

The cells (``models/{inception,lenet,bilstm}_cell.py``) each build one
bench of the JAX package through the port; this module runs such a job
and measures it the way ``bench.py`` does (``_timed_sink`` ``:663``,
``_steady_rps`` ``:674``).
"""

from __future__ import annotations

import dataclasses
import time
import typing

from flink_tensorflow_tpu_torch.core.environment import StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.core.stream import DataStream
from flink_tensorflow_tpu_torch.tensors.value import TensorValue


@dataclasses.dataclass
class CellRun:
    """One run of a cell's job: results in sink order, their sink arrival
    times, the job's metric report, the seconds ``execute()`` took, and
    its layout: subtask threads, input gates and the chain plan."""

    results: typing.List[TensorValue]
    arrivals: typing.List[float]
    metrics: typing.Dict[str, typing.Any]
    seconds: float
    threads: int = 0
    gates: int = 0
    plan: str = ""


def run_job(records: typing.Sequence[TensorValue],
            build: typing.Callable[[DataStream], DataStream], *,
            device_provider=None, timeout: float = 600.0,
            config: typing.Optional[typing.Dict[str, typing.Any]] = None) -> CellRun:
    """``from_collection(records) -> build(stream) -> timed sink``, run
    once (sources and sink at parallelism 1); ``config`` holds
    ``JobConfig`` fields (``chaining``, ``device_resident``)."""
    env = StreamExecutionEnvironment(parallelism=1)
    env.configure(**(config or {}))
    if device_provider is not None:
        env.set_device_provider(device_provider)
    results: typing.List[TensorValue] = []
    arrivals: typing.List[float] = []

    def sink(record):
        results.append(record)
        arrivals.append(time.monotonic())

    build(env.from_collection(records, parallelism=1)).sink_to_callable(sink)
    t0 = time.monotonic()
    handle = env.execute_async()
    job = handle.wait(timeout)
    ex = handle.executor
    return CellRun(results, arrivals, job.metrics, time.monotonic() - t0,
                   len(ex.subtasks), len(ex._gates), ex.chain_plan.describe())


def steady_rps(arrivals: typing.Sequence[float], total_records: int, first_batch: int,
               trailing_exclude: int = 0) -> typing.Tuple[float, float]:
    """Steady-state records/s as ``bench.py:_steady_rps`` (``:674``)
    computes it on one chip: first sink arrival -> the last counted one,
    with the first window and the ``trailing_exclude`` records of the
    end-of-input flush burst left out.  Returns ``(rate, span seconds)``."""
    if total_records <= first_batch + trailing_exclude:
        raise ValueError("need more windows to measure steady-state throughput")
    last = len(arrivals) - 1 - trailing_exclude
    if last < 1:
        raise ValueError("arrivals shorter than the records the exclusions assume")
    span = arrivals[last] - arrivals[0]
    steady = total_records - first_batch - trailing_exclude
    return (steady / span if span > 0 else float("nan")), span
