"""The checkpoint coordinator's deadline sweeper, held to the JAX
package's (``core/checkpoint.py:262-318``, ``core/runtime.py:1501``).

- The coordinators alone, on one schedule of registrations and acks
  (stub executors): the same ids are aborted and announced, the same
  ones complete, a late ack of an aborted id is dropped, and an aborted
  id is never registered again.
- The same job through both packages: ``GeneratorSource -> map(stall)
  -> map -> sink`` at parallelism 1, unchained, count-based checkpoints
  every 10 records.  The stall map blocks at record 25 and the source at
  record 30 until the coordinator has aborted a checkpoint, so
  checkpoint 3 (cut after record 29, stuck behind the stall) is the one
  that misses the deadline in either package, whatever the host's
  speed; checkpoints 1-2 complete before it and 4-6 after it.  Every
  record comes out once, checkpoint 3 is not on disk and a later one is,
  and the sweeper thread is gone when the job ends.
"""

import dataclasses
import threading
import time

import pytest

from flink_tensorflow_tpu import StreamExecutionEnvironment as JaxEnv
from flink_tensorflow_tpu.checkpoint.store import checkpoint_ids as jax_checkpoint_ids
from flink_tensorflow_tpu.core import functions as jax_fn
from flink_tensorflow_tpu.core.checkpoint import CheckpointCoordinator as JaxCoordinator
from flink_tensorflow_tpu.io.sources import GeneratorSource as JaxGeneratorSource
from flink_tensorflow_tpu.metrics.registry import MetricRegistry as JaxMetricRegistry
from flink_tensorflow_tpu_torch.checkpoint.store import checkpoint_ids
from flink_tensorflow_tpu_torch.core import functions as port_fn
from flink_tensorflow_tpu_torch.core.checkpoint import CheckpointCoordinator
from flink_tensorflow_tpu_torch.core.environment import StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.io.sources import GeneratorSource
from flink_tensorflow_tpu_torch.metrics.registry import MetricRegistry

TIMEOUT_S = 1.0
WAIT_S = 20.0


class StubExecutor:
    """The executor protocol both coordinators read, with two subtasks."""

    def __init__(self, registry):
        self.metrics = registry
        self.checkpoint_every_n = 10
        self.checkpoint_timeout_s = TIMEOUT_S
        self.checkpoint_retain_last = None
        self.max_parallelism = 128
        self.total_subtasks = 2
        self.subtasks = []
        self.cancelled = threading.Event()
        self.all_done = self._all_done = threading.Event()
        self.completed, self.aborted = [], []

    def notify_checkpoint_complete(self, cid):
        self.completed.append(cid)

    def notify_checkpoint_aborted(self, cid):
        self.aborted.append(cid)


def wait_for(cond, what):
    deadline = time.monotonic() + WAIT_S
    while not cond():
        if time.monotonic() > deadline:
            pytest.fail(f"timed out waiting for {what}")
        time.sleep(0.01)


def run_schedule(coordinator_cls, registry):
    ex = StubExecutor(registry)
    coord = coordinator_cls(ex)
    assert coord.begin_source_checkpoint(1)
    coord.ack(1, "a", 0, {"x": 1})
    coord.ack(1, "b", 0, {"x": 1})
    assert coord.begin_source_checkpoint(2)
    coord.ack(2, "a", 0, {"x": 2})            # "b" never acks 2
    wait_for(lambda: coord.aborted_ids, "the sweeper")
    coord.ack(2, "b", 0, {"x": 2})            # late: dropped
    assert coord.begin_source_checkpoint(3)
    assert not coord.begin_source_checkpoint(2)
    coord.ack(3, "a", 0, {"x": 3})
    coord.ack(3, "b", 0, {"x": 3})
    assert coord.wait_for_persistence(WAIT_S) == 0
    ex.all_done.set()
    thread = coord._abort_thread
    thread.join(WAIT_S)
    assert not thread.is_alive()
    return {"aborted_ids": list(coord.aborted_ids), "announced": ex.aborted,
            "completed": ex.completed,
            "gauge": ex.metrics.report()["recovery.checkpoints_aborted"]}


def test_the_coordinators_abort_the_same_ids_on_one_schedule():
    got = run_schedule(CheckpointCoordinator, MetricRegistry())
    want = run_schedule(JaxCoordinator, JaxMetricRegistry())
    assert got == want
    assert got == {"aborted_ids": [2], "announced": [2], "completed": [1, 3], "gauge": 1}


def _wait_aborted(holder):
    wait_for(lambda: holder.get("coord") is not None and holder["coord"].aborted_ids,
             "a checkpoint abort")


def stalled_job(pkg, tmp_path):
    """The module docstring's job through ``pkg`` ("port" or "jax"):
    ``(records out, aborted ids, checkpoint ids on disk, sweeper thread)``."""
    holder = {}

    def records(index, parallelism):
        for i in range(60):
            if i == 30:
                _wait_aborted(holder)
            yield i

    fn = port_fn if pkg == "port" else jax_fn

    class StallAt(fn.MapFunction):
        def map(self, value):
            if value == 25:
                _wait_aborted(holder)
            return value

    Env, Source = ((StreamExecutionEnvironment, GeneratorSource) if pkg == "port"
                   else (JaxEnv, JaxGeneratorSource))
    chk = str(tmp_path / f"chk-{pkg}")
    env = Env(parallelism=1)
    env.enable_checkpointing(chk, every_n_records=10)
    env.configure(chaining=False, checkpoint=dataclasses.replace(env.config.checkpoint,
                                                                 timeout_s=TIMEOUT_S))
    out = (env.from_source(Source(records), name="src")
           .map(StallAt(), name="stall").map(lambda v: v * 10, name="scale")
           .sink_to_list())
    handle = env.execute_async("abort")
    holder["coord"] = handle.executor.coordinator
    handle.wait(60)
    ids = checkpoint_ids(chk) if pkg == "port" else jax_checkpoint_ids(chk)
    coord = handle.executor.coordinator
    return list(out), list(coord.aborted_ids), ids, coord._abort_thread


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_a_stalled_barrier_aborts_and_a_later_checkpoint_completes(tmp_path, pkg):
    out, aborted, ids, _ = stalled_job(pkg, tmp_path)
    assert sorted(out) == [10 * i for i in range(60)]
    assert aborted == [3]
    assert 3 not in ids and max(ids) > 3


def test_aborted_ids_and_checkpoints_equal_the_jax_jobs(tmp_path):
    port = stalled_job("port", tmp_path)
    jax = stalled_job("jax", tmp_path)
    assert port[1] == jax[1] == [3]
    assert port[2] == jax[2]
    assert port[0] == jax[0]


def test_the_sweeper_ends_with_the_job(tmp_path):
    *_, thread = stalled_job("port", tmp_path)
    assert thread is not None
    thread.join(WAIT_S)
    assert not thread.is_alive()


def test_the_sweeper_ends_when_the_job_is_cancelled(tmp_path):
    """A job cancelled mid-stream: the sweeper sees the cancel and ends."""
    gate = threading.Event()

    def records(index, parallelism):
        for i in range(1000):
            if i == 20:
                gate.wait(WAIT_S)
            yield i

    env = StreamExecutionEnvironment(parallelism=1)
    env.enable_checkpointing(str(tmp_path / "chk"), every_n_records=10)
    env.from_source(GeneratorSource(records)).map(lambda v: v).sink_to_list()
    handle = env.execute_async("cancelled")
    coord = handle.executor.coordinator
    wait_for(lambda: coord._abort_thread is not None, "the sweeper to start")
    handle.cancel()
    gate.set()
    coord._abort_thread.join(WAIT_S)
    assert not coord._abort_thread.is_alive()
