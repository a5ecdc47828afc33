"""StreamExecutionEnvironment — job construction and execution entry point.

Port of ``flink_tensorflow_tpu/core/environment.py``:
``StreamExecutionEnvironment`` (``:153``) with ``from_collection``
(``:301``), ``enable_checkpointing`` (``:174``), ``set_device_provider``
(``:193``), ``execute`` with restore and restart (``:439-543``),
``execute_async`` (``:544``), ``set_mesh`` / ``mesh`` (``:199``,
``:268``) and ``from_source`` over a ``SplitSource`` (``:313-332``); ``RestartStrategy`` (``:33``), ``JobHandle``
(``:69``) and ``JobResult`` (``:27``).  The job builds a graph;
``execute()`` runs it on the local executor (``:416``), one thread per
chain of fused operators (``JobConfig.chaining``), and ``describe()``
prints the chain plan.

A process cohort (``set_distributed``, JAX ``:344``): the executor is a
``core.distributed.DistributedExecutor`` (``:431-436``), checkpoints go
to a per-process shard under the shared directory (``:373-377``), a
``restart_strategy`` is refused (``:481-511``: each process would pick
its own restore point) and a restore takes the cohort's shard set
(``:552-620``): a same-shape cohort restores each process from its own
shard, an idle process of the same shape from the job record alone, and
a changed shape merges every shard and redistributes keyed state by key
group.

Devices: a model subtask runs on what the device provider returns for
``(task_name, subtask_index)``.  Without a provider it runs on
``resolve_device(None)`` — the GPU, or an error when there is none.
"""

from __future__ import annotations

import dataclasses
import random
import time
import typing

from flink_tensorflow_tpu_torch.analysis.chaining import compute_chains
from flink_tensorflow_tpu_torch.checkpoint import store
from flink_tensorflow_tpu_torch.core import functions as fn
from flink_tensorflow_tpu_torch.core.config import JobConfig
from flink_tensorflow_tpu_torch.core.graph import DataflowGraph
from flink_tensorflow_tpu_torch.core.operators import SourceOperator
from flink_tensorflow_tpu_torch.core.runtime import JobFailure, JobTimeout, LocalExecutor
from flink_tensorflow_tpu_torch.core.stream import DataStream
from flink_tensorflow_tpu_torch.io.sources import CollectionSource
from flink_tensorflow_tpu_torch.metrics.registry import MetricRegistry
from flink_tensorflow_tpu_torch.sources.api import SplitSource
from flink_tensorflow_tpu_torch.sources.operator import SplitSourceOperator


class JobResult:
    def __init__(self, metrics: typing.Dict[str, typing.Any], restarts: int = 0):
        self.metrics = metrics
        self.restarts = restarts


@dataclasses.dataclass(frozen=True)
class RestartStrategy:
    """Flink-style restart strategy: on job failure, rebuild the executor,
    restore the latest persisted snapshot and replay from the source
    offsets.  Operator and keyed state are exactly-once; sink emissions of
    replayed records are at-least-once.

    Fixed delay by default; ``backoff_multiplier > 1`` makes attempt k wait
    ``delay_s * multiplier**(k-1)``, capped at ``max_delay_s``, with a
    deterministic ``jitter`` (± fraction) per seed and attempt."""

    max_restarts: int = 3
    delay_s: float = 0.0
    backoff_multiplier: float = 1.0
    max_delay_s: float = 30.0
    jitter: float = 0.0

    def delay_for(self, attempt: int, *, seed: int = 0) -> float:
        """Seconds to wait before restart ``attempt`` (1-based)."""
        delay = self.delay_s * (self.backoff_multiplier ** max(0, attempt - 1))
        delay = min(delay, self.max_delay_s)
        if self.jitter and delay > 0:
            rng = random.Random((seed or 0) * 1000003 + attempt)
            delay *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(0.0, delay)


class JobHandle:
    """Handle to an asynchronously running job."""

    def __init__(self, executor: LocalExecutor):
        self.executor = executor

    def trigger_checkpoint(self, timeout: typing.Optional[float] = None):
        """Run one aligned checkpoint; returns the snapshot mapping.
        ``timeout`` defaults to the job's ``checkpoint.timeout_s``."""
        if timeout is None:
            timeout = self.executor.checkpoint_timeout_s
        return self.executor.coordinator.trigger(timeout=timeout)

    def wait(self, timeout: typing.Optional[float] = None) -> JobResult:
        self.executor.join(timeout)
        return JobResult(self.executor.metrics.report())

    def cancel(self) -> None:
        self.executor.cancel()
        # Completed checkpoints may still be persisting; they are valid
        # restore points, and a caller typically restores right after.
        self.executor.coordinator.wait_for_persistence(60.0)

    @property
    def metrics(self) -> MetricRegistry:
        return self.executor.metrics


class StreamExecutionEnvironment:
    def __init__(self, parallelism: int = 1, *, config: typing.Optional[JobConfig] = None):
        self.graph = DataflowGraph()
        if config is not None and parallelism != 1:
            config = dataclasses.replace(config, parallelism=parallelism)
        self.config: JobConfig = config or JobConfig(parallelism=parallelism)
        self.metric_registry = MetricRegistry()

    def configure(self, **changes) -> "StreamExecutionEnvironment":
        """Replace JobConfig fields: ``env.configure(channel_capacity=64)``."""
        self.config = dataclasses.replace(self.config, **changes)
        return self

    def enable_checkpointing(self, checkpoint_dir: str, interval_s: typing.Optional[float] = None,
                             *, every_n_records: typing.Optional[int] = None,
                             retain_last: typing.Optional[int] = None
                             ) -> "StreamExecutionEnvironment":
        """Persist aligned snapshots under ``checkpoint_dir``: every
        ``interval_s`` seconds, or at deterministic source positions every
        ``every_n_records`` records, otherwise only on
        ``trigger_checkpoint``.  ``retain_last`` keeps the newest N."""
        return self.configure(checkpoint=dataclasses.replace(
            self.config.checkpoint, dir=checkpoint_dir, interval_s=interval_s,
            every_n_records=every_n_records, retain_last=retain_last))

    def set_device_provider(self, provider: typing.Callable[[str, int], typing.Any]
                            ) -> "StreamExecutionEnvironment":
        """Assign a device per ``(task_name, subtask_index)``."""
        return self.configure(device_provider=provider)

    def set_distributed(self, distributed) -> "StreamExecutionEnvironment":
        """Join a process cohort (``core.distributed.DistributedConfig``):
        subtasks spread over it and keyed and rebalance edges span
        processes through the record plane."""
        return self.configure(distributed=distributed)

    def set_mesh(self, mesh) -> "StreamExecutionEnvironment":
        """Share a ``parallel.mesh.Mesh`` with gang operators (DP training)."""
        return self.configure(mesh=mesh)

    @property
    def mesh(self):
        return self.config.mesh

    @property
    def default_parallelism(self) -> int:
        return self.config.parallelism

    @property
    def source_throttle_s(self) -> float:
        return self.config.source_throttle_s

    @source_throttle_s.setter
    def source_throttle_s(self, v: float) -> None:
        self.configure(source_throttle_s=v)

    @property
    def checkpoint_dir(self) -> typing.Optional[str]:
        return self.config.checkpoint.dir

    def describe(self) -> str:
        """The job's chain plan as the executor will run it: one line per
        chain, ``->`` a host hop, ``=>`` a fused hop that stays on the
        device under ``device_resident``."""
        return compute_chains(self.graph, enabled=self.config.chaining).describe()

    def from_collection(self, data: typing.Sequence[typing.Any], *, name="collection",
                        parallelism: int = 1) -> DataStream:
        return self.from_source(CollectionSource(data), name=name, parallelism=parallelism)

    def from_source(self, source, *, name="source", parallelism: int = 1) -> DataStream:
        """``source`` is a :class:`SourceFunction` (a fixed stride per
        subtask, run by the legacy source loop) or a
        :class:`~flink_tensorflow_tpu_torch.sources.SplitSource` (splits
        pulled by the readers, run by the mailbox loop)."""
        if isinstance(source, SplitSource):
            factory = lambda: SplitSourceOperator(name, source)  # noqa: E731
        elif isinstance(source, fn.SourceFunction):
            factory = lambda: SourceOperator(name, source)  # noqa: E731
        else:
            raise TypeError("from_source expects a SourceFunction or SplitSource, "
                            f"got {type(source).__name__}")
        t = self.graph.add(name, factory, parallelism, is_source=True)
        return DataStream(self, t)

    def execute(self, job_name: str = "job", *,
                timeout: typing.Optional[float] = None,
                restore_from: typing.Optional[str] = None,
                restore_checkpoint_id: typing.Optional[int] = None,
                restart_strategy: typing.Optional[RestartStrategy] = None) -> JobResult:
        """Run the job to completion (``timeout`` bounds the wait).

        ``restore_from`` starts from a persisted checkpoint (the latest, or
        ``restore_checkpoint_id``).  With a ``restart_strategy`` (requires
        ``enable_checkpointing``) a failed attempt is joined — every
        subtask thread ended, every operator closed — and the job restarts
        from the newest completed checkpoint."""
        if restart_strategy is None:
            return self.execute_async(job_name, restore_from=restore_from,
                                      restore_checkpoint_id=restore_checkpoint_id).wait(timeout)
        if self.checkpoint_dir is None:
            raise ValueError("restart_strategy requires enable_checkpointing(dir)")
        if self.config.distributed is not None:
            raise ValueError(
                "restart_strategy is per-process and cannot agree on a cohort-wide "
                "restore point — supervise distributed jobs with "
                "parallel.CohortSupervisor and restore from "
                "parallel.latest_common_checkpoint(...)")
        deadline = None if timeout is None else time.monotonic() + timeout
        attempt = 0
        restore, restore_id = restore_from, restore_checkpoint_id
        recovery = self.metric_registry.group("recovery")
        restarts_total = recovery.counter("restarts_total")
        recovery_s = recovery.histogram("recovery_duration_s")
        t_fail: typing.Optional[float] = None
        while True:
            remaining = None if deadline is None else max(0.1, deadline - time.monotonic())
            try:
                handle = self.execute_async(job_name, restore_from=restore,
                                            restore_checkpoint_id=restore_id,
                                            restart_epoch=attempt)
                if t_fail is not None:
                    # The restored job's subtasks are running again.
                    recovery_s.record(time.monotonic() - t_fail)
                    t_fail = None
                result = handle.wait(remaining)
                result.restarts = attempt
                return result
            except JobTimeout:
                raise  # the job is slow, not broken: replaying won't help
            except JobFailure:
                t_fail = time.monotonic()
                # The failed attempt's executor goes now, not when the next
                # attempt's handle replaces it.
                handle = None
                attempt += 1
                if attempt > restart_strategy.max_restarts:
                    raise
                restarts_total.inc()
                delay = restart_strategy.delay_for(attempt)
                if delay:
                    time.sleep(delay)
                # Resume from the newest completed checkpoint; before the
                # first one lands, from the caller's restore point.
                new_id = store.latest_checkpoint_id(self.checkpoint_dir)
                if new_id is not None:
                    restore, restore_id = self.checkpoint_dir, new_id
                else:
                    restore, restore_id = restore_from, restore_checkpoint_id

    def _checkpoint_location(self, d: typing.Optional[str]) -> typing.Optional[str]:
        """A cohort shards one (possibly shared) checkpoint directory per
        process (``DistributedConfig.process_checkpoint_dir``)."""
        if d is not None and self.config.distributed is not None:
            return self.config.distributed.process_checkpoint_dir(d)
        return d

    def execute_async(self, job_name: str = "job", *,
                      restore_from: typing.Optional[str] = None,
                      restore_checkpoint_id: typing.Optional[int] = None,
                      restart_epoch: int = 0) -> JobHandle:
        """``restart_epoch``: which attempt of the job this run is (a
        cohort's comes from its ``DistributedConfig``)."""
        cfg = self.config.validate()
        common = dict(
            channel_capacity=cfg.channel_capacity,
            metric_registry=self.metric_registry, device_provider=cfg.device_provider,
            source_throttle_s=cfg.source_throttle_s,
            checkpoint_dir=self._checkpoint_location(cfg.checkpoint.dir),
            checkpoint_every_n=cfg.checkpoint.every_n_records,
            checkpoint_timeout_s=cfg.checkpoint.timeout_s,
            checkpoint_retain_last=cfg.checkpoint.retain_last,
            max_parallelism=cfg.max_parallelism, mesh=cfg.mesh,
            chaining=cfg.chaining, device_resident=cfg.device_resident,
            wire_dtype=cfg.wire_dtype, wire_flush_bytes=cfg.wire_flush_bytes,
            wire_flush_ms=cfg.wire_flush_ms, shm_channels=cfg.shm_channels,
            flow_control=cfg.flow_control, restart_epoch=restart_epoch)
        if cfg.distributed is not None:
            from flink_tensorflow_tpu_torch.core.distributed import DistributedExecutor

            executor = DistributedExecutor(self.graph, distributed=cfg.distributed, **common)
        else:
            executor = LocalExecutor(self.graph, **common)
        executor.checkpoint_interval_s = cfg.checkpoint.interval_s
        try:
            if restore_from is not None:
                if cfg.distributed is not None:
                    cid, snapshots, local_shard = self._read_cohort_restore(
                        restore_from, restore_checkpoint_id)
                else:
                    cid, snapshots = store.read_checkpoint(restore_from, restore_checkpoint_id)
                    local_shard = False
                executor.restore(snapshots, from_checkpoint_id=cid, local_shard=local_shard)
            executor.start()
        except BaseException:
            executor.cancel()
            raise
        return JobHandle(executor)

    def _read_cohort_restore(self, base: str, checkpoint_id: typing.Optional[int]):
        """``(id, snapshots, local_shard)`` of a cohort restore from the
        shared base: the highest id with a complete shard set (or the one
        asked for, which must be complete)."""
        dist = self.config.distributed
        cid, shard_set = store.select_cohort_checkpoint(base, checkpoint_id)
        own_dir = dist.process_checkpoint_dir(base)
        job = (store.read_shard_meta(own_dir, cid) or {}).get("job", {})
        current = {t.name: t.parallelism for t in self.graph.transformations}
        if (job.get("num_processes") == dist.num_processes
                and job.get("process_index") == dist.process_index
                and job.get("task_parallelism") == current):
            # Same cohort shape and parallelisms: the own shard holds
            # exactly this process's subtasks.
            cid, snapshots = store.read_checkpoint(own_dir, cid)
            return cid, snapshots, True
        shard_job = (store.read_shard_meta(shard_set[0], cid) or {}).get("job", {})
        if (shard_job.get("participants") is not None
                and dist.process_index not in shard_job["participants"]
                and shard_job.get("num_processes") == dist.num_processes
                and shard_job.get("task_parallelism") == current):
            # An idle process of an unchanged shape owns no subtask and
            # wrote no shard: it needs only the job record.
            return cid, {"__job__": {0: dict(shard_job)}}, True
        # The shape changed: merge every shard, so keyed state can move by
        # key group.
        cid, snapshots = store.read_cohort_checkpoint(base, cid)
        return cid, snapshots, False
