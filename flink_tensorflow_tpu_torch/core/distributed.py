"""Distributed job execution — one job graph across a process cohort.

Port of ``flink_tensorflow_tpu/core/distributed.py``.  The reference
runs on Flink's cluster: operator subtasks spread over TaskManagers, and
keyed and rebalance edges span them through the network shuffle with
checkpoint barriers flowing through the channels.
:class:`DistributedExecutor` is that for the port:

- Every process of the cohort builds the identical ``DataflowGraph`` and
  runs only the subtasks placed on it: subtask ``i`` on process
  ``i % num_processes`` (:func:`process_of_subtask`).
- An edge whose ends land on different processes becomes a
  :class:`~flink_tensorflow_tpu_torch.core.shuffle.RemoteChannelWriter`
  into the peer's
  :class:`~flink_tensorflow_tpu_torch.core.shuffle.ShuffleServer`.
  Records, watermarks, barriers and end-of-partition all cross it, so
  barrier alignment works as in one process.
- Each process persists a shard holding its subtasks' state under the
  shared checkpoint id.  Barrier ids come from count-based triggers at
  the sources and reach peers through the channels (the coordinator's
  ``lazy_register``).  A 2PC sink promotes only after every participating
  process announced its shard durable over the control channel
  (:meth:`DistributedExecutor._global_commit_gate`).
- A peer that dies fails the job: a connection that ends before
  end-of-partition reports a transport error, and with
  ``heartbeat_timeout_s`` a peer silent past it raises
  :class:`CohortPeerLost`.  A cohort supervisor restarts the cohort from
  its newest common checkpoint.

Restore (``core/environment.py``): a same-shape cohort restores each
process from its own shard; a changed shape merges every shard and
redistributes keyed state by key group.  A gang operator whose
parallelism equals ``num_processes`` gets one subtask per process, the
layout its collective step needs.  Gradients never touch this plane.

Not started until its slice (``ROADMAP.md`` item 4): the cohort
telemetry service (clock sync and metric pushes to process 0).
``DistributedConfig.telemetry_interval_s`` is kept and validated for it.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
import typing

from flink_tensorflow_tpu_torch.core.graph import DataflowGraph, Transformation
from flink_tensorflow_tpu_torch.core.runtime import LocalExecutor
from flink_tensorflow_tpu_torch.core.shuffle import RemoteChannelWriter, ShuffleServer
from flink_tensorflow_tpu_torch.metrics.registry import MetricRegistry

logger = logging.getLogger(__name__)


class CohortPeerLost(ConnectionError):
    """A cohort peer stopped heartbeating (or never started): the job
    fails fast so the supervisor's restart takes over."""


@dataclasses.dataclass(frozen=True)
class DistributedConfig:
    """Cohort membership and record-plane endpoints of one process.

    ``peers[p]`` is the ``"host:port"`` shuffle endpoint of process ``p``;
    every process gets the same list and its own index."""

    process_index: int
    num_processes: int
    peers: typing.Tuple[str, ...]
    #: Interface the shuffle server binds (the advertised address stays
    #: ``peers[process_index]``).
    bind: str = "0.0.0.0"
    connect_timeout_s: float = 60.0
    #: Cadence of the cohort telemetry service (not started by the port
    #: yet: ``ROADMAP.md`` item 4).  0 disables it.
    telemetry_interval_s: float = 2.0
    #: The cohort's restart epoch; the supervisor's attempt.  It rides every
    #: handshake: a server of epoch E drops all frames of senders of an
    #: older epoch, so a dying process of the previous attempt cannot
    #: corrupt the restored run's stream or its commit gate.
    restart_epoch: int = 0
    #: Every process heartbeats every peer on the control channel, and a
    #: peer silent longer than this fails the job (CohortPeerLost): the
    #: hung peer that no socket error reports.  0 disables heartbeats.
    heartbeat_timeout_s: float = 0.0

    def validate(self) -> "DistributedConfig":
        if self.num_processes < 1:
            raise ValueError(f"num_processes must be >= 1, got {self.num_processes}")
        if not 0 <= self.process_index < self.num_processes:
            raise ValueError(f"process_index {self.process_index} out of range "
                             f"[0, {self.num_processes})")
        if len(self.peers) != self.num_processes:
            raise ValueError(f"peers has {len(self.peers)} entries for "
                             f"{self.num_processes} processes")
        for peer in self.peers:
            host, _, port = peer.rpartition(":")
            if not host or not port.isdigit():
                raise ValueError(f"peer {peer!r} is not 'host:port'")
        if self.connect_timeout_s <= 0:
            raise ValueError("connect_timeout_s must be > 0")
        if self.telemetry_interval_s < 0:
            raise ValueError("telemetry_interval_s must be >= 0")
        if self.restart_epoch < 0:
            raise ValueError("restart_epoch must be >= 0")
        if self.heartbeat_timeout_s < 0:
            raise ValueError("heartbeat_timeout_s must be >= 0")
        return self

    def endpoint(self, process_index: int) -> typing.Tuple[str, int]:
        host, _, port = self.peers[process_index].rpartition(":")
        return host, int(port)

    def process_checkpoint_dir(self, base: str,
                               process_index: typing.Optional[int] = None) -> str:
        """The process's shard directory under a (possibly shared) base:
        without it, each process's ``write_checkpoint`` would replace its
        peers' shards of the same id."""
        idx = self.process_index if process_index is None else process_index
        return os.path.join(base, f"proc-{idx:05d}")


def process_of_subtask(subtask_index: int, num_processes: int) -> int:
    """Placement: subtask i -> process i % P, the same on every process; a
    gang operator at parallelism P gets one subtask per process."""
    return subtask_index % num_processes


class DistributedExecutor(LocalExecutor):
    """A LocalExecutor whose plan spans a process cohort through the
    record plane."""

    def __init__(self, graph: DataflowGraph, *, distributed: DistributedConfig, **kwargs):
        self.dist = distributed.validate()
        # Checked before the bind: a raise after it would leak the listener.
        if kwargs.get("checkpoint_every_n") is None and kwargs.get("checkpoint_dir") is not None:
            raise ValueError(
                "distributed checkpointing requires count-based triggers "
                "(checkpoint.every_n_records): barrier ids must be a "
                "deterministic function of the stream so every process "
                "cuts the same snapshot")
        # One registry for the server's ingress counters and the executor.
        if kwargs.get("metric_registry") is None:
            kwargs["metric_registry"] = MetricRegistry()
        kwargs["restart_epoch"] = max(kwargs.get("restart_epoch", 0), self.dist.restart_epoch)
        _, my_port = self.dist.endpoint(self.dist.process_index)
        self._server = ShuffleServer(self.dist.bind, my_port, on_error=self._transport_error,
                                     on_control=self._on_control,
                                     metrics=kwargs["metric_registry"],
                                     epoch=self.dist.restart_epoch)
        self._remote_writers: typing.List[RemoteChannelWriter] = []
        #: Checkpoint id -> processes that announced their shard durable.
        self._durable_acks: typing.Dict[int, typing.Set[int]] = {}
        self._durable_cv = threading.Condition()
        #: Control writers to peers, made on first use and shared by the
        #: commit gate and the heartbeat thread.
        self._control_writers: typing.Dict[int, RemoteChannelWriter] = {}
        self._control_writers_lock = threading.Lock()
        #: Set once an announcement reached every peer: from then on the
        #: gate may cap its connect (the first gate can race a peer's slow
        #: start, and a capped connect would fail it spuriously).
        self._gate_warmed = False
        #: Peer index -> monotonic time of its last control frame
        #: (reactor writes, heartbeat thread reads).
        self._peer_last_seen: typing.Dict[int, float] = {}
        self._hb_stop = threading.Event()
        self._hb_thread: typing.Optional[threading.Thread] = None
        try:
            super().__init__(graph, **kwargs)
        except BaseException:
            self._server.close(join=False)
            raise
        self.coordinator.lazy_register = True
        self.coordinator.commit_gate = self._global_commit_gate
        #: Processes owning at least one subtask (p owns subtask p of any
        #: transformation with parallelism > p): a commit waits for these.
        max_par = max((t.parallelism for t in graph.transformations), default=0)
        self._participants = frozenset(p for p in range(self.dist.num_processes) if p < max_par)
        # The cohort shape in every shard: restore checks the shard set
        # against it (a missing shard is a loud error, never a silent
        # parallelism change), and a same-shape restore skips the merge.
        self.coordinator.job_meta_extra = {
            "num_processes": self.dist.num_processes,
            "process_index": self.dist.process_index,
            "participants": sorted(self._participants),
            "task_parallelism": {t.name: t.parallelism for t in graph.transformations},
        }
        for st in self.subtasks:
            if st.gate is not None:
                self._server.register_gate(st.t.name, st.index, st.gate)
        self._server.start()
        if self.dist.heartbeat_timeout_s > 0 and self.dist.num_processes > 1:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop,
                name=f"cohort-heartbeat:{self.dist.process_index}", daemon=True)
            self._hb_thread.start()

    # -- placement -------------------------------------------------------------------
    def _owns_subtask(self, t: Transformation, index: int) -> bool:
        return process_of_subtask(index, self.dist.num_processes) == self.dist.process_index

    def _process_identity(self) -> typing.Tuple[int, int]:
        return self.dist.process_index, self.dist.num_processes

    def _remote_writer(self, t: Transformation, subtask_index: int, channel_idx: int):
        host, port = self.dist.endpoint(process_of_subtask(subtask_index,
                                                           self.dist.num_processes))
        writer = RemoteChannelWriter(
            host, port, t.name, subtask_index, channel_idx,
            connect_timeout_s=self.dist.connect_timeout_s, metrics=self.metrics,
            flush_bytes=self.wire_flush_bytes, flush_ms=self.wire_flush_ms,
            wire_dtype=self.wire_dtype, reactor=self._server.reactor, shm=self.shm_channels,
            epoch=self.dist.restart_epoch,
            # Data edges take credits; control writers never do (2PC
            # announcements must not park behind data).
            flow_control=self.flow_control)
        self._remote_writers.append(writer)
        return writer

    # -- control channel ---------------------------------------------------------
    def _on_control(self, sender: int, message: typing.Any) -> None:
        # Any control frame proves the peer alive.
        self._peer_last_seen[sender] = time.monotonic()
        kind = message[0]
        if kind == "hb":
            return
        if kind == "ckpt_durable":
            with self._durable_cv:
                self._durable_acks.setdefault(message[1], set()).add(sender)
                self._durable_cv.notify_all()
            return
        logger.warning("unknown control message %r from %d", kind, sender)

    def _get_control_writer(self, peer: int,
                            timeout_s: typing.Optional[float] = None) -> RemoteChannelWriter:
        """The control writer to ``peer`` (made on first use; the writer is
        thread-safe, so the gate and the heartbeat share one)."""
        with self._control_writers_lock:
            writer = self._control_writers.get(peer)
            if writer is None:
                host, port = self.dist.endpoint(peer)
                writer = RemoteChannelWriter(
                    host, port, ShuffleServer.CONTROL_TASK, self.dist.process_index, 0,
                    connect_timeout_s=(self.dist.connect_timeout_s if timeout_s is None
                                       else timeout_s),
                    epoch=self.dist.restart_epoch)
                self._control_writers[peer] = writer
            return writer

    # -- heartbeats ----------------------------------------------------------------
    def _heartbeat_loop(self) -> None:
        """Beat every peer each interval; fail the job when a peer has been
        silent past the timeout (the hung peer whose sockets stay open)."""
        timeout = self.dist.heartbeat_timeout_s
        interval = max(0.02, timeout / 3.0)
        me = self.dist.process_index
        peers = [p for p in range(self.dist.num_processes) if p != me]
        beat = ("hb", me, self.dist.restart_epoch)
        # Startup order is uncoordinated: a peer gets the connect window
        # before its first frame is due.
        grace = time.monotonic() + self.dist.connect_timeout_s + timeout
        while not self._hb_stop.wait(interval):
            if self.cancelled.is_set():
                return
            # Staleness first: a beat to a dead peer can block in the
            # writer's reconnect budget.
            now = time.monotonic()
            for p in peers:
                last = self._peer_last_seen.get(p)
                if last is None:
                    if now < grace:
                        continue
                    silent = now - (grace - timeout)
                elif now - last <= timeout:
                    continue
                else:
                    silent = now - last
                self._transport_error(CohortPeerLost(
                    f"cohort peer {p} silent for {silent:.1f}s (heartbeat_timeout_s="
                    f"{timeout}) — failing fast so the supervisor restarts the cohort "
                    "from the last complete checkpoint"))
                return
            for p in peers:
                try:
                    self._get_control_writer(p, timeout_s=timeout).write(beat)
                except Exception:  # noqa: BLE001 - the staleness check decides
                    logger.debug("heartbeat to peer %d failed", p, exc_info=True)

    # -- the global 2PC commit point -----------------------------------------------
    def _global_commit_gate(self, checkpoint_id: int) -> bool:
        """After the local shard of ``checkpoint_id`` is durable: announce
        it to the cohort and wait until every participating process has
        announced the same.  Only then may 2PC sinks promote (a commit bound
        to a checkpoint some peer never cut would be rewound by the
        cohort's restore).  False (the commit signal withheld) on timeout,
        cancellation or peer loss; staged transactions then promote with a
        later checkpoint, at a clean finish, or at restore."""
        me = self.dist.process_index
        announcement = ("ckpt_durable", checkpoint_id, me)
        for p in sorted(self._participants - {me}):
            # A peer death cancels the job concurrently: check between
            # announcements, not only after a connect timeout.
            if self.cancelled.is_set():
                return False
            timeout_s = (min(5.0, self.dist.connect_timeout_s) if self._gate_warmed
                         else self.dist.connect_timeout_s)
            try:
                self._get_control_writer(p, timeout_s).write(announcement)
            except (OSError, TimeoutError):
                logger.warning("could not announce checkpoint %d durability to peer %d",
                               checkpoint_id, p, exc_info=True)
                return False
        self._gate_warmed = True
        deadline = time.monotonic() + self.checkpoint_timeout_s
        with self._durable_cv:
            try:
                self._durable_acks.setdefault(checkpoint_id, set()).add(me)
                while not self._participants <= self._durable_acks[checkpoint_id]:
                    if self.cancelled.is_set():
                        return False
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        logger.warning(
                            "checkpoint %d not globally durable within %.0fs (have %s of %s) "
                            "— withholding the 2PC commit signal", checkpoint_id,
                            self.checkpoint_timeout_s, sorted(self._durable_acks[checkpoint_id]),
                            sorted(self._participants))
                        return False
                    self._durable_cv.wait(timeout=min(0.2, remaining))
            finally:
                # Gates run in id order: entries up to this id are dead.
                for cid in [c for c in self._durable_acks if c <= checkpoint_id]:
                    del self._durable_acks[cid]
        return True

    # -- failure and teardown ----------------------------------------------------
    def _transport_error(self, exc: BaseException) -> None:
        """A peer connection died before end-of-partition (or a peer went
        silent): fail the job."""
        with self._error_lock:
            if self._error is None:
                self._error = exc
        logger.error("record-plane transport failed", exc_info=exc)
        self.cancel()

    def _close_plane(self, join: bool) -> None:
        self._hb_stop.set()
        for w in list(self._remote_writers):
            w.close()
        for w in list(self._control_writers.values()):
            w.close()
        self._server.close(join=join)

    def cancel(self) -> None:
        super().cancel()
        # Unblock writers in a send, and the persist thread in the gate.
        # join=False: cancel may run on the reactor (via _transport_error).
        if hasattr(self, "_server"):
            self._close_plane(join=False)
        with self._durable_cv:
            self._durable_cv.notify_all()

    def join(self, timeout: typing.Optional[float] = None) -> None:
        try:
            super().join(timeout)
        finally:
            self._close_plane(join=True)
