"""Device -> host -> disk session tiering for the paged serving plane.

Port of ``flink_tensorflow_tpu/serving/tiering.py``.  The three-rung
residency ladder over one subtask's sessions:

- **hot** — a preempted session's pages stay in the device pool behind a
  :class:`~flink_tensorflow_tpu_torch.serving.paged.PagedKVHandle`:
  re-admission re-attaches the block table with no traffic.
- **warm** — pool pressure (occupancy above
  ``ServingConfig.tier_high_watermark``, or an allocation that came up
  short) demotes the least-recently-parked hot sessions: their pages
  gather D2H into a host :class:`~flink_tensorflow_tpu_torch.serving.kv_cache.KVBlock`
  and free.
- **cold** — when the warm rung outgrows ``ServingConfig.host_cache_sessions``,
  the oldest warm blocks spill to disk (atomic write-then-rename) and
  shrink to a picklable :class:`SpilledKVBlock` path stub.  The next
  admission (or the one after a failover) revives the exact bytes — never
  a re-prefill: an incrementally built cache is not reproducible by
  re-running prefill over the tokens, so a missing spill file is an error.

The spill file is the JAX package's format, a pickled ``(k, v, length)``
of numpy arrays, so a file either package spills the other revives.  One
change: the file name carries the spilled length.  The reference names a
session's file by its key alone, so a session revived after a checkpoint
and spilled again overwrote the file that checkpoint's stub points to, and
a restore from it failed on the length check.  Two spills of one session
at one length hold the same valid positions, so sharing that file is safe.

:class:`SessionTierManager` makes the DECISIONS (LRU orders, watermark
sweeps, spill IO, churn counters); the operator owns the session state and
the runner owns the page mechanics.
"""

from __future__ import annotations

import collections
import hashlib
import os
import pickle
import typing

import numpy as np

from flink_tensorflow_tpu_torch.serving.kv_cache import KVBlock


class SpilledKVBlock:
    """Disk-resident cache of one cold session: a path stub.

    Picklable by construction (checkpoints carry the PATH, the bytes stay
    in the spill file — which must survive a failover, like the checkpoint
    store itself)."""

    __slots__ = ("path", "length", "nbytes_disk")
    kind = "spilled"

    def __init__(self, path: str, length: int, nbytes_disk: int = 0):
        self.path = path
        self.length = int(length)
        self.nbytes_disk = int(nbytes_disk)

    def __reduce__(self):
        return (SpilledKVBlock, (self.path, self.length, self.nbytes_disk))

    def __repr__(self) -> str:
        return f"SpilledKVBlock(path={self.path!r}, length={self.length})"


class SessionTierManager:
    """LRU bookkeeping + watermark policy + spill store for one subtask."""

    def __init__(self, *, spill_dir: typing.Optional[str],
                 host_cache_sessions: int,
                 high_watermark: float, low_watermark: float,
                 subtask_index: int = 0):
        self.spill_dir = spill_dir
        self.host_cache_sessions = host_cache_sessions
        self.high_watermark = high_watermark
        self.low_watermark = low_watermark
        self.subtask_index = subtask_index
        #: Hot rung: parked sessions in LRU order (oldest first).
        self.parked: "collections.OrderedDict[typing.Any, None]" = (
            collections.OrderedDict())
        #: Warm rung: host-block sessions in LRU order.
        self.warm: "collections.OrderedDict[typing.Any, None]" = (
            collections.OrderedDict())
        # Churn counters (gauges).
        self.demoted = 0        # hot -> warm
        self.spilled = 0        # warm -> cold
        self.revived_warm = 0   # warm -> pool (h2d)
        self.revived_cold = 0   # cold -> pool (disk read + h2d)
        self.spill_bytes = 0

    # -- rung membership (the operator calls these on every kv transition)
    def note_parked(self, key) -> None:
        self.parked.pop(key, None)
        self.parked[key] = None

    def note_warm(self, key) -> None:
        self.parked.pop(key, None)
        self.warm.pop(key, None)
        self.warm[key] = None

    def note_admitted(self, key, *, tier: typing.Optional[str]) -> None:
        """A session left the ladder for the pool; count the revival."""
        self.parked.pop(key, None)
        self.warm.pop(key, None)
        if tier == "warm":
            self.revived_warm += 1
        elif tier == "cold":
            self.revived_cold += 1

    def note_gone(self, key) -> None:
        self.parked.pop(key, None)
        self.warm.pop(key, None)

    @property
    def tier_moves(self) -> int:
        """Total demote/spill/revive churn."""
        return (self.demoted + self.spilled
                + self.revived_warm + self.revived_cold)

    # -- policy ----------------------------------------------------------
    def demotions(self, occupancy: typing.Callable[[], float],
                  *, force_pages: int = 0,
                  free_pages: typing.Optional[typing.Callable[[], int]] = None
                  ) -> typing.Iterator[typing.Any]:
        """Yield parked keys (LRU first) to demote hot -> warm.

        Two triggers: the occupancy watermark sweep (tripped above
        ``high_watermark``, drains to ``low_watermark`` — hysteresis, not
        a knife edge), and ``force_pages`` (an allocation came up short —
        demote at least until the free list covers it).  The caller
        demotes each yielded key (freeing its pages) before pulling the
        next, so the generator re-checks live state."""
        tripped = occupancy() > self.high_watermark
        last = object()
        while self.parked:
            forcing = (force_pages > 0 and free_pages is not None
                       and free_pages() < force_pages)
            draining = tripped and occupancy() > self.low_watermark
            if not (forcing or draining):
                return
            key = next(iter(self.parked))
            if key is last or key == last:
                # Contract breach: the caller didn't demote the yielded
                # key (e.g. exhausted via list()) — stop, don't spin.
                return
            last = key
            yield key

    def overflow_spills(self) -> typing.List[typing.Any]:
        """Warm keys (oldest first) past the host-rung cap — cold-spill
        candidates.  Empty when spilling is disabled (no spill_dir)."""
        if self.spill_dir is None:
            return []
        n = len(self.warm) - self.host_cache_sessions
        if n <= 0:
            return []
        return list(self.warm)[:n]

    # -- spill store -----------------------------------------------------
    def _spill_path(self, key, length: int) -> str:
        digest = hashlib.sha1(repr(key).encode()).hexdigest()[:16]
        return os.path.join(self.spill_dir,
                            f"kv-{self.subtask_index}-{digest}-{int(length)}.blk")

    def spill(self, key, block: KVBlock) -> SpilledKVBlock:
        """Warm -> cold: the host block's exact bytes to disk, atomic
        write-then-rename (a crash mid-spill leaves either the old file or
        none, never a truncated one)."""
        os.makedirs(self.spill_dir, exist_ok=True)
        final = self._spill_path(key, block.length)
        tmp = final + ".tmp"
        payload = (np.ascontiguousarray(block.k),
                   np.ascontiguousarray(block.v), block.length)
        with open(tmp, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        self.warm.pop(key, None)
        self.spilled += 1
        nbytes = os.path.getsize(final)
        self.spill_bytes += nbytes
        return SpilledKVBlock(final, block.length, nbytes)

    def revive(self, spilled: SpilledKVBlock) -> KVBlock:
        """Cold -> host block: the exact spilled bytes back.  A missing
        file is a hard error — there is no byte-identical recompute for an
        incrementally built cache."""
        try:
            with open(spilled.path, "rb") as f:
                k, v, length = pickle.load(f)
        except FileNotFoundError as e:
            raise RuntimeError(
                f"spilled KV block vanished: {spilled.path} — the spill "
                "directory must survive failover (same contract as the "
                "checkpoint store)") from e
        if length != spilled.length:
            raise RuntimeError(
                f"spill file {spilled.path} carries length {length}, "
                f"session expected {spilled.length}")
        return KVBlock(k, v, length)
