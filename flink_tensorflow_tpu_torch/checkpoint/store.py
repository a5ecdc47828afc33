"""Snapshot persistence — host-only, atomic, resumable.

Port of ``flink_tensorflow_tpu/checkpoint/store.py:86-376``.  A snapshot
is pickled into ``chk-NNNNNN/state.pkl`` beside a ``METADATA.json``; the
directory becomes visible under its final name only after a full write,
fsync and rename, so a crash mid-write never leaves a torn restore point.

Tensors: :func:`to_host` copies every ``torch.Tensor`` that is not on the
CPU to a CPU tensor.  The runtime applies it on the subtask thread that
took the snapshot, before the coordinator sees it, and the writer applies
it again; the writer's pickler refuses any device tensor left inside an
object it cannot walk.  So a checkpoint written from the card reads back
on a machine without one.

A distributed cohort writes one shard per process under a shared base
(``proc-NNNNN/chk-XXXXXX``, ``core/distributed.py``).
:func:`select_cohort_checkpoint` picks a restore point by shard-set
completeness against the cohort shape each shard recorded in its
``METADATA.json`` (so a lost shard makes an id ineligible and a stale
shard of an older shape vetoes nothing), and
:func:`read_cohort_checkpoint` merges the shards of one id, which the
cohort-rescaling restore needs.
"""

from __future__ import annotations

import dataclasses
import io
import json
import logging
import os
import pickle
import shutil
import typing

import torch


def to_host(obj: typing.Any) -> typing.Any:
    """``obj`` with every tensor off the CPU copied to the CPU; dicts,
    lists, tuples, namedtuples and dataclasses are walked (containers
    without a device tensor come back as they were)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu() if obj.device.type != "cpu" else obj
    if isinstance(obj, dict):
        items = {k: to_host(v) for k, v in obj.items()}
        return obj if all(items[k] is v for k, v in obj.items()) else type(obj)(items)
    if isinstance(obj, (list, tuple)):
        converted = [to_host(v) for v in obj]
        if all(a is b for a, b in zip(converted, obj)):
            return obj
        if hasattr(obj, "_fields"):  # namedtuple: keep the type
            return type(obj)(*converted)
        return type(obj)(converted)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        changes = {}
        for f in dataclasses.fields(obj):
            if f.init:
                value = getattr(obj, f.name)
                host = to_host(value)
                if host is not value:
                    changes[f.name] = host
        return dataclasses.replace(obj, **changes) if changes else obj
    return obj


class _HostPickler(pickle.Pickler):
    """Refuses device tensors wherever they hide in the object graph."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor) and obj.device.type != "cpu":
            raise TypeError(
                f"a {obj.device} tensor reached the checkpoint writer inside an object "
                "to_host cannot walk — snapshot hooks must return host objects")
        return NotImplemented


def _dumps(obj: typing.Any) -> bytes:
    buf = io.BytesIO()
    _HostPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def _chk_dir(base: str, checkpoint_id: int) -> str:
    return os.path.join(base, f"chk-{checkpoint_id:06d}")


def write_checkpoint(base_dir: str, checkpoint_id: int,
                     snapshots: typing.Dict[str, typing.Dict[int, typing.Any]]) -> str:
    payload = _dumps(to_host(snapshots))
    os.makedirs(base_dir, exist_ok=True)
    final = _chk_dir(base_dir, checkpoint_id)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    # fsync data AND directories before the rename: without it a crash
    # right after os.replace can expose chk-N with a truncated state.pkl.
    with open(os.path.join(tmp, "state.pkl"), "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    meta = {
        "checkpoint_id": checkpoint_id,
        "tasks": {task: sorted(per_sub.keys()) for task, per_sub in snapshots.items()},
        "job": snapshots.get("__job__", {}).get(0, {}),
    }
    with open(os.path.join(tmp, "METADATA.json"), "w") as f:
        json.dump(meta, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _fsync_dir(base_dir)
    return final


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def checkpoint_size_bytes(chk_path: str) -> int:
    """On-disk footprint of one written checkpoint directory (0 when it
    vanished, pruned concurrently)."""
    total = 0
    try:
        for root, _, files in os.walk(chk_path):
            for name in files:
                try:
                    total += os.path.getsize(os.path.join(root, name))
                except OSError:
                    continue
    except OSError:
        return 0
    return total


def checkpoint_ids(base_dir: str) -> typing.List[int]:
    """All completed checkpoint ids under ``base_dir``, ascending."""
    if not os.path.isdir(base_dir):
        return []
    ids = []
    for name in os.listdir(base_dir):
        if name.startswith("chk-") and not name.endswith((".tmp", ".pruning")):
            try:
                ids.append(int(name[4:]))
            except ValueError:
                continue
    return sorted(ids)


def latest_checkpoint_id(base_dir: str) -> typing.Optional[int]:
    ids = checkpoint_ids(base_dir)
    return ids[-1] if ids else None


def read_checkpoint(base_dir: str, checkpoint_id: typing.Optional[int] = None
                    ) -> typing.Tuple[int, typing.Dict[str, typing.Dict[int, typing.Any]]]:
    if checkpoint_id is None:
        checkpoint_id = latest_checkpoint_id(base_dir)
        if checkpoint_id is None:
            raise FileNotFoundError(f"no checkpoints under {base_dir}")
    with open(os.path.join(_chk_dir(base_dir, checkpoint_id), "state.pkl"), "rb") as f:
        return checkpoint_id, pickle.load(f)


def prune_checkpoints(base_dir: str, keep_last: int) -> typing.List[int]:
    """Delete all but the newest ``keep_last`` completed checkpoints under
    ``base_dir``; returns the deleted ids, oldest first.  Each directory is
    renamed to ``.pruning`` (one journaled step that removes it from
    :func:`checkpoint_ids`) before the recursive delete, so a failed delete
    never leaves a torn ``chk-N`` behind."""
    if keep_last < 1:
        raise ValueError(f"keep_last must be >= 1, got {keep_last}")
    # Reap .pruning orphans of a crash between rename and delete.
    if os.path.isdir(base_dir):
        for name in os.listdir(base_dir):
            if name.endswith(".pruning"):
                shutil.rmtree(os.path.join(base_dir, name), ignore_errors=True)
    deleted = []
    for cid in checkpoint_ids(base_dir)[:-keep_last]:
        final = _chk_dir(base_dir, cid)
        doomed = final + ".pruning"
        try:
            if os.path.exists(doomed):
                shutil.rmtree(doomed)
            os.rename(final, doomed)
        except OSError:  # pragma: no cover - fs race/permissions
            logging.getLogger(__name__).warning(
                "could not prune checkpoint %d under %s", cid, base_dir, exc_info=True)
            continue
        deleted.append(cid)
        shutil.rmtree(doomed, ignore_errors=True)
    return deleted


def cohort_process_dirs(base_dir: str) -> typing.List[str]:
    """The per-process shard directories a distributed cohort wrote under
    one shared checkpoint base (``proc-00000``, ``proc-00001``, ...)."""
    if not os.path.isdir(base_dir):
        return []
    return sorted(
        os.path.join(base_dir, name)
        for name in os.listdir(base_dir)
        if name.startswith("proc-") and os.path.isdir(os.path.join(base_dir, name))
    )


def read_shard_meta(shard_dir: str, checkpoint_id: int) -> typing.Optional[dict]:
    """A shard's METADATA.json for one checkpoint (no state unpickling);
    None when the checkpoint or the metadata file is absent."""
    path = os.path.join(_chk_dir(shard_dir, checkpoint_id), "METADATA.json")
    try:
        with open(path) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return None


def _complete_shard_set(
    dirs: typing.Sequence[str], checkpoint_id: int,
    ids_by_dir: typing.Optional[typing.Mapping[str, typing.Set[int]]] = None,
) -> typing.Optional[typing.List[str]]:
    """The shard directories forming a COMPLETE cohort snapshot of
    ``checkpoint_id``, or None.

    Completeness comes from the cohort shape each shard RECORDED at
    write time (num_processes + participants + process_index in
    METADATA.json): the shards holding the id must all agree on the
    shape and cover the recorded PARTICIPANT set exactly.  Participants
    — the processes owning >= 1 subtask — rather than {0..P-1}, because
    an over-provisioned cohort (num_processes > max operator
    parallelism) legally has idle processes that never write a shard;
    requiring every index would deem each of its checkpoints incomplete
    forever.  A directory listing alone cannot
    distinguish "cohort of 2" from "cohort of 3 minus a lost shard" —
    and a stale shard from a previous cohort shape (which simply lacks
    this id) must not veto the id.  Shards that recorded num_processes
    but no participant set imply participants = {0..P-1}; shards
    written before any shape was recorded fall back to the oldest rule:
    the id must be present in EVERY proc-* directory.
    """
    if ids_by_dir is None:
        ids_by_dir = {d: set(checkpoint_ids(d)) for d in dirs}
    having = [d for d in dirs if checkpoint_id in ids_by_dir[d]]
    if not having:
        return None
    metas = [read_shard_meta(d, checkpoint_id) for d in having]
    jobs = [(m or {}).get("job", {}) for m in metas]
    shapes = [j.get("num_processes") for j in jobs]
    if any(p is None for p in shapes):
        # Legacy shards: no recorded shape — complete iff universal.
        return having if len(having) == len(dirs) else None
    if len(set(shapes)) != 1:
        return None
    expected_participants = {
        tuple(j["participants"]) if j.get("participants") is not None
        else tuple(range(shapes[0]))
        for j in jobs
    }
    if len(expected_participants) != 1:
        return None
    expected = set(expected_participants.pop())
    indices = {j.get("process_index") for j in jobs}
    if len(having) == len(expected) and indices == expected:
        return having
    return None


def select_cohort_checkpoint(
    base_dir: str, checkpoint_id: typing.Optional[int] = None
) -> typing.Tuple[int, typing.List[str]]:
    """Pick ``(checkpoint_id, complete shard dirs)`` under a shared
    cohort base — metadata-only (no state unpickling).  With
    ``checkpoint_id=None``: the highest id with a complete shard set;
    an explicit id with an incomplete set raises loudly."""
    dirs = cohort_process_dirs(base_dir)
    if not dirs:
        raise FileNotFoundError(f"no proc-* shard directories under {base_dir}")
    # One directory listing per shard, shared across candidate ids.
    ids_by_dir = {d: set(checkpoint_ids(d)) for d in dirs}
    if checkpoint_id is None:
        candidates: typing.Set[int] = set()
        for ids in ids_by_dir.values():
            candidates.update(ids)
        for cid in sorted(candidates, reverse=True):
            shard_set = _complete_shard_set(dirs, cid, ids_by_dir)
            if shard_set is not None:
                return cid, shard_set
        raise FileNotFoundError(
            f"no checkpoint under {base_dir} has a complete cohort shard set"
        )
    shard_set = _complete_shard_set(dirs, checkpoint_id, ids_by_dir)
    if shard_set is None:
        raise ValueError(
            f"checkpoint {checkpoint_id} under {base_dir} has an INCOMPLETE "
            "cohort shard set (a process's shard is missing or shards "
            "disagree on the cohort shape) — restoring it would silently "
            "drop that shard's state"
        )
    return checkpoint_id, shard_set


def read_cohort_checkpoint(
    base_dir: str, checkpoint_id: typing.Optional[int] = None
) -> typing.Tuple[int, typing.Dict[str, typing.Dict[int, typing.Any]]]:
    """Merge the per-process shards of checkpoint ``checkpoint_id`` under
    a SHARED cohort base directory into one global snapshot mapping.

    Every process of a distributed job persists only its own subtasks'
    state (``proc-NNNNN/chk-XXXXXX``); merging the shards reconstructs
    the full {task: {subtask: state}} view — what cohort RESCALING needs
    (restoring with a different process count or operator parallelism
    redistributes keyed state by key group, which requires every old
    subtask's shard, not just the local one).

    ``checkpoint_id=None`` selects the HIGHEST id whose shard set is
    complete per the cohort shape recorded in the shards themselves
    (see ``_complete_shard_set`` — a lost shard makes an id ineligible
    rather than silently restoring partial state, and stale shards from
    a previous cohort shape neither veto nor pollute newer ids).  An
    explicit id with an incomplete shard set raises loudly.
    """
    checkpoint_id, shard_set = select_cohort_checkpoint(base_dir, checkpoint_id)
    merged: typing.Dict[str, typing.Dict[int, typing.Any]] = {}
    for d in shard_set:
        _, snapshots = read_checkpoint(d, checkpoint_id)
        for task, subtasks in snapshots.items():
            into = merged.setdefault(task, {})
            for idx, snap in subtasks.items():
                if task != "__job__" and idx in into:
                    raise ValueError(
                        f"checkpoint {checkpoint_id}: subtask {task}.{idx} "
                        f"appears in more than one shard under {base_dir} — "
                        "shards from different cohort shapes are mixed; "
                        "use a fresh checkpoint base per job lineage"
                    )
                into[idx] = snap
    return checkpoint_id, merged
