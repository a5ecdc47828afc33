"""Snapshot persistence — host-only, atomic, resumable.

Port of ``flink_tensorflow_tpu/checkpoint/store.py:86-230``.  A snapshot
is pickled into ``chk-NNNNNN/state.pkl`` beside a ``METADATA.json``; the
directory becomes visible under its final name only after a full write,
fsync and rename, so a crash mid-write never leaves a torn restore point.

Tensors: :func:`to_host` copies every ``torch.Tensor`` that is not on the
CPU to a CPU tensor.  The runtime applies it on the subtask thread that
took the snapshot, before the coordinator sees it, and the writer applies
it again; the writer's pickler refuses any device tensor left inside an
object it cannot walk.  So a checkpoint written from the card reads back
on a machine without one.
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
