"""KV-cache blocks and the keyed-state facade that owns them.

Port of ``flink_tensorflow_tpu/serving/kv_cache.py``.  One session's
cache is a pair of parts ``[L, C, *part]`` (``k`` is part 0, ``v`` part 1,
their shapes a token the model's ``kv_cache_spec()``: K and V ``[H, Dh]``
for ``char_transformer``, DeepSeek-V2's latent ``[1, 512]`` and ``[1,
64]``) plus its valid length, in one of these residency forms:

- :class:`KVBlock` — host numpy, picklable: the form in checkpoints (and
  the paged pool's warm rung).
- :class:`DeviceKVBlock` — tensors on the device: a preempted session's
  cache between eviction and re-admission when the dense pool runs
  device-resident.  It refuses to pickle; ``to_host()`` is the explicit
  materialization boundary.
- with the paged pool, a :class:`~flink_tensorflow_tpu_torch.serving.paged.PagedKVHandle`
  (parked pages, refuses to pickle like a device block) or a
  :class:`~flink_tensorflow_tpu_torch.serving.tiering.SpilledKVBlock`
  (a spill file's path, picklable).  The operator's snapshot hook turns
  every form that refuses to pickle into a :class:`KVBlock` first.

:class:`KVCacheState` keeps one :class:`SessionState` per session id in
the keyed-state store, so snapshot and restore carry sessions like any
other keyed state.  Values are immutable: every mutation writes a fresh
``SessionState``.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np

from flink_tensorflow_tpu_torch.core.state import KeyedStateStore, StateDescriptor

if typing.TYPE_CHECKING:
    from flink_tensorflow_tpu_torch.serving.paged import PagedKVHandle
    from flink_tensorflow_tpu_torch.serving.tiering import SpilledKVBlock


class KVBlock:
    """Host-resident cache of one session: parts 0 and 1 (``k``, ``v``)
    ``[L, C, *part]`` as numpy, in the pool's dtype or, for bfloat16
    (which numpy lacks), widened exactly to float32."""

    __slots__ = ("k", "v", "length")
    kind = "host"

    def __init__(self, k: np.ndarray, v: np.ndarray, length: int):
        self.k = np.asarray(k)
        self.v = np.asarray(v)
        self.length = int(length)

    def __reduce__(self):
        return (KVBlock, (self.k, self.v, self.length))

    def nbytes(self) -> int:
        return self.k.nbytes + self.v.nbytes

    def __repr__(self) -> str:
        return f"KVBlock(shape={tuple(self.k.shape)}, length={self.length})"


def host_array(t) -> np.ndarray:
    """A new host numpy copy of tensor ``t`` (never a view of a CPU pool,
    which is written again); bfloat16, which numpy lacks, widened exactly
    to float32, which narrows back exactly into the pool."""
    import torch

    t = t.to("cpu", copy=True)
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class DeviceKVBlock:
    """Device-resident cache of one session (torch tensors owned by the
    block, not views of the pool)."""

    __slots__ = ("k", "v", "length")
    kind = "device"

    def __init__(self, k, v, length: int):
        self.k = k
        self.v = v
        self.length = int(length)

    def to_host(self) -> KVBlock:
        return KVBlock(host_array(self.k), host_array(self.v), self.length)

    def __reduce__(self):
        raise TypeError(
            "DeviceKVBlock is device-resident and never crosses a pickle "
            "boundary — the serving operator's snapshot hook converts it "
            "to a host KVBlock first; call to_host() if you really need "
            "the bytes")

    def __repr__(self) -> str:
        return f"DeviceKVBlock(shape={tuple(self.k.shape)}, length={self.length})"


#: Session lifecycle states.
WAITING = "waiting"
ACTIVE = "active"
DONE = "done"


@dataclasses.dataclass(frozen=True)
class SessionState:
    """Everything one session needs to resume anywhere: the keyed-state
    value.  Immutable — mutations go through ``dataclasses.replace``."""

    seq: int                          # arrival order (admission fairness)
    prompt: np.ndarray                # [P] int32
    max_new: int
    eos: typing.Optional[int]
    status: str = WAITING
    generated: typing.Tuple[int, ...] = ()
    emitted: int = 0
    kv: typing.Optional[typing.Union[KVBlock, DeviceKVBlock, "PagedKVHandle",
                                     "SpilledKVBlock"]] = None
    meta: typing.Dict[str, typing.Any] = dataclasses.field(default_factory=dict)

    def cache_length(self) -> int:
        """Valid cache positions a resume starts from (0 = fresh prefill)."""
        return self.kv.length if self.kv is not None else 0


class KVCacheState:
    """Keyed-state facade: one :class:`SessionState` per session id,
    scoping ``current_key`` per call (the serving step touches many keys
    per invocation)."""

    DESCRIPTOR = StateDescriptor("serving_sessions")

    def __init__(self, store: KeyedStateStore):
        self._store = store

    def _scoped(self, key, fn):
        prev = self._store.current_key
        self._store.current_key = key
        try:
            return fn()
        finally:
            self._store.current_key = prev

    def get(self, key) -> typing.Optional[SessionState]:
        return self._scoped(key, lambda: self._store.get(self.DESCRIPTOR))

    def put(self, key, state: SessionState) -> None:
        self._scoped(key, lambda: self._store.put(self.DESCRIPTOR, state))

    def remove(self, key) -> None:
        self._scoped(key, lambda: self._store.remove(self.DESCRIPTOR))

    def keys(self) -> typing.List[typing.Any]:
        return list(self._store.keys(self.DESCRIPTOR.name))
