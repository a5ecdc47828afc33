"""Keyed state — per-subtask ``{state_name: {key: value}}`` tables.

Port of ``flink_tensorflow_tpu/core/state.py``.  Single-writer: each
subtask runs on one thread, so no locking is needed.
"""

from __future__ import annotations

import dataclasses
import typing


@dataclasses.dataclass(frozen=True)
class StateDescriptor:
    """Names a piece of keyed state and how to initialize it."""

    name: str
    default_factory: typing.Optional[typing.Callable[[], typing.Any]] = None


class ValueState:
    """Single-value keyed state, scoped to the store's current key."""

    __slots__ = ("_store", "_descriptor")

    def __init__(self, store: "KeyedStateStore", descriptor: StateDescriptor):
        self._store = store
        self._descriptor = descriptor

    def value(self) -> typing.Any:
        return self._store.get(self._descriptor)

    def update(self, value: typing.Any) -> None:
        self._store.put(self._descriptor, value)

    def clear(self) -> None:
        self._store.remove(self._descriptor)


class KeyedStateStore:
    """Per-subtask store: {state_name: {key: value}}."""

    def __init__(self) -> None:
        self._tables: typing.Dict[str, typing.Dict[typing.Any, typing.Any]] = {}
        self.current_key: typing.Any = None

    def get(self, descriptor: StateDescriptor) -> typing.Any:
        table = self._tables.get(descriptor.name)
        if table is None or self.current_key not in table:
            if descriptor.default_factory is not None:
                # Returned without storing: storing on read would create a
                # table entry for every key ever probed.
                return descriptor.default_factory()
            return None
        return table[self.current_key]

    def put(self, descriptor: StateDescriptor, value: typing.Any) -> None:
        self._tables.setdefault(descriptor.name, {})[self.current_key] = value

    def remove(self, descriptor: StateDescriptor) -> None:
        table = self._tables.get(descriptor.name)
        if table is not None:
            table.pop(self.current_key, None)

    def value_state(self, descriptor: StateDescriptor) -> ValueState:
        return ValueState(self, descriptor)

    def snapshot(self) -> typing.Dict[str, typing.Dict[typing.Any, typing.Any]]:
        """Shallow-copy all tables (values are treated as immutable)."""
        return {name: dict(table) for name, table in self._tables.items()}

    def restore(self, snap: typing.Dict[str, typing.Dict[typing.Any, typing.Any]]) -> None:
        self._tables = {name: dict(table) for name, table in snap.items()}

    def keys(self, state_name: str) -> typing.Iterable[typing.Any]:
        return self._tables.get(state_name, {}).keys()
