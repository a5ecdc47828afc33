"""Request/response record model of the serving plane.

Copy of ``flink_tensorflow_tpu/serving/records.py``.

Requests ride the record plane like any other value: picklable, keyed by
``session_id``, carrying their metadata in ``meta`` (the paced sources
stamp ``meta["sched_ts"]`` through ``with_meta``, as on a TensorValue).
Responses stream back as one :class:`TokenEvent` per generated token —
time-to-first-token is simply the latency of ``index == 0``.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np


@dataclasses.dataclass
class GenerateRequest:
    """One session's generation request.

    ``prompt`` is the tokenized prompt (int32); ``max_new_tokens`` bounds
    the continuation; ``eos_token`` (optional) ends it early.  Sampling
    is greedy by construction — determinism is what makes mid-generation
    failover byte-identical, and the serving tests assert exactly that.
    """

    session_id: typing.Any
    prompt: np.ndarray
    max_new_tokens: int = 16
    eos_token: typing.Optional[int] = None
    meta: typing.Dict[str, typing.Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)

    def with_meta(self, **kw) -> "GenerateRequest":
        """A copy with more meta (how the paced sources stamp the schedule)."""
        meta = dict(self.meta)
        meta.update(kw)
        return dataclasses.replace(self, meta=meta)


@dataclasses.dataclass
class TokenEvent:
    """One generated token of one session, streamed downstream.

    ``index`` is the 0-based position within the continuation (so
    ``index == 0`` marks first-token latency); ``finished`` is True on
    the session's LAST token (max_new_tokens reached or eos emitted).
    ``meta`` carries the request's meta through (``sched_ts`` for the
    bench's open-loop latency accounting).
    """

    session_id: typing.Any
    index: int
    token: int
    finished: bool = False
    meta: typing.Dict[str, typing.Any] = dataclasses.field(default_factory=dict)
