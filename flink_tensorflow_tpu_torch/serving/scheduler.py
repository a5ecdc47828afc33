"""Token-budget continuous-batching scheduler (vLLM-style).

Copy of ``flink_tensorflow_tpu/serving/scheduler.py`` for the dense KV
pool, with the options the port's serving path uses (shapes always
bucketed, no admission hysteresis).

Per decode step the scheduler decides WHO computes: waiting sessions
admit in arrival order while slots, ``max_active_seqs`` and the token
budget allow, and when the active set's cache growth overruns the budget
the NEWEST active session preempts back to the head of the waiting queue.
Oldest-first admission + newest-first preemption never livelocks.

Pure bookkeeping — no tensors — so the policy tests in microseconds.
"""

from __future__ import annotations

import collections
import dataclasses
import typing


def _pow2_buckets(cap: int) -> typing.Tuple[int, ...]:
    out = []
    b = 8
    while b < cap:
        out.append(b)
        b *= 2
    out.append(cap)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Knobs of the serving plane.

    ``capacity`` bounds prompt + generated tokens per session (the KV
    pool's padded length).  ``paged_kv`` is the JAX package's paged pool;
    the port does not have it yet and refuses it."""

    max_active_seqs: int = 8
    token_budget: int = 512
    capacity: int = 64
    #: Prefill shape ladders (batch x prompt-length).  ``None`` = powers
    #: of two up to the bound.
    prompt_buckets: typing.Optional[typing.Tuple[int, ...]] = None
    admit_buckets: typing.Optional[typing.Tuple[int, ...]] = None
    #: Preempted sessions keep their cache device-resident (slice out /
    #: copy back, zero host traffic).  Off = preemption pays a d2h and
    #: re-admission an h2d per block.
    device_resident_blocks: bool = True
    #: Run every prefill bucket + the decode step once at open(), so the
    #: kernel build and first launches happen before the first session.
    warmup_compile: bool = False
    paged_kv: bool = False

    def __post_init__(self):
        if self.paged_kv:
            raise NotImplementedError(
                "paged_kv: the paged KV pool (ops/paged_attention.py, "
                "PagedDecodeStepRunner) is a later slice of the PyTorch port; "
                "this slice serves from the dense pool only")

    def resolved_prompt_buckets(self) -> typing.Tuple[int, ...]:
        return self.prompt_buckets or _pow2_buckets(self.capacity)

    def resolved_admit_buckets(self) -> typing.Tuple[int, ...]:
        return self.admit_buckets or _pow2_buckets(self.max_active_seqs)

    def bucket_admit(self, n: int) -> int:
        for b in self.resolved_admit_buckets():
            if n <= b:
                return b
        return self.max_active_seqs


@dataclasses.dataclass
class SchedulerCounters:
    admitted: int = 0
    evicted: int = 0      # finished sessions releasing their slot
    preempted: int = 0    # budget overruns pushing a session back
    rejected: int = 0     # prompt + max_new > capacity (cannot ever fit)
    steps: int = 0


class TokenBudgetScheduler:
    """Active-set bookkeeping for one subtask's continuous batcher."""

    def __init__(self, config: ServingConfig):
        self.config = config
        #: session key -> pool slot (the active set).
        self.active: "collections.OrderedDict[typing.Any, int]" = (
            collections.OrderedDict())
        #: session key -> current cache length (budget accounting).
        self.lengths: typing.Dict[typing.Any, int] = {}
        self.waiting: "collections.deque[typing.Any]" = collections.deque()
        self.free_slots: typing.List[int] = list(
            range(config.max_active_seqs - 1, -1, -1))
        self.tokens_in_use = 0
        self.counters = SchedulerCounters()

    @property
    def has_work(self) -> bool:
        return bool(self.active) or bool(self.waiting)

    def slot_of(self, key) -> int:
        return self.active[key]

    def enqueue(self, key, *, front: bool = False) -> None:
        if front:
            self.waiting.appendleft(key)
        else:
            self.waiting.append(key)

    def plan_admissions(
        self, length_of: typing.Callable[[typing.Any], int],
    ) -> typing.List[typing.Tuple[typing.Any, int]]:
        """Pop admissible sessions off the waiting queue: ``[(key, slot)]``
        in arrival order.  ``length_of(key)`` is the cache length the
        session occupies at admission; the budget charges length + 1."""
        out: typing.List[typing.Tuple[typing.Any, int]] = []
        while (self.waiting and self.free_slots
               and len(self.active) < self.config.max_active_seqs):
            key = self.waiting[0]
            need = length_of(key) + 1
            if self.tokens_in_use + need > self.config.token_budget and self.active:
                break  # budget-full (never starves: an empty active set admits)
            self.waiting.popleft()
            slot = self.free_slots.pop()
            self.active[key] = slot
            self.lengths[key] = need - 1
            self.tokens_in_use += need - 1
            self.counters.admitted += 1
            out.append((key, slot))
        return out

    def grow(self, key) -> None:
        """One decode step appended one cache position for ``key``."""
        self.lengths[key] += 1
        self.tokens_in_use += 1

    def release(self, key, *, reason: str) -> int:
        """Drop ``key`` from the active set; returns its freed slot."""
        slot = self.active.pop(key)
        self.tokens_in_use -= self.lengths.pop(key)
        self.free_slots.append(slot)
        if reason == "finished":
            self.counters.evicted += 1
        return slot

    def over_budget(self) -> typing.List[typing.Any]:
        """Keys to preempt (newest admitted first) until the active set
        fits the budget again.  At least one session always survives."""
        victims: typing.List[typing.Any] = []
        keys = list(self.active.keys())
        projected = self.tokens_in_use
        i = len(keys) - 1
        while projected > self.config.token_budget and i > 0:
            victims.append(keys[i])
            projected -= self.lengths[keys[i]]
            i -= 1
        return victims

    def preempt(self, key) -> int:
        slot = self.release(key, reason="preempted")
        self.counters.preempted += 1
        self.enqueue(key, front=True)
        return slot
