"""Token-budget continuous-batching scheduler (vLLM-style).

Copy of ``flink_tensorflow_tpu/serving/scheduler.py``: the config of the
serving plane (dense or paged KV pool, the tier ladder, shape buckets,
admission hysteresis) and the scheduler with the paged pool's admission
gate.

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
    """Knobs of the serving plane (the README documents each).

    ``capacity`` bounds prompt + generated tokens per session (the KV
    pool's padded length).  ``padding_buckets`` off runs every distinct
    active-set size and prompt length at its own shape."""

    max_active_seqs: int = 8
    token_budget: int = 512
    capacity: int = 64
    #: Prefill shape ladders (batch x prompt-length), used only when
    #: ``padding_buckets`` is on.  ``None`` = powers of two up to the
    #: bound.
    prompt_buckets: typing.Optional[typing.Tuple[int, ...]] = None
    admit_buckets: typing.Optional[typing.Tuple[int, ...]] = None
    padding_buckets: bool = True
    #: Preempted sessions keep their cache device-resident (slice out /
    #: copy back, zero host traffic).  Off = preemption pays a d2h and
    #: re-admission an h2d per block.
    device_resident_blocks: bool = True
    #: Run every prefill bucket + the decode step once at open(), so the
    #: kernel build and first launches happen before the first session.
    warmup_compile: bool = False
    #: Admission hysteresis: with a deep backlog, hold admissions until
    #: this many slots are free so waiting prefills batch into ONE
    #: dispatch instead of one per freed slot.  Never delays when the
    #: active set is empty or the backlog is shallower than the
    #: threshold.
    admit_hysteresis: int = 1
    #: Paged KV economy (serving/paged.py + serving/tiering.py): the
    #: cache pool becomes ``hbm_pages`` fixed-size pages of
    #: ``page_tokens`` positions with a per-session block table —
    #: admission needs free PAGES, not a contiguous slot — plus a
    #: radix-tree prefix index (sessions sharing a prompt prefix share
    #: pages, copy-on-write at divergence) and the device -> host -> disk
    #: residency ladder.  Off (the default) keeps the dense
    #: ``[S, L, C, H, Dh]`` pool.
    paged_kv: bool = False
    page_tokens: int = 16
    #: Device page budget.  ``None`` sizes the pool to the dense
    #: equivalent (``max_active_seqs * capacity / page_tokens``); an
    #: oversubscribed deployment sizes it far SMALLER than the live
    #: session population and lets tiering absorb the difference.
    hbm_pages: typing.Optional[int] = None
    prefix_sharing: bool = True
    #: The residency ladder's watermark sweep: parked (preempted-hot)
    #: sessions demote to host blocks when pool occupancy crosses the
    #: high watermark, draining to the low one; the warm rung spills to
    #: ``spill_dir`` past ``host_cache_sessions``.  ``tiering=False``
    #: keeps only pressure-forced demotion (an allocation that cannot be
    #: satisfied any other way).
    tiering: bool = True
    tier_high_watermark: float = 0.90
    tier_low_watermark: float = 0.70
    host_cache_sessions: int = 64
    #: Cold rung directory; ``None`` disables disk spill (warm blocks
    #: then accumulate on the host without bound).
    spill_dir: typing.Optional[str] = None
    #: Padded tokens one prefill may take (admitted sessions' batch
    #: bucket times their longest prompt's bucket).  Admission stops
    #: before the session that would pass it; the first waiting session
    #: is always admitted.  Prefill shapes over it are never presented,
    #: so they are neither warmed nor priced.  ``None``: no cap.
    prefill_token_budget: typing.Optional[int] = None

    def resolved_hbm_pages(self) -> int:
        if self.hbm_pages is not None:
            return self.hbm_pages
        return self.max_active_seqs * (self.capacity // self.page_tokens)

    def page_partition(self, key_groups: int) -> typing.Tuple[int, int]:
        """``(pages_per_group, remainder)`` when the device page pool is
        dealt out along ``key_groups`` key groups."""
        pages = self.resolved_hbm_pages()
        return pages // key_groups, pages % key_groups

    def resolved_prompt_buckets(self) -> typing.Tuple[int, ...]:
        return self.prompt_buckets or _pow2_buckets(self.capacity)

    def resolved_admit_buckets(self) -> typing.Tuple[int, ...]:
        return self.admit_buckets or _pow2_buckets(self.max_active_seqs)

    def bucket_prompt_len(self, n: int) -> int:
        if not self.padding_buckets:
            return max(1, n)
        for b in self.resolved_prompt_buckets():
            if n <= b:
                return b
        return self.capacity

    def bucket_admit(self, n: int) -> int:
        if not self.padding_buckets:
            return max(1, n)
        for b in self.resolved_admit_buckets():
            if n <= b:
                return b
        return self.max_active_seqs

    def prefill_fits(self, batch: int, length: int) -> bool:
        """Whether a prefill bucket ``[batch, length]`` is within
        ``prefill_token_budget``."""
        budget = self.prefill_token_budget
        return budget is None or batch * min(length, self.capacity) <= budget

    def compile_signatures(
        self,
    ) -> typing.Optional[typing.Tuple[typing.Tuple[str, int, int], ...]]:
        """Every distinct step shape this config can present, as ``(kind,
        batch, length)`` tuples — the prefill admit x prompt bucket grid
        (within ``prefill_token_budget``) plus the single padded decode
        step — or ``None`` when ``padding_buckets`` is off and the set is
        unbounded."""
        if not self.padding_buckets:
            return None
        sigs = [("prefill", b, t)
                for b in self.resolved_admit_buckets()
                for t in self.resolved_prompt_buckets()
                if self.prefill_fits(b, t)]
        sigs.append(("decode", self.max_active_seqs, 1))
        return tuple(sigs)


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
        #: Admissions stopped because the next prefill would pass
        #: ``prefill_token_budget`` (beside ``counters``, which keep the
        #: JAX scheduler's fields).
        self.prefill_budget_held = 0

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
        admit_gate: typing.Optional[
            typing.Callable[[typing.Any, int], bool]] = None,
        prefill_of: typing.Optional[typing.Callable[[typing.Any], int]] = None,
    ) -> typing.List[typing.Tuple[typing.Any, int]]:
        """Pop admissible sessions off the waiting queue: ``[(key, slot)]``
        in arrival order.  ``length_of(key)`` is the cache length the
        session occupies at admission; the budget charges length + 1.
        ``admit_gate(key, length)`` is the paged pool's page check (free
        pages instead of a contiguous slot); a False stops admission
        FIFO-fairly — nobody jumps the queue past a session the pool
        can't seat yet.  ``prefill_of(key)`` is the prompt length the
        session prefills (0 for one resuming from its cache; default
        ``length_of``): with ``prefill_token_budget`` set, admission stops
        before the session whose prompt would take the admitted prefills'
        padded tokens past it (``prefill_budget_held``)."""
        cfg = self.config
        prefill_of = prefill_of or length_of
        prefills = 0            # sessions of this admission that prefill
        longest = 0             # their longest prompt
        out: typing.List[typing.Tuple[typing.Any, int]] = []
        hyst = self.config.admit_hysteresis
        if (hyst > 1 and self.active
                and len(self.free_slots) < min(hyst, len(self.waiting))):
            return out  # batch the backlog's prefills into one dispatch
        while (self.waiting and self.free_slots
               and len(self.active) < self.config.max_active_seqs):
            key = self.waiting[0]
            need = length_of(key) + 1
            if self.tokens_in_use + need > self.config.token_budget and self.active:
                break  # budget-full (never starves: an empty active set admits)
            prompt = prefill_of(key)
            if prompt and cfg.prefill_token_budget is not None and prefills:
                grown = max(longest, prompt)
                if not cfg.prefill_fits(cfg.bucket_admit(prefills + 1),
                                        cfg.bucket_prompt_len(grown)):
                    self.prefill_budget_held += 1
                    break  # the next prefill batch takes it first
            if admit_gate is not None and not admit_gate(key, need - 1):
                break  # no pages free — tier pressure clears first
            if prompt:
                prefills += 1
                longest = max(longest, prompt)
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
