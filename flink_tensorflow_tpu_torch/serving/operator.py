"""ContinuousBatchingOperator — the serving plane's decode-step loop.

Port of ``flink_tensorflow_tpu/serving/operator.py:65-652``, dense and
paged KV pool, with :func:`continuous_batching`, the entry point that puts
the operator on a keyed stream of the port's streaming runtime.

One operator instance per subtask owns a slice of the session key space,
a :class:`~flink_tensorflow_tpu_torch.functions.runner.DecodeStepRunner`
(or, with ``ServingConfig.paged_kv``, a
:class:`~flink_tensorflow_tpu_torch.functions.runner.PagedDecodeStepRunner`
and a :class:`~flink_tensorflow_tpu_torch.serving.tiering.SessionTierManager`)
whose KV pool stays on the device for the operator's life, and a
:class:`~flink_tensorflow_tpu_torch.serving.scheduler.TokenBudgetScheduler`.
The loop is timer-driven: while any session is active or waiting,
``next_deadline`` keeps the subtask loop hot and every ``fire_due`` runs
ONE serving step — admit, prefill, decode, emit, evict, preempt —
interleaved with request arrivals.

State: the hot path mutates plain per-session records (``_Session``);
the snapshot hook freezes every live session into keyed state as a
:class:`SessionState` (active caches copied to host :class:`KVBlock`
form, device-resident blocks and parked pages downgraded to host form,
spilled sessions kept as their spill file's path), and a restored operator
re-admits the sessions from their blocks without re-prefill, continuing
greedy decoding byte-identically.  Pages never cross subtasks: a rescale
moves sessions by key group as host or spilled blocks.
"""

from __future__ import annotations

import dataclasses
import time
import typing

import torch

from flink_tensorflow_tpu_torch.core import elements as el
from flink_tensorflow_tpu_torch.core.operators import Operator
from flink_tensorflow_tpu_torch.serving.kv_cache import (
    ACTIVE,
    DONE,
    WAITING,
    DeviceKVBlock,
    KVBlock,
    KVCacheState,
    SessionState,
)
from flink_tensorflow_tpu_torch.serving.paged import PagedKVHandle
from flink_tensorflow_tpu_torch.serving.records import GenerateRequest, TokenEvent
from flink_tensorflow_tpu_torch.serving.scheduler import (
    ServingConfig,
    TokenBudgetScheduler,
)
from flink_tensorflow_tpu_torch.serving.tiering import SessionTierManager, SpilledKVBlock
from flink_tensorflow_tpu_torch.utils.device import resolve_device

if typing.TYPE_CHECKING:
    from flink_tensorflow_tpu_torch.models.base import Model


class _Session:
    """Mutable runtime mirror of one session (hot path only; the frozen
    keyed-state form is built at barrier sync)."""

    __slots__ = ("seq", "prompt", "max_new", "eos", "status", "generated",
                 "emitted", "kv", "meta", "arrived")

    def __init__(self, seq, prompt, max_new, eos, meta,
                 status=WAITING, generated=(), emitted=0, kv=None,
                 arrived=None):
        self.seq = seq
        self.prompt = prompt
        self.max_new = max_new
        self.eos = eos
        self.status = status
        self.generated = list(generated)
        self.emitted = emitted
        self.kv = kv
        self.meta = meta
        # Arrival stamp (monotonic) for the TTFT histogram; None for
        # restored sessions — their first-token latency is recovery time.
        self.arrived = arrived

    def freeze(self) -> SessionState:
        return SessionState(
            seq=self.seq, prompt=self.prompt, max_new=self.max_new,
            eos=self.eos, status=self.status,
            generated=tuple(self.generated), emitted=self.emitted,
            kv=self.kv, meta=self.meta,
        )

    @classmethod
    def thaw(cls, st: SessionState) -> "_Session":
        # ``emitted`` resets on restore: a restored job re-emits the whole
        # (deterministic) continuation — at-least-once replay.
        return cls(st.seq, st.prompt, st.max_new, st.eos, dict(st.meta),
                   status=st.status, generated=st.generated,
                   emitted=0, kv=st.kv)


class ContinuousBatchingOperator(Operator):
    """Keyed continuous-batching generation operator (dense or paged KV
    pool).

    ``device``: where the model and pool live; ``None`` means ``cuda``
    and raises if CUDA is absent.  ``device_from_context=True`` (what
    :func:`continuous_batching` builds) defers the choice to ``open()``:
    the subtask's ``RuntimeContext.device`` (the job's device provider),
    else ``cuda``, which raises there if CUDA is absent."""

    #: The plan analyzer's serving rules and the pricer find the operator
    #: by this marker and read ``serving_config``.
    is_continuous_batching = True

    def __init__(self, name: str, model: "Model",
                 config: typing.Optional[ServingConfig] = None,
                 key_selector: typing.Optional[typing.Callable] = None,
                 *, device=None, device_from_context: bool = False):
        super().__init__(name)
        self.model = model
        self.serving_config = config or ServingConfig()
        self.key_selector = key_selector
        self.device = None if device_from_context else resolve_device(device)
        self._sched: typing.Optional[TokenBudgetScheduler] = None
        self._runner = None
        self._paged = False
        self._tier: typing.Optional[SessionTierManager] = None
        self._cache: typing.Optional[KVCacheState] = None
        self._sessions: typing.Dict[typing.Any, _Session] = {}
        self._seq = 0
        self._grp = None
        self._ttft = None
        self._restored_seq = 0

    # -- lifecycle ---------------------------------------------------------
    def open(self) -> None:
        from flink_tensorflow_tpu_torch.functions.runner import (
            DecodeStepRunner,
            PagedDecodeStepRunner,
        )

        cfg = self.serving_config
        if self.device is None:
            self.device = resolve_device(self.ctx.device if self.ctx is not None else None)
        model_cap = (self.model.metadata.get("config") or {}).get("capacity")
        if model_cap is not None and model_cap < cfg.capacity:
            raise ValueError(
                f"serving capacity {cfg.capacity} exceeds the model's "
                f"positional capacity {model_cap} — shrink "
                "ServingConfig.capacity or rebuild the model")
        grp = self.ctx.metrics if self.ctx else None
        if grp is not None and self.device.type == "cuda":
            # Device memory in use before this subtask's pool exists: after
            # a restart it shows whether a failed attempt's pool lingers.
            grp.histogram("device_bytes_at_open").record(
                torch.cuda.memory_allocated(self.device))
        self._sched = TokenBudgetScheduler(cfg)
        self._cache = KVCacheState(self.keyed_state)
        self._paged = cfg.paged_kv
        common = dict(pool_slots=cfg.max_active_seqs, capacity=cfg.capacity,
                      padding_buckets=cfg.padding_buckets,
                      prompt_buckets=cfg.resolved_prompt_buckets(), device=self.device)
        if self._paged:
            self._runner = PagedDecodeStepRunner(
                self.model, page_tokens=cfg.page_tokens, num_pages=cfg.resolved_hbm_pages(),
                prefix_sharing=cfg.prefix_sharing, **common)
            self._tier = SessionTierManager(
                spill_dir=cfg.spill_dir,
                host_cache_sessions=cfg.host_cache_sessions,
                high_watermark=cfg.tier_high_watermark,
                low_watermark=cfg.tier_low_watermark,
                subtask_index=self.ctx.subtask_index if self.ctx else 0,
            )
        else:
            self._runner = DecodeStepRunner(self.model, **common)
        self._runner.open(self.ctx)
        if cfg.warmup_compile:
            self._runner.warmup(cfg.resolved_admit_buckets(),
                                cfg.resolved_prompt_buckets(), cfg.prefill_token_budget)
        self._seq = self._restored_seq
        self._grp = grp
        if grp is not None:
            sched = self._sched
            runner = self._runner
            grp.gauge("active_seqs", lambda s=sched: len(s.active))
            grp.gauge("waiting_seqs", lambda s=sched: len(s.waiting))
            grp.gauge("tokens_in_use", lambda s=sched: s.tokens_in_use)
            grp.gauge("admitted", lambda s=sched: s.counters.admitted)
            grp.gauge("evicted", lambda s=sched: s.counters.evicted)
            grp.gauge("preempted", lambda s=sched: s.counters.preempted)
            grp.gauge("rejected", lambda s=sched: s.counters.rejected)
            grp.gauge("serving_steps", lambda s=sched: s.counters.steps)
            grp.gauge("prefill_budget_held", lambda s=sched: s.prefill_budget_held)
            grp.gauge("step_h2d_bytes", lambda r=runner: r.step_h2d_bytes)
            grp.gauge("cache_h2d_blocks", lambda r=runner: r.block_h2d_events)
            grp.gauge("cache_d2h_blocks", lambda r=runner: r.block_d2h_events)
            grp.gauge("cache_resident_moves",
                      lambda r=runner: r.device_block_moves)
            if self._paged:
                pool = runner.pool
                tier = self._tier
                grp.gauge("kv_pages_total", lambda p=pool: p.num_pages)
                grp.gauge("kv_pages_free", lambda p=pool: p.free_pages)
                grp.gauge("kv_page_occupancy_pct",
                          lambda p=pool: 100.0 * p.occupancy_frac())
                grp.gauge("kv_pages_shared", lambda p=pool: p.pages_shared)
                grp.gauge("kv_cow_splits", lambda p=pool: p.cow_splits)
                if runner.index is not None:
                    grp.gauge("kv_indexed_pages",
                              lambda i=runner.index: i.indexed_pages)
                grp.gauge("kv_demoted_sessions", lambda t=tier: t.demoted)
                grp.gauge("kv_spilled_sessions", lambda t=tier: t.spilled)
                grp.gauge("kv_revived_warm", lambda t=tier: t.revived_warm)
                grp.gauge("kv_revived_cold", lambda t=tier: t.revived_cold)
                # Demote/spill/revive churn.
                grp.gauge("kv_tier_moves", lambda t=tier: t.tier_moves)
            # Time-to-first-token: arrival -> first generated token emitted.
            self._ttft = grp.histogram("ttft_s")
        # Restore: sessions found in keyed state re-enter the waiting
        # queue in arrival order; their KV blocks re-admit without
        # re-prefill.
        pending = []
        for key in self._cache.keys():
            st = self._cache.get(key)
            if st is None:
                continue
            sess = _Session.thaw(st)
            self._sessions[key] = sess
            if sess.status == DONE:
                continue
            sess.status = WAITING
            if self._tier is not None and isinstance(sess.kv, KVBlock):
                # Restored blocks land on the warm rung: host-resident
                # until re-admission (spilled stubs stay cold on disk).
                self._tier.note_warm(key)
            pending.append((sess.seq, key))
        for _, key in sorted(pending):
            sess = self._sessions[key]
            # Replay the restored prefix downstream (at-least-once), then
            # continue generating from the cache.
            for idx, tok in enumerate(sess.generated):
                self.output.emit(TokenEvent(
                    session_id=key, index=idx, token=int(tok),
                    finished=False, meta=sess.meta,
                ))
            sess.emitted = len(sess.generated)
            self._sched.enqueue(key)

    def close(self) -> None:
        if self._runner is not None:
            self._runner.close()
        # Device-resident blocks and parked pages of preempted sessions go
        # with the pool: a closed operator holds no device memory (a
        # restarted job opens a new one while this object may still be
        # referenced).
        for sess in self._sessions.values():
            if isinstance(sess.kv, (DeviceKVBlock, PagedKVHandle)):
                sess.kv = None

    # -- record path -------------------------------------------------------
    def process_record(self, record: el.StreamRecord) -> None:
        req = record.value
        if not isinstance(req, GenerateRequest):
            raise TypeError(
                f"{self.name}: expected GenerateRequest, got {type(req).__name__}")
        key = (self.key_selector(req) if self.key_selector is not None
               else req.session_id)
        if key in self._sessions:
            return  # replay / duplicate submission of a known session
        cfg = self.serving_config
        if not (0 < len(req.prompt) and
                len(req.prompt) + req.max_new_tokens <= cfg.capacity):
            self._sched.counters.rejected += 1
            self.output.emit(TokenEvent(
                session_id=req.session_id, index=-1, token=-1, finished=True,
                meta={**req.meta, "rejected": "capacity"},
            ))
            return
        self._seq += 1
        self._sessions[key] = _Session(
            self._seq, req.prompt, req.max_new_tokens, req.eos_token,
            dict(req.meta), arrived=time.monotonic())
        self._sched.enqueue(key)

    # -- timer-driven step loop -------------------------------------------
    @property
    def uses_timers(self) -> bool:
        return True

    def next_deadline(self) -> typing.Optional[float]:
        # Epoch-zero deadline = fire on the very next loop iteration.
        return 0.0 if (self._sched is not None and self._sched.has_work) else None

    def fire_due(self, now: float) -> None:
        if self._sched is not None and self._sched.has_work:
            self._serving_step()

    def finish(self) -> None:
        # End of input: drain every admitted session, with a generous
        # ceiling so a logic bug fails loudly instead of spinning.
        guard = 0
        ceiling = (self.serving_config.capacity + 4) * (
            len(self._sched.waiting) + len(self._sched.active) + 1)
        while self._sched.has_work:
            self._serving_step()
            guard += 1
            if guard > ceiling:
                raise RuntimeError(
                    f"{self.name}: serving drain exceeded {ceiling} steps "
                    f"with {len(self._sched.active)} active / "
                    f"{len(self._sched.waiting)} waiting sessions")

    # -- the serving step --------------------------------------------------
    def _append_token(self, key, sess: _Session, token: int, finished: bool) -> None:
        index = len(sess.generated)
        sess.generated.append(token)
        if index == 0 and sess.arrived is not None:
            if self._ttft is not None:
                self._ttft.record(time.monotonic() - sess.arrived)
            sess.arrived = None
        if index >= sess.emitted:
            self.output.emit(TokenEvent(
                session_id=key, index=index, token=token,
                finished=finished, meta=sess.meta,
            ))
            sess.emitted = index + 1

    def _ends(self, sess: _Session, tok: int) -> bool:
        """Whether the token about to be appended ends the session."""
        if len(sess.generated) + 1 >= sess.max_new:
            return True
        return sess.eos is not None and tok == sess.eos

    def _finish_session(self, key, slot: int, sess: _Session) -> None:
        """A session generated its last token: publish and free its pages
        (paged) and release the scheduler slot."""
        sess.status = DONE
        if self._paged:
            # Cache-valid tokens: the final generated token was never fed
            # back, so the pages hold prompt + generated[:-1].
            cached = [int(t) for t in sess.prompt] + [int(t) for t in sess.generated[:-1]]
            self._runner.release_finished(slot, cached, self._sched.lengths[key])
            self._tier.note_gone(key)
        self._sched.release(key, reason="finished")

    # -- paged tier machinery ---------------------------------------------
    def _demote_parked(self, key) -> None:
        """Hot -> warm: a parked session's pages gather D2H and free."""
        sess = self._sessions[key]
        sess.kv = self._runner.demote_handle(sess.kv)
        self._tier.demoted += 1
        self._tier.note_warm(key)

    def _preempt_to_host(self, key) -> None:
        """Pressure preemption of an ACTIVE session straight to the warm
        tier (its pages are the ransom)."""
        sched = self._sched
        slot = sched.slot_of(key)
        length = sched.lengths[key]
        k, v = self._runner.extract_host(slot, length)
        sess = self._sessions[key]
        sess.kv = KVBlock(k, v, length)
        sess.status = WAITING
        sched.preempt(key)
        self._tier.demoted += 1
        self._tier.note_warm(key)

    def _paged_make_room(self, pages_needed: int, *, protect=None,
                         preempt: bool = True) -> bool:
        """Free pages for an allocation the pool couldn't satisfy: demote
        parked hot sessions LRU-first, then (last resort, and never during
        admission — a just-admitted session has no block table to extract
        yet) preempt the newest active sessions to the warm tier."""
        pool = self._runner.pool
        # The generator re-checks live occupancy after every demotion —
        # iterate it directly (list() would spin on the first key).
        for key in self._tier.demotions(
                pool.occupancy_frac, force_pages=pages_needed,
                free_pages=lambda: pool.free_pages):
            self._demote_parked(key)
        if pool.free_pages >= pages_needed:
            return True
        if preempt:
            for key in reversed(list(self._sched.active)):
                if key == protect:
                    continue
                self._preempt_to_host(key)
                if pool.free_pages >= pages_needed:
                    return True
        return pool.free_pages >= pages_needed

    def _tier_sweep(self) -> None:
        """End-of-step watermark pass: parked sessions demote above the
        high watermark (draining to the low one), and the warm rung spills
        its overflow to disk."""
        if not self.serving_config.tiering:
            return
        pool = self._runner.pool
        for key in self._tier.demotions(pool.occupancy_frac):
            self._demote_parked(key)
        for key in self._tier.overflow_spills():
            sess = self._sessions[key]
            sess.kv = self._tier.spill(key, sess.kv)

    def _admit_gate(self):
        """The paged pool's page check for ``plan_admissions``: a session
        is seated only if its pages (length + 1 positions) are free or
        evictable from the prefix index, after demoting parked sessions;
        pages are reserved across the sessions of one admission."""
        sessions, runner = self._sessions, self._runner
        pool = runner.pool
        reserved = [0]

        def admit_gate(key, length):
            if isinstance(sessions[key].kv, PagedKVHandle):
                return True  # hot: its pages are already held on the device
            need = pool.pages_for(length + 1)
            # Evictable = free + index-only pages: the allocator evicts
            # the prefix index lazily, so counting only the free list
            # would wedge admission behind a fully indexed pool.
            if runner.free_pages_evictable() - reserved[0] < need:
                self._paged_make_room(need + reserved[0], preempt=False)
            if runner.free_pages_evictable() - reserved[0] < need:
                return False
            reserved[0] += need
            return True

        return admit_gate

    def _revive(self, key, slot: int, sess: _Session) -> None:
        """A resumed paged session's cache re-enters the pool: no traffic
        for hot pages, one H2D for a warm block, a disk read and an H2D
        for a cold one."""
        kv, tier_from = sess.kv, None
        if isinstance(kv, SpilledKVBlock):
            kv = self._tier.revive(kv)
            tier_from = "cold"
        elif isinstance(kv, KVBlock):
            tier_from = "warm"
        if isinstance(kv, PagedKVHandle):
            self._runner.attach(slot, kv)
        else:
            self._runner.insert_block(slot, kv.k, kv.v, length=kv.length)
        self._tier.note_admitted(key, tier=tier_from)

    def _serving_step(self) -> None:
        sched = self._sched
        cfg = self.serving_config
        sessions = self._sessions
        sched.counters.steps += 1

        # 1) Admission under max_active_seqs + token budget.
        def length_of(key):
            sess = sessions[key]
            return sess.kv.length if sess.kv is not None else len(sess.prompt)

        def prefill_of(key):
            sess = sessions[key]
            return 0 if sess.kv is not None else len(sess.prompt)

        fresh: typing.List[typing.Tuple[typing.Any, int, _Session]] = []
        admit_gate = self._admit_gate() if self._paged else None
        for key, slot in sched.plan_admissions(length_of, admit_gate, prefill_of):
            sess = sessions[key]
            sess.status = ACTIVE
            if sess.kv is not None:
                # Resume: the checkpointed/preempted/tiered cache re-enters
                # the pool (plan_admissions already booked kv.length).
                if self._paged:
                    self._revive(key, slot, sess)
                else:
                    self._runner.insert_block(slot, sess.kv.k, sess.kv.v)
                sess.kv = None
            else:
                fresh.append((key, slot, sess))

        # 2) Prefill freshly admitted sessions in one bucketed batch.
        if fresh:
            first = self._runner.prefill(
                [sess.prompt for _, _, sess in fresh],
                [len(sess.prompt) for _, _, sess in fresh],
                [slot for _, slot, _ in fresh],
                batch_bucket=cfg.bucket_admit(len(fresh)),
            )
            for (key, slot, sess), tok in zip(fresh, first):
                tok = int(tok)
                ends = self._ends(sess, tok)
                self._append_token(key, sess, tok, ends)
                if ends:
                    self._finish_session(key, slot, sess)

        # 3) One decode step over the whole active set.  Paged: the write
        # position must land in an exclusively owned page first —
        # page-boundary growth allocates, shared bytes copy-on-write
        # split, and a dry pool demotes parked sessions (or, last resort,
        # preempts the newest active) until the write can land.
        if self._paged:
            for key in list(sched.active):
                slot = sched.active.get(key)
                if slot is None:
                    continue  # preempted by a make_room below
                while not self._runner.ensure_writable(slot, sched.lengths[key]):
                    if not self._paged_make_room(1, protect=key):
                        raise RuntimeError(
                            f"{self.name}: cannot free a single KV page "
                            f"for session {key!r} — pool of "
                            f"{self._runner.num_pages} pages is pinned")
        if sched.active:
            slots = self._runner.pool_slots
            tokens = [0] * slots
            lengths = [0] * slots
            active_slots = []
            order = list(sched.active.items())
            for key, slot in order:
                tokens[slot] = sessions[key].generated[-1]
                lengths[slot] = sched.lengths[key]
                active_slots.append(slot)
            next_tokens = self._runner.decode_step(tokens, lengths, active_slots)
            for key, slot in order:
                sess = sessions[key]
                tok = int(next_tokens[slot])
                sched.grow(key)
                ends = self._ends(sess, tok)
                self._append_token(key, sess, tok, ends)
                if ends:
                    self._finish_session(key, slot, sess)

        # 4) Budget enforcement: preempt the newest sessions; their cache
        # follows them into keyed state.  Paged sessions PARK — pages stay
        # on the device, the tier sweep decides if they demote; dense
        # blocks move device-resident or to host per config.
        for key in sched.over_budget():
            slot = sched.slot_of(key)
            length = sched.lengths[key]
            sess = sessions[key]
            if self._paged:
                sess.kv = self._runner.park(slot, length)
                self._tier.note_parked(key)
            else:
                k, v = self._runner.extract_block(
                    slot, length, host=not cfg.device_resident_blocks)
                sess.kv = (DeviceKVBlock(k, v, length) if cfg.device_resident_blocks
                           else KVBlock(k, v, length))
            sess.status = WAITING
            sched.preempt(key)

        # 5) Tier ladder: watermark demotions + warm-rung disk spill.
        if self._paged:
            self._tier_sweep()

    # -- snapshot hooks ----------------------------------------------------
    def _function_snapshot(self, checkpoint_id=None):
        """Barrier sync: sessions freeze into keyed state — active caches
        land as picklable host blocks — before the base class copies the
        keyed tables."""
        sched, cache = self._sched, self._cache
        if sched is None:
            return None
        t0 = time.monotonic()
        for key, sess in self._sessions.items():
            if sess.status == ACTIVE:
                slot = sched.active[key]
                length = sched.lengths[key]
                if self._paged:
                    k, v = self._runner.snapshot_block(slot, length)
                else:
                    k, v = self._runner.extract_block(slot, length, host=True)
                # The pool stays authoritative; the frozen copy is the
                # restore point.
                cache.put(key, dataclasses.replace(
                    sess.freeze(), kv=KVBlock(k, v, length)))
            else:
                if isinstance(sess.kv, DeviceKVBlock):
                    sess.kv = sess.kv.to_host()
                elif isinstance(sess.kv, PagedKVHandle):
                    # Parked pages cannot cross a pickle boundary: the
                    # barrier demotes them to a host block.
                    self._demote_parked(key)
                cache.put(key, sess.freeze())
        if self._grp is not None:
            self._grp.histogram("cache_sync_s").record(time.monotonic() - t0)
        return None

    def _operator_snapshot(self):
        return {"seq": self._seq}

    def _operator_restore(self, state):
        self._restored_seq = state["seq"]
        self._seq = state["seq"]

    def _rescale_operator_state(self, states, mine):
        # The arrival counter is per-subtask but only needs to stay ahead
        # of every restored session's seq: take the max.
        return {"seq": max((s["seq"] for s in states if s), default=0)}


def continuous_batching(keyed_stream, model: "Model", *,
                        config: typing.Optional[ServingConfig] = None,
                        name: str = "continuous_batching",
                        parallelism: typing.Optional[int] = None):
    """Attach a continuous-batching generation operator to a keyed stream
    of :class:`GenerateRequest` records (key = session id)::

        tokens = serving.continuous_batching(
            requests.key_by(lambda r: r.session_id), model,
            config=ServingConfig(max_active_seqs=8, token_budget=512))

    Returns the :class:`TokenEvent` stream.  The edge hashes by session
    id, so the KV cache rescales by key group with the rest of the job's
    keyed state.  Each subtask runs on the job's device provider's answer
    for it, else on ``cuda``."""
    from flink_tensorflow_tpu_torch.core.stream import DataStream, KeyedStream

    if not isinstance(keyed_stream, KeyedStream):
        raise TypeError(
            "continuous_batching requires a KeyedStream (key_by the session id) — "
            "an unkeyed edge would split sessions' caches across subtasks")
    env = keyed_stream.env
    parallelism = parallelism or env.default_parallelism
    selector = keyed_stream.key_selector
    t = env.graph.add(
        name,
        lambda: ContinuousBatchingOperator(name, model, config, key_selector=selector,
                                           device_from_context=True),
        parallelism, inputs=[keyed_stream._edge()])
    return DataStream(env, t)
