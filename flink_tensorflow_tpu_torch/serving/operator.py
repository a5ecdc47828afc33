"""ContinuousBatchingOperator — the serving plane's decode-step loop.

Port of ``flink_tensorflow_tpu/serving/operator.py:65-652`` for the dense
KV pool (the paged pool and session tiering are a later slice), with
:func:`continuous_batching`, the entry point that puts the operator on a
keyed stream of the port's streaming runtime.

One operator instance per subtask owns a slice of the session key space,
a :class:`~flink_tensorflow_tpu_torch.functions.runner.DecodeStepRunner`
whose KV pool stays on the device for the operator's life, and a
:class:`~flink_tensorflow_tpu_torch.serving.scheduler.TokenBudgetScheduler`.
The loop is timer-driven: while any session is active or waiting,
``next_deadline`` keeps the subtask loop hot and every ``fire_due`` runs
ONE serving step — admit, prefill, decode, emit, evict, preempt —
interleaved with request arrivals.

State: the hot path mutates plain per-session records (``_Session``);
the snapshot hook freezes every live session into keyed state as a
:class:`SessionState` (active caches copied to host :class:`KVBlock`
form, device-resident blocks downgraded to host form), and a restored
operator re-admits the sessions from their blocks without re-prefill,
continuing greedy decoding byte-identically.
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
from flink_tensorflow_tpu_torch.serving.records import GenerateRequest, TokenEvent
from flink_tensorflow_tpu_torch.serving.scheduler import (
    ServingConfig,
    TokenBudgetScheduler,
)
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
    """Keyed continuous-batching generation operator (dense KV pool).

    ``device``: where the model and pool live; ``None`` means ``cuda``
    and raises if CUDA is absent.  ``device_from_context=True`` (what
    :func:`continuous_batching` builds) defers the choice to ``open()``:
    the subtask's ``RuntimeContext.device`` (the job's device provider),
    else ``cuda``, which raises there if CUDA is absent."""

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
        self._cache: typing.Optional[KVCacheState] = None
        self._sessions: typing.Dict[typing.Any, _Session] = {}
        self._seq = 0
        self._grp = None
        self._ttft = None
        self._restored_seq = 0

    # -- lifecycle ---------------------------------------------------------
    def open(self) -> None:
        from flink_tensorflow_tpu_torch.functions.runner import DecodeStepRunner

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
        self._runner = DecodeStepRunner(
            self.model,
            pool_slots=cfg.max_active_seqs,
            capacity=cfg.capacity,
            prompt_buckets=cfg.resolved_prompt_buckets(),
            device=self.device,
        )
        self._runner.open(self.ctx)
        if cfg.warmup_compile:
            self._runner.warmup(cfg.resolved_admit_buckets(),
                                cfg.resolved_prompt_buckets())
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
            grp.gauge("step_h2d_bytes", lambda r=runner: r.step_h2d_bytes)
            grp.gauge("cache_h2d_blocks", lambda r=runner: r.block_h2d_events)
            grp.gauge("cache_d2h_blocks", lambda r=runner: r.block_d2h_events)
            grp.gauge("cache_resident_moves",
                      lambda r=runner: r.device_block_moves)
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
        # Device-resident blocks of preempted sessions go with the pool: a
        # closed operator holds no device memory (a restarted job opens a
        # new one while this object may still be referenced).
        for sess in self._sessions.values():
            if isinstance(sess.kv, DeviceKVBlock):
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

    def _finish_session(self, key, sess: _Session) -> None:
        sess.status = DONE
        self._sched.release(key, reason="finished")

    def _serving_step(self) -> None:
        sched = self._sched
        cfg = self.serving_config
        sessions = self._sessions
        sched.counters.steps += 1

        # 1) Admission under max_active_seqs + token budget.
        def length_of(key):
            sess = sessions[key]
            return sess.kv.length if sess.kv is not None else len(sess.prompt)

        fresh: typing.List[typing.Tuple[typing.Any, int, _Session]] = []
        for key, slot in sched.plan_admissions(length_of):
            sess = sessions[key]
            sess.status = ACTIVE
            if sess.kv is not None:
                # Resume: the checkpointed/preempted cache re-enters the pool.
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
            for (key, _, sess), tok in zip(fresh, first):
                tok = int(tok)
                ends = self._ends(sess, tok)
                self._append_token(key, sess, tok, ends)
                if ends:
                    self._finish_session(key, sess)

        # 3) One decode step over the whole active set.
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
                    self._finish_session(key, sess)

        # 4) Budget enforcement: preempt the newest sessions; their cache
        # follows them into keyed state (device-resident or host per config).
        for key in sched.over_budget():
            slot = sched.slot_of(key)
            length = sched.lengths[key]
            sess = sessions[key]
            k, v = self._runner.extract_block(
                slot, length, host=not cfg.device_resident_blocks)
            sess.kv = (DeviceKVBlock(k, v, length) if cfg.device_resident_blocks
                       else KVBlock(k, v, length))
            sess.status = WAITING
            sched.preempt(key)

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
                k, v = self._runner.extract_block(slot, length, host=True)
                # The pool stays authoritative; the frozen copy is the
                # restore point.
                cache.put(key, dataclasses.replace(
                    sess.freeze(), kv=KVBlock(k, v, length)))
            else:
                if isinstance(sess.kv, DeviceKVBlock):
                    sess.kv = sess.kv.to_host()
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
