"""The serving cell the port is measured on.

The JAX package's serving bench configuration (``bench.py:2609-2633``):
char transformer ``vocab_size=64, embed_dim=64, num_heads=4,
num_layers=3, capacity=64``; ``ServingConfig(max_active_seqs=8,
token_budget=448, capacity=64, prompt_buckets=(16,),
admit_buckets=(1, 2, 4, 8), warmup_compile=True)``; 96 requests from
``np.random.RandomState(11)`` with prompts of 6-16 tokens and
``max_new_tokens`` of 4-40.  Weights are random, from ``seed``.

Two functions run it: :func:`serve` feeds one operator through the port's
subtask loop in the calling thread, and :func:`keyed_job` /
:func:`serve_keyed` build the pipeline users call,
``StreamExecutionEnvironment -> from_collection -> key_by(session_id) ->
serving.continuous_batching(...) -> sink``, on the local executor.
:func:`open_loop_arm` runs one arm of the reference's serving bench under
open-loop arrivals (``bench.py:bench_serving.run_arm``, ``:2652-2760``):
a ``PacedSplitSource`` into continuous batching or into a fixed count
window.

:func:`paged_cell` builds the paged KV pool's arms on the same model, after
the JAX package's ``bench.py:bench_kveconomy`` (``:3726-3990``) and
``tests/test_serving_paged.py``.
"""

from __future__ import annotations

import dataclasses
import time
import typing

import numpy as np

from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.serving.records import GenerateRequest
from flink_tensorflow_tpu_torch.serving.scheduler import ServingConfig

CAPACITY = 64
PROMPT_HI = 16
MAX_NEW = 40
SESSIONS = 96
#: The bench's two offered loads, requests/s (both above the fixed arm's
#: flood capacity in the reference), and the schedule's shift past the
#: operators' ``open()`` (``bench.py:2593``, ``:2650``).
OPEN_LOOP_RATES = (400.0, 1200.0)
START_DELAY_S = 1.5
#: The fixed arm's window (``bench.py:2674``).
FIXED_WINDOW = 8
FIXED_TIMEOUT_S = 0.3
#: The continuous arm's counters that the bench reports.
SERVING_COUNTERS = ("admitted", "evicted", "preempted", "rejected", "serving_steps",
                    "step_h2d_bytes", "cache_h2d_blocks", "cache_d2h_blocks")


def serving_cell(seed: int = 0):
    """``(model_def, numpy weights, ServingConfig, requests)``."""
    cfg = ServingConfig(max_active_seqs=8, token_budget=8 * 56, capacity=CAPACITY,
                        prompt_buckets=(PROMPT_HI,), admit_buckets=(1, 2, 4, 8),
                        warmup_compile=True)
    mdef = get_model_def("char_transformer", vocab_size=64, embed_dim=64,
                         num_heads=4, num_layers=3, capacity=CAPACITY)
    rng = np.random.RandomState(11)
    requests = [
        GenerateRequest(
            session_id=f"s{i}",
            prompt=rng.randint(1, 64, (int(rng.randint(6, PROMPT_HI + 1)),)),
            max_new_tokens=int(rng.randint(4, MAX_NEW + 1)),
        )
        for i in range(SESSIONS)
    ]
    return mdef, mdef.init_params(seed), cfg, requests


def serve(model, cfg, requests, device=None):
    """Drive a :class:`ContinuousBatchingOperator` through the port's
    subtask loop, all requests fed back to back.  Returns ``(events,
    seconds from the first arrival to drained, metric group)``."""
    import torch

    from flink_tensorflow_tpu_torch.core.runtime import KeyedSubtask
    from flink_tensorflow_tpu_torch.serving.operator import ContinuousBatchingOperator

    op = ContinuousBatchingOperator("continuous_batching", model, cfg, device=device)
    sub = KeyedSubtask(op)
    sub.open()
    try:
        t0 = time.monotonic()
        for req in requests:
            sub.process(req)
        sub.finish()
        if op.device.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.monotonic() - t0
    finally:
        sub.close()
    return sub.emitted, seconds, sub.ctx.metrics


def keyed_job(model, cfg, requests, *, parallelism: int = 1, device=None,
              tap: typing.Optional[typing.Any] = None):
    """Build (without running) the keyed serving pipeline:
    ``from_collection(requests).key_by(session_id)`` ->
    ``continuous_batching(parallelism=...)`` -> optional ``tap`` (a
    ``MapFunction`` on the token events) -> a sink.  ``device`` goes to
    every subtask through the device provider (None: ``cuda``).  Returns
    ``(env, arrivals)``: ``arrivals`` fills with ``(monotonic seconds,
    TokenEvent)`` as events reach the sink."""
    from flink_tensorflow_tpu_torch.core.environment import StreamExecutionEnvironment
    from flink_tensorflow_tpu_torch.serving.operator import continuous_batching

    env = StreamExecutionEnvironment(parallelism=1)
    if device is not None:
        env.set_device_provider(lambda task, index: device)
    stream = continuous_batching(
        env.from_collection(requests).key_by(lambda r: r.session_id), model,
        config=cfg, parallelism=parallelism)
    if tap is not None:
        stream = stream.map(tap, name="tap")
    arrivals: typing.List[typing.Tuple[float, typing.Any]] = []
    # One sink subtask: its thread is the only writer.
    stream.sink_to_callable(lambda ev: arrivals.append((time.monotonic(), ev)))
    return env, arrivals


def serve_keyed(model, cfg, requests, *, parallelism: int = 1, device=None):
    """Run :func:`keyed_job` to the end.  Returns ``(events, seconds from
    the first event at the sink to the last, the serving subtask 0's metric
    group)``, the counterpart of :func:`serve`'s triple."""
    env, arrivals = keyed_job(model, cfg, requests, parallelism=parallelism, device=device)
    env.execute("serving", timeout=600)
    seconds = arrivals[-1][0] - arrivals[0][0] if arrivals else 0.0
    return ([ev for _, ev in arrivals], seconds,
            env.metric_registry.group("continuous_batching.0"))


@dataclasses.dataclass
class OpenLoopArm:
    """One arm's run: the bench's ``row``, the ``(emit time, TokenEvent)``
    pairs in sink order, and the environment (its plan and metrics)."""

    row: typing.Dict[str, typing.Any]
    events: typing.List[typing.Tuple[float, typing.Any]]
    env: typing.Any


def open_loop_arm(model, cfg, requests, arm: str, rate: float, *, device=None) -> OpenLoopArm:
    """One arm of the serving bench at offered load ``rate`` requests/s
    (``bench.py:bench_serving.run_arm`` without its traced pass):
    ``PacedSplitSource(requests, rate, num_splits=1, start_delay_s=1.5)`` into
    ``key_by(session_id) -> serving.continuous_batching`` (``arm=
    "continuous"``) or ``count_window(8, timeout_s=0.3) ->
    FixedWindowGenerateFunction`` (``"fixed"``), then a sink.  ``device``
    goes to every subtask (None: ``cuda``).

    The row: sessions, tokens, tokens/s over the span from the first
    scheduled arrival to the last emit, TTFT and per-token latency p50/p95
    from each request's ``sched_ts`` (ms); the continuous arm adds
    :data:`SERVING_COUNTERS`, summed over its subtasks."""
    from flink_tensorflow_tpu_torch.core.environment import StreamExecutionEnvironment
    from flink_tensorflow_tpu_torch.serving.baseline import FixedWindowGenerateFunction
    from flink_tensorflow_tpu_torch.serving.operator import continuous_batching
    from flink_tensorflow_tpu_torch.sources.paced import PacedSplitSource

    if arm not in ("continuous", "fixed"):
        raise ValueError(f"unknown arm {arm!r}")
    env = StreamExecutionEnvironment(parallelism=1)
    if device is not None:
        env.set_device_provider(lambda task, index: device)
    source = env.from_source(PacedSplitSource(requests, rate, num_splits=1,
                                              start_delay_s=START_DELAY_S),
                             name="sessions", parallelism=1)
    if arm == "continuous":
        stream = continuous_batching(source.key_by(lambda r: r.session_id), model, config=cfg)
    else:
        stream = source.count_window(FIXED_WINDOW, timeout_s=FIXED_TIMEOUT_S).apply(
            FixedWindowGenerateFunction(model, cfg), name="fixed_window_generate")
    events: typing.List[typing.Tuple[float, typing.Any]] = []
    stream.sink_to_callable(lambda ev: events.append((time.monotonic(), ev)))
    env.execute(f"serving-open-loop-{arm}", timeout=3600)

    tok_lat, ttft = [], []
    first_sched = last_emit = None
    for t_emit, ev in events:
        sched = ev.meta.get("sched_ts")
        if sched is None or ev.index < 0:
            continue
        first_sched = sched if first_sched is None else min(first_sched, sched)
        last_emit = t_emit if last_emit is None else max(last_emit, t_emit)
        tok_lat.append((t_emit - sched) * 1e3)
        if ev.index == 0:
            ttft.append((t_emit - sched) * 1e3)
    span = last_emit - first_sched if tok_lat else None
    pct = lambda xs, q: float(np.percentile(xs, q)) if xs else None  # noqa: E731
    row: typing.Dict[str, typing.Any] = {
        "arm": arm, "offered_rate_rps": rate,
        "sessions": len({ev.session_id for _, ev in events}),
        "tokens": len(tok_lat),
        "tokens_per_s": len(tok_lat) / span if span else None,
        "ttft_p50_ms": pct(ttft, 50), "ttft_p95_ms": pct(ttft, 95),
        "token_p50_ms": pct(tok_lat, 50), "token_p95_ms": pct(tok_lat, 95),
    }
    if arm == "continuous":
        report = env.metric_registry.report()
        for name in SERVING_COUNTERS:
            row[name] = sum(v for k, v in report.items() if k.endswith("." + name))
    return OpenLoopArm(row, events, env)


@dataclasses.dataclass
class PagedCell:
    """The paged pool's arms on the serving cell's model.

    - ``serving``: the cell's config with ``paged_kv=True, page_tokens=16``
      and the default page budget (8 seats x 4 pages);
    - ``dense_roomy`` and ``ladder``: the oversubscription ladder, each
      rung ``(factor, config)`` with ``hbm_pages = max(4, demand_pages //
      factor)``, 4 seats, a 64-token budget and every demotion spilled to
      disk; ``dense_roomy`` has the same seats and buckets and a budget
      that never preempts, and each rung must emit its tokens.  The
      watermarks are 0.25 / 0.1, not the JAX bench's 0.6 / 0.3: here the
      8x pool (32 pages) is as large as the cell's dense pool, the 64-token
      budget keeps about 8 pages hot, and at 0.6 the parked sessions never
      cross the watermark, so the 8x rung would never leave the device;
    - ``prefix``: ``(name, requests, config, adoptable pages per
      session)`` fleets run with sharing on (``config``) and off: bench_kveconomy's (16 sessions, a shared
      32-token prefix plus 4 tokens of their own, 8 new tokens) and
      ``TestPagedEqualsDense``'s (8 sessions of one 24-token prompt, 1.5
      pages, at 2 seats; 16 new tokens, so a finisher publishes the
      prompt's second page and every later admission splits it);
    - ``failover``: ``TestPagedFailover``'s schedule, 10 requests from
      ``RandomState(2)`` of 24 new tokens, 3 seats, budget 60, 8-token
      pages, 12 pages, every demotion spilled to disk."""

    requests: typing.List[GenerateRequest]
    serving: ServingConfig
    demand_pages: int
    dense_roomy: ServingConfig
    ladder: typing.List[typing.Tuple[int, ServingConfig]]
    prefix: typing.List[typing.Tuple[str, typing.List[GenerateRequest], ServingConfig, int]]
    failover_requests: typing.List[GenerateRequest]
    failover: ServingConfig


def paged_cell(requests: typing.Sequence[GenerateRequest], cfg: ServingConfig, *,
               spill_root: str, factors: typing.Sequence[int] = (8, 16, 32),
               vocab: int = 64) -> PagedCell:
    """The paged arms for ``requests`` under the cell's ``cfg`` (both from
    :func:`serving_cell`); spill directories go under ``spill_root``."""
    import os

    page_tokens = 16
    pages = lambda n: -(-int(n) // page_tokens)  # noqa: E731
    demand = sum(pages(len(r.prompt) + r.max_new_tokens) for r in requests)
    tiered = dict(prefix_sharing=False, host_cache_sessions=0)
    seats = dict(max_active_seqs=4, admit_buckets=(1, 2, 4), prompt_buckets=(PROMPT_HI,),
                 capacity=cfg.capacity, warmup_compile=cfg.warmup_compile)
    ladder = [(f, ServingConfig(**seats, token_budget=64, paged_kv=True,
                                page_tokens=page_tokens,
                                hbm_pages=max(cfg.capacity // page_tokens, demand // f),
                                tier_high_watermark=0.25, tier_low_watermark=0.1,
                                spill_dir=os.path.join(spill_root, f"x{f}"), **tiered))
              for f in factors]
    rng = np.random.RandomState(7)
    prefix = rng.randint(1, vocab, (2 * page_tokens,))
    shared = [GenerateRequest(session_id=f"p{i}",
                              prompt=np.concatenate([prefix, rng.randint(1, vocab, (4,))]),
                              max_new_tokens=8)
              for i in range(16)]
    one_prompt = np.arange(1, 1 + 3 * page_tokens // 2) % vocab
    same = [GenerateRequest(session_id=f"q{i}", prompt=one_prompt, max_new_tokens=16)
            for i in range(8)]
    share = dict(capacity=cfg.capacity, token_budget=2048, paged_kv=True,
                 page_tokens=page_tokens, warmup_compile=cfg.warmup_compile)
    rng = np.random.RandomState(2)
    failover_requests = [
        GenerateRequest(session_id=f"s{i}",
                        prompt=rng.randint(1, vocab, (int(rng.randint(4, 10)),)),
                        max_new_tokens=24)
        for i in range(10)]
    return PagedCell(
        requests=list(requests),
        serving=dataclasses.replace(cfg, paged_kv=True, page_tokens=page_tokens),
        demand_pages=demand,
        dense_roomy=ServingConfig(**seats, token_budget=2048),
        ladder=ladder,
        prefix=[("shared-prefix", shared, ServingConfig(max_active_seqs=4, **share), 2),
                ("one-prompt", same, ServingConfig(max_active_seqs=2, **share), 2)],
        failover_requests=failover_requests,
        failover=ServingConfig(max_active_seqs=3, token_budget=60, capacity=cfg.capacity,
                               paged_kv=True, page_tokens=8, hbm_pages=12,
                               tier_high_watermark=0.6, tier_low_watermark=0.3,
                               spill_dir=os.path.join(spill_root, "failover"),
                               warmup_compile=cfg.warmup_compile, **tiered),
    )
