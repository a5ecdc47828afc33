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
"""

from __future__ import annotations

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
