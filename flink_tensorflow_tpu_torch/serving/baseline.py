"""Fixed count-window generation — the pre-continuous-batching baseline.

Port of ``flink_tensorflow_tpu/serving/baseline.py``.  Requests buffer
into a count window, then the WHOLE batch runs to completion before
anything is emitted.  Two structural costs against continuous batching:

- **time-to-first-token** pays the window fill wait plus a full batch
  generation (every session waits for the batch's LONGEST sequence);
- **tokens/s** sags because the batch thins as sessions finish.

Shares the model, :class:`~flink_tensorflow_tpu_torch.functions.runner.DecodeStepRunner`
and bucket config with the continuous path, so an arm delta is the
scheduling policy alone.
"""

from __future__ import annotations

import typing

from flink_tensorflow_tpu_torch.core import functions as fn
from flink_tensorflow_tpu_torch.serving.records import GenerateRequest, TokenEvent
from flink_tensorflow_tpu_torch.serving.scheduler import ServingConfig

if typing.TYPE_CHECKING:
    from flink_tensorflow_tpu_torch.models.base import Model


class FixedWindowGenerateFunction(fn.WindowFunction):
    """WindowFunction running one window of requests to completion.

    Apply under a count(-or-timeout) window::

        requests.count_window(8, timeout_s=0.5).apply(
            FixedWindowGenerateFunction(model, config))

    Runs on the subtask's device (the job's device provider), else on
    ``cuda``, which raises if CUDA is absent."""

    def __init__(self, model: "Model",
                 config: typing.Optional[ServingConfig] = None):
        self.model = model
        self.serving_config = config or ServingConfig()
        self._runner = None

    def clone(self):
        # Subtasks share the (read-only) model; each builds its own
        # runner at open().
        return FixedWindowGenerateFunction(self.model, self.serving_config)

    def open(self, ctx) -> None:
        from flink_tensorflow_tpu_torch.functions.runner import DecodeStepRunner

        cfg = self.serving_config
        self._runner = DecodeStepRunner(
            self.model,
            pool_slots=cfg.max_active_seqs,
            capacity=cfg.capacity,
            padding_buckets=cfg.padding_buckets,
            prompt_buckets=cfg.resolved_prompt_buckets(),
            device=ctx.device if ctx else None,
        )
        self._runner.open(ctx)
        if cfg.warmup_compile:
            self._runner.warmup(cfg.resolved_admit_buckets(),
                                cfg.resolved_prompt_buckets(), cfg.prefill_token_budget)

    def close(self) -> None:
        if self._runner is not None:
            self._runner.close()

    def process_window(self, key, window, elements, out: fn.Collector) -> None:
        cfg = self.serving_config
        runner = self._runner
        # Chunk the window by pool size; each chunk runs to completion.
        reqs = [r for r in elements if isinstance(r, GenerateRequest)]
        for base in range(0, len(reqs), cfg.max_active_seqs):
            chunk = reqs[base:base + cfg.max_active_seqs]
            chunk = [r for r in chunk
                     if 0 < len(r.prompt) + r.max_new_tokens <= cfg.capacity]
            if not chunk:
                continue
            first = runner.prefill(
                [r.prompt for r in chunk],
                [len(r.prompt) for r in chunk],
                list(range(len(chunk))),
                batch_bucket=cfg.bucket_admit(len(chunk)),
            )
            generated: typing.List[typing.List[int]] = [[int(t)] for t in first]
            lengths = [len(r.prompt) for r in chunk]
            alive = {i for i, r in enumerate(chunk) if not self._done(generated[i], r)}
            # Static batching: the whole chunk steps until every member
            # finishes; nothing is admitted or evicted mid-flight.
            while alive:
                tokens_by_slot = [0] * runner.pool_slots
                lengths_by_slot = [0] * runner.pool_slots
                for i in alive:
                    tokens_by_slot[i] = generated[i][-1]
                    lengths_by_slot[i] = lengths[i]
                nxt = runner.decode_step(tokens_by_slot, lengths_by_slot, sorted(alive))
                for i in list(alive):
                    generated[i].append(int(nxt[i]))
                    lengths[i] += 1
                    if self._done(generated[i], chunk[i]):
                        alive.discard(i)
            # Emission AFTER the whole chunk completes — the baseline's
            # defining latency cost.
            for i, r in enumerate(chunk):
                toks = generated[i]
                for idx, t in enumerate(toks):
                    out.collect(TokenEvent(
                        session_id=r.session_id, index=idx, token=t,
                        finished=idx == len(toks) - 1, meta=dict(r.meta),
                    ))

    @staticmethod
    def _done(generated: typing.List[int], req: GenerateRequest) -> bool:
        if len(generated) >= req.max_new_tokens:
            return True
        return req.eos_token is not None and generated[-1] == req.eos_token
