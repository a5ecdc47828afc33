"""``serve``: a closed loop of generation requests, keyed by session, into
the program's ``continuous_batching`` on the configuration's decoder;
one record is one request, counted when its last token reaches the sink.

The check takes a sample of the requests that finished inside the
window, drawn from the seed, and runs the reference once over each
prompt with its served tokens: ``token_gap`` is the widest gap by which a
served token's logit lies below the reference's best at its position,
over that position's spread of logits (the tokens are greedy).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import jobs, weights
from benchmark.kinds.stream import Reservoir
from benchmark.reference import arith as ref_arith
from benchmark.reference import count as counting
from flink_tensorflow_tpu_torch import serving
from flink_tensorflow_tpu_torch.models.base import Model
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def


class ServeJob(jobs.Job):
    kind = "serve"
    loop = "inference"

    def __init__(self, cell, seed, device, trace):
        super().__init__(cell, seed, device, trace)
        config, mix = self.config, self.mix
        self.new_tokens = int(mix["new_tokens"])
        rng = np.random.default_rng([int(seed), 4])
        self.prompts = rng.integers(1, int(config["port"]["vocab_size"]),
                                    (int(mix["prompts"]), int(mix["prompt_tokens"])),
                                    dtype=np.int32)
        mdef = get_model_def(config["architecture"], **config["port"])
        with torch.device(device):
            module = mdef.module(**mdef.config)
        weights.into_program(config, module, seed, device)
        model = Model(mdef.architecture, module.eval(), mdef.methods,
                      metadata={"architecture": mdef.architecture, "config": dict(mdef.config)})
        self.kept = Reservoir(int(mix["check_sample"]), seed)
        self.served = {}
        self.short = 0
        source = jobs.Closed(self.make, int(mix["refill"]), self.feed, int(mix["outstanding"]))
        keyed = self.env.from_source(source, name="source").key_by(lambda r: r.session_id)
        cfg = serving.ServingConfig(max_active_seqs=int(mix["max_active_seqs"]),
                                    token_budget=int(mix["token_budget"]),
                                    capacity=int(mix["capacity"]))
        serving.continuous_batching(keyed, model, config=cfg, name="serve",
                                    parallelism=1).sink_to_callable(self.sink)

    def make(self, i: int) -> serving.GenerateRequest:
        return serving.GenerateRequest(session_id=i, prompt=self.prompts[i % len(self.prompts)],
                                       max_new_tokens=self.new_tokens)

    def sink(self, event) -> None:
        now = time.monotonic()
        sid = event.session_id
        tokens = self.served.setdefault(sid, [])
        if event.index >= 0:
            tokens.append(int(event.token))
        if not event.finished:
            return
        del self.served[sid]
        if len(tokens) != self.new_tokens:     # rejected, or cut short
            self.short += 1
        with self.lock:
            self.times.append(now)
            self.ids.append(sid)
        self.feed.back(1)
        if self.t0 <= now < self.t1:
            self.kept.offer(lambda: (sid, tokens))

    def warm(self) -> bool:
        return len(self.times) >= int(self.mix["warmup_requests"])

    def check(self):
        ref = weights.reference_module(self.config, self.seed, self.device)
        ref_arith.no_tf32()
        gaps = [0.0]
        with torch.no_grad():
            for sid, tokens in sorted(self.kept.items):
                prompt = self.prompts[sid % len(self.prompts)]
                seq = np.concatenate([prompt, tokens[:-1]]).astype(np.int64)
                logits, _ = ref(torch.from_numpy(seq)[None].to(self.device))
                rows = logits[0, len(prompt) - 1:].double().cpu()
                served = torch.tensor(tokens)
                gap = rows.max(dim=1).values - rows[torch.arange(len(tokens)), served]
                gaps.append(float((gap / rows.std(dim=1)).max()))
        return {"token_gap": max(gaps)}, self.attempted(), self.failed()

    def attempted(self) -> int:
        return self.in_window(self.t0, self.t1) + self.failed()

    def failed(self) -> int:
        """Requests emitted that never finished, finished twice, or were
        rejected or cut short."""
        with self.lock:
            ids = list(self.ids)
        return (self.feed.emitted - len(set(ids))) + (len(ids) - len(set(ids))) + self.short

    def work_count(self) -> counting.Count:
        """A request: the prefill at its prompt's length, then a decode
        step for each token after the first over the growing cache."""
        config, mix = self.config, self.mix
        with torch.device("meta"):
            ref = weights.reference_class(config)(**weights.reference_kwargs(config))
            prompt = torch.zeros((1, int(mix["prompt_tokens"])), dtype=torch.long)
            step = torch.zeros((1, 1), dtype=torch.long)

        def request() -> None:
            with torch.no_grad():
                _, past = ref(prompt, last=True)
                for _ in range(self.new_tokens - 1):
                    _, past = ref(step, past, last=True)

        return counting.count_work(request, compute_dtype=config["compute_dtype"], records=1,
                                   matmul_dtype=config["compute_dtype"])


JOB = ServeJob
