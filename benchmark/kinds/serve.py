"""``serve``: a closed loop of generation requests, keyed by session, into
the program's ``continuous_batching`` on the configuration's decoder; one
record is one request, counted when its last token reaches the sink.

The mix draws a pool of ``prompts`` requests from the seed: prompt
lengths log-uniform on ``[prompt_min, prompt_max]``, token ids uniform
over the vocabulary, and each a number of greedy new tokens uniform on
``[new_min, new_max]``; request ``i`` is pool entry ``i % prompts``.
``outstanding`` requests are kept in flight, refilled ``refill`` at a
time.

The check takes a sample of the requests that finished inside the window,
drawn from the seed, frees the program's module and pool, and runs the
reference over each prompt with its served tokens, one layer at a time,
each layer's weights made again alone (``weights.reference_tensors``):
``token_gap`` is the widest gap by which a served token's logit lies below
the reference's best at its position, over that position's spread of
logits (the tokens are greedy).  The reference is laid out as
``reference/deepseek_v2.py`` is: ``embed``, ``layers`` (each called as
``layer(x, start, arith=...)``), ``norm_gamma`` and ``head``.

The traced count (``work_count``) prices the pool's mean request: its
prefill at its prompt's length (the reference on meta tensors at three
lengths; every operation's FLOPs and bytes are quadratic in the length),
then a decode step for each further token over the growing cache, priced
from a step of ``max_active_seqs`` rows at two cache lengths (affine in
the length) and shared out over those rows.  So the weights a step reads
are counted once a step for all its rows: the count's least time is a
lower bound of the batched work, never a batch of one's.

    python3 -m benchmark.kinds.serve --workload <cell> --seeds 1,2,3 --seconds 20

is the control of the cell's limits (``PERF.md``): per seed it runs the
cell, then reads the program's ``token_gap`` and, over the same sampled
requests, that of the reference computed with fp8 operands
(``reference/arith.py``) put in the program's place (its own greedy choice
at each position), both judged at the cell's limits; it exits 1 if a
control comes out correct.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time

import numpy as np
import torch

from benchmark import check as checking
from benchmark import jobs, weights
from benchmark.kinds.stream import Reservoir
from benchmark.reference import arith as ref_arith
from benchmark.reference import count as counting
from benchmark.reference.deepseek_v2 import rms_norm
from flink_tensorflow_tpu_torch import serving
from flink_tensorflow_tpu_torch.models.base import Model
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def


def request_pool(seed: int, mix, vocab: int):
    """``(prompts, new tokens)`` of the seeded pool."""
    rng = np.random.default_rng([int(seed), 4])
    n = int(mix["prompts"])
    lo, hi = math.log(mix["prompt_min"]), math.log(mix["prompt_max"])
    lengths = np.minimum(np.exp(rng.uniform(lo, hi, n)).astype(np.int64), mix["prompt_max"])
    ids = rng.integers(0, vocab, int(lengths.sum()), dtype=np.int32)
    prompts = np.split(ids, np.cumsum(lengths)[:-1])
    new = rng.integers(int(mix["new_min"]), int(mix["new_max"]) + 1, n)
    return prompts, new


class ServeJob(jobs.Job):
    kind = "serve"
    loop = "inference"

    def __init__(self, cell, seed, device, trace):
        super().__init__(cell, seed, device, trace)
        config, mix = self.config, self.mix
        self.prompts, self.new = request_pool(seed, mix, int(config["port"]["vocab_size"]))
        mdef = get_model_def(config["architecture"], **config["port"])
        with torch.device(device):
            module = mdef.make_module()
        weights.into_program(config, module, seed, device)
        self.model = Model(mdef.architecture, module.eval(), mdef.methods,
                           metadata={"architecture": mdef.architecture,
                                     "config": dict(mdef.config)})
        self.kept = Reservoir(int(mix["check_sample"]), seed)
        self.served = {}
        self.short = 0
        source = jobs.Closed(self.make, int(mix["refill"]), self.feed, int(mix["outstanding"]))
        keyed = self.env.from_source(source, name="source").key_by(lambda r: r.session_id)
        cfg = serving.ServingConfig(
            max_active_seqs=int(mix["max_active_seqs"]), token_budget=int(mix["token_budget"]),
            capacity=int(mix["capacity"]), prefill_token_budget=mix.get("prefill_token_budget"),
            prompt_buckets=tuple(mix["prompt_buckets"]), admit_buckets=tuple(mix["admit_buckets"]),
            warmup_compile=bool(mix.get("warmup_compile", False)))
        serving.continuous_batching(keyed, self.model, config=cfg, name="serve",
                                    parallelism=1).sink_to_callable(self.sink)

    def entry(self, sid: int) -> int:
        return sid % len(self.prompts)

    def make(self, i: int) -> serving.GenerateRequest:
        k = self.entry(i)
        return serving.GenerateRequest(session_id=i, prompt=self.prompts[k],
                                       max_new_tokens=int(self.new[k]))

    def sink(self, event) -> None:
        now = time.monotonic()
        sid = event.session_id
        tokens = self.served.setdefault(sid, [])
        if event.index >= 0:
            tokens.append(int(event.token))
        if not event.finished:
            return
        del self.served[sid]
        if len(tokens) != int(self.new[self.entry(sid)]):     # rejected, or cut short
            self.short += 1
        with self.lock:
            self.times.append(now)
            self.ids.append(sid)
        self.feed.back(1)
        if self.t0 <= now < self.t1:
            self.kept.offer(lambda: (sid, tokens))

    def warm(self) -> bool:
        return len(self.times) >= int(self.mix["warmup_requests"])

    # -- the check -------------------------------------------------------------
    def free_program(self) -> None:
        """Drop the program's module (its runner and pool went with the
        job's end), so the reference has the card."""
        self.model.params = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def gaps(self, control=None) -> list:
        """``token_gap`` of the sampled requests: the served tokens' under
        the exact reference, then, with a ``control`` arithmetic, that
        arithmetic's own greedy choice at each position, judged under the
        exact logits.  The reference runs a layer at a time over the
        sequences, each layer's weights made again alone."""
        config, dev = self.config, self.device
        ariths = [None] + ([control] if control is not None else [])
        ref_arith.no_tf32()
        with torch.device("meta"):
            ref = weights.reference_class(config)(**weights.reference_kwargs(config))
        kept = sorted(self.kept.items)
        seqs = [torch.from_numpy(np.concatenate([self.prompts[self.entry(sid)], tokens[:-1]])
                                 .astype(np.int64)).to(dev) for sid, tokens in kept]
        with torch.no_grad():
            emb = weights.reference_tensors(config, self.seed, dev, lambda n: n == "embed")
            xs = [[emb["embed"][s][None] for s in seqs] for _ in ariths]
            del emb
            for i, layer in enumerate(ref.layers):
                prefix = f"layers.{i}."
                w = {k[len(prefix):]: v for k, v in weights.reference_tensors(
                    config, self.seed, dev, lambda n: n.startswith(prefix)).items()}
                for a, arith in enumerate(ariths):
                    for j, x in enumerate(xs[a]):
                        xs[a][j] = torch.func.functional_call(layer, w, (x, 0),
                                                              {"arith": arith})[0]
                del w
            w = weights.reference_tensors(config, self.seed, dev,
                                          lambda n: n in ("norm_gamma", "head"))
            out = []
            rows = []
            for a, arith in enumerate(ariths):
                gaps = [0.0]
                for j, (sid, tokens) in enumerate(kept):
                    p = len(self.prompts[self.entry(sid)])
                    lg = (arith or ref_arith.Exact()).linear(
                        rms_norm(xs[a][j][0, p - 1:], w["norm_gamma"], ref.c["rms_norm_eps"]),
                        w["head"], None)
                    if a == 0:
                        rows.append(lg.double().cpu())
                    exact = rows[j]
                    chosen = (torch.tensor(tokens) if arith is None
                              else lg.argmax(dim=1).cpu())
                    gap = exact.max(dim=1).values - exact[torch.arange(len(tokens)), chosen]
                    gaps.append(float((gap / exact.std(dim=1)).max()))
                out.append(max(gaps))
        return out

    def check(self):
        self.free_program()
        return {"token_gap": self.gaps()[0]}, self.attempted(), self.failed()

    def attempted(self) -> int:
        return self.in_window(self.t0, self.t1) + self.failed()

    def failed(self) -> int:
        """Requests emitted that never finished, finished twice, or were
        rejected or cut short."""
        with self.lock:
            ids = list(self.ids)
        return (self.feed.emitted - len(set(ids))) + (len(ids) - len(set(ids))) + self.short

    # -- the count -------------------------------------------------------------
    def work_count(self) -> counting.Count:
        config, mix = self.config, self.mix
        dtype = config["compute_dtype"]
        rows = int(mix["max_active_seqs"])
        with torch.device("meta"):
            ref = weights.reference_class(config)(**weights.reference_kwargs(config))
        layers = len(ref.layers)
        kw = ref.c

        def prefill(t):
            tokens = torch.zeros((1, t), dtype=torch.long, device="meta")
            return counting.count_work(lambda: ref(tokens, last=True), compute_dtype=dtype,
                                       records=1, matmul_dtype=dtype)

        def step(cache):
            tokens = torch.zeros((rows, 1), dtype=torch.long, device="meta")
            past = [(torch.zeros((rows, cache, kw["kv_lora_rank"]), device="meta"),
                     torch.zeros((rows, cache, kw["qk_rope_head_dim"]), device="meta"))
                    for _ in range(layers)]
            return counting.count_work(lambda: ref(tokens, past, last=True), compute_dtype=dtype,
                                       records=rows, matmul_dtype=dtype)

        with torch.no_grad():
            at = [int(mix["prompt_min"]), (int(mix["prompt_min"]) + int(mix["prompt_max"])) // 2,
                  int(mix["prompt_max"])]
            pre = [prefill(t) for t in at]
            lo, hi = int(mix["prompt_min"]), int(mix["prompt_max"])
            dec = [step(lo), step(hi)]
        lengths = np.array([len(p) for p in self.prompts], np.float64)
        steps = self.new.astype(np.float64) - 1
        # Sum over a request's steps of its cache length: P, P + 1, ...
        cache_sum = steps * lengths + steps * (steps - 1) / 2

        def quad(values):    # the mean over the pool of a quadratic through ``at``
            coef = np.polyfit(np.array(at, np.float64), np.array(values, np.float64), 2)
            return float(np.polyval(coef, lengths).mean())

        def affine(values):  # the mean over the pool of a request's steps
            slope = (values[1] - values[0]) / (hi - lo)
            base = values[0] - slope * lo
            return float((steps * base + slope * cache_sum).mean())

        work = [counting.Work(w.op, quad([c.work[i].flops for c in pre]),
                              quad([c.work[i].bytes for c in pre]))
                for i, w in enumerate(pre[0].work)]
        work += [counting.Work(w.op, affine([c.work[i].flops for c in dec]),
                               affine([c.work[i].bytes for c in dec]))
                 for i, w in enumerate(dec[0].work)]
        total = quad([c.total_flops for c in pre]) + affine([c.total_flops for c in dec])
        return counting.Count(work, total)


JOB = ServeJob


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=20.0)
    args = parser.parse_args(argv)
    from benchmark import run, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    passed = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        job = ServeJob(cell, seed, device, False)
        job.start()
        deadline = time.monotonic() + run.WARM_S
        while not job.warm():
            if time.monotonic() > deadline:
                job.stop()
                job.handle.wait(jobs.END_S)   # raises the job's failure
                raise RuntimeError("the job did not warm up")
            time.sleep(0.01)
        job.t0 = time.monotonic()
        job.t1 = job.t0 + args.seconds
        time.sleep(args.seconds)
        job.finish()
        job.free_program()
        program, control = job.gaps(ref_arith.Fp8())
        lost = job.failed()
        for name, value in (("program", program), ("fp8", control)):
            correct, shown, _ = checking.verdict({"token_gap": value}, cell.limits, lost)
            print(json.dumps({"workload": args.workload, "seed": seed, "run": name,
                              "correct": correct, "checked": shown,
                              "requests": len(job.kept.items),
                              "power_limit": run.power_limit()}), flush=True)
            passed += correct and name == "fp8"
        del job
        gc.collect()
        torch.cuda.empty_cache()
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
