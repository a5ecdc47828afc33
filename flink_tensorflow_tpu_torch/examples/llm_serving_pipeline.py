"""Streaming LLM serving: continuous batching with the KV cache as keyed
state.

Port of ``examples/llm_serving_pipeline.py``: generation requests arrive
on a Poisson schedule (``PacedSplitSource``), keyed by session id; the
continuous-batching operator admits and evicts sessions per decode step
under a token budget, and each session's KV cache lives in keyed state
(checkpointed, restorable, rescalable by key group).  The model is the
zoo's char transformer with random weights; every prefill batch runs the
hand-written flash-attention kernel (``csrc/flash_attention.cu``) once
per layer.

The job declares the card it runs on, for shardcheck's audit: a mesh of
one device and that device's memory as the budget.  The card this job is
measured on is an NVIDIA H100 80GB HBM3 at 700 W; ``--cpu`` declares the
host's memory instead.

Run:  python -m flink_tensorflow_tpu_torch.examples.llm_serving_pipeline --records 24 --cpu
"""

import os
import time

import numpy as np

from flink_tensorflow_tpu_torch.examples._common import base_parser, place, report

#: Char vocab: printable ASCII 32..126 at ids 1..95; 0 is padding.
VOCAB = 96

PROMPTS = [
    "the quick brown fox",
    "streaming systems",
    "tensor processing",
    "continuous batching",
    "keyed operator state",
    "flash attention",
    "exactly once",
    "token budget",
]


def encode(text: str) -> np.ndarray:
    return np.array([max(1, min(95, ord(c) - 31)) for c in text], np.int32)


def decode(tokens) -> str:
    return "".join(chr(max(32, min(126, t + 31))) for t in tokens if t > 0)


def parse(argv=None):
    args = base_parser(__doc__).parse_args(argv)
    if args.smoke:
        args.records = 8
    return args


def model_def(args):
    from flink_tensorflow_tpu_torch.models import get_model_def

    return get_model_def("char_transformer", vocab_size=VOCAB, embed_dim=64,
                         num_heads=4, num_layers=2, capacity=64)


def requests_of(args):
    from flink_tensorflow_tpu_torch.serving import GenerateRequest

    max_new = 8 if args.smoke else 16
    return [GenerateRequest(session_id=f"user-{i}", prompt=encode(PROMPTS[i % len(PROMPTS)]),
                            max_new_tokens=max_new)
            for i in range(args.records or 24)], max_new


def device_memory_bytes(args) -> int:
    """The memory of the device the job runs on: the card's, or under
    ``--cpu`` the host's."""
    if args.cpu:
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    import torch

    from flink_tensorflow_tpu_torch.utils.device import resolve_device

    return torch.cuda.get_device_properties(resolve_device(None)).total_memory


def run(args, params, events=None, metrics=None):
    """The job over ``params`` (the char transformer's numpy weights).
    ``events`` receives every ``TokenEvent`` and ``metrics`` the job's
    metrics.  Returns the report."""
    from flink_tensorflow_tpu_torch import serving
    from flink_tensorflow_tpu_torch.core import StreamExecutionEnvironment
    from flink_tensorflow_tpu_torch.parallel import abstract_mesh
    from flink_tensorflow_tpu_torch.sources import PacedSplitSource

    model = model_def(args).to_model(params)
    requests, max_new = requests_of(args)
    n = len(requests)

    env = place(StreamExecutionEnvironment(parallelism=args.parallelism), args)
    # The declared layout for shardcheck: one device and its memory.
    env.set_mesh(abstract_mesh({"data": 1}))
    env.set_hbm_budget(device_memory_bytes(args))
    out = (
        serving.continuous_batching(
            env.from_source(PacedSplitSource(requests, rate_hz=50.0, num_splits=4),
                            name="sessions", parallelism=1)
            .key_by(lambda r: r.session_id),
            model,
            config=serving.ServingConfig(max_active_seqs=8, token_budget=256, capacity=64),
            name="continuous_batching",
            parallelism=args.parallelism,
        )
        .sink_to_list()
    )
    t0 = time.time()
    job = env.execute("llm-serving", timeout=600)
    if events is not None:
        events.extend(out)
    if metrics is not None:
        metrics.update(job.metrics)

    sessions = {}
    for ev in out:
        sessions.setdefault(ev.session_id, {})[ev.index] = ev.token
    completions = {sid: decode([toks[i] for i in sorted(toks)])
                   for sid, toks in sessions.items()}
    for sid in sorted(completions)[:4]:
        print(f"  {sid}: {completions[sid]!r}")
    return report("llm_serving_pipeline", job.metrics, t0, n, {
        "sessions": len(sessions),
        "tokens": sum(len(t) for t in sessions.values()),
        "all_sessions_completed": all(len(t) == max_new for t in sessions.values()),
    })


def main(argv=None):
    args = parse(argv)
    return run(args, model_def(args).init_fn(0))


if __name__ == "__main__":
    main()
