"""The health plane over a paged keyed serving job on the card
(``cuda``-marked; it skips without an NVIDIA GPU).  This file imports
neither flax nor the JAX package, so it collects on a machine that has
neither.

A short paged job under ``JobConfig.health`` keeps the tokens of the same
job without it, launches the flash-attention kernel once per layer for
every prefill batch and warmup prefill (the paced source makes the batch
count depend on arrival times, so it is not held across runs), and
publishes a ``health.*`` gauge for the serving operator and the job.
"""

import numpy as np
import pytest
import torch

from flink_tensorflow_tpu_torch.metrics.health import HealthConfig
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.ops import flash_attention as fa
from flink_tensorflow_tpu_torch.serving import GenerateRequest, ServingConfig
from flink_tensorflow_tpu_torch.serving.cell import keyed_job

pytestmark = pytest.mark.cuda

CAPACITY = 40
CFG = dict(vocab_size=48, embed_dim=32, num_heads=2, num_layers=2, capacity=CAPACITY)
PAGED = ServingConfig(max_active_seqs=4, token_budget=40, capacity=CAPACITY, paged_kv=True,
                      page_tokens=8, hbm_pages=12, prefix_sharing=False,
                      host_cache_sessions=0)


def requests(n=12, max_new=8, seed=7):
    rng = np.random.RandomState(seed)
    return [GenerateRequest(session_id=f"s{i}",
                            prompt=rng.randint(1, 48, (int(rng.randint(4, 10)),)),
                            max_new_tokens=max_new) for i in range(n)]


def run(model, health):
    env, arrivals = keyed_job(model, PAGED, requests())
    env.configure(source_throttle_s=0.01)  # some ticks before the job ends
    if health:
        env.configure(health=HealthConfig(interval_s=0.05))
    fa.flash_attention.launches = 0
    handle = env.execute_async("paged-health")
    handle.wait(300)
    tokens = {}
    for _, ev in arrivals:
        tokens.setdefault(ev.session_id, []).append(ev.token)
    warm = (len(PAGED.resolved_admit_buckets()) * len(PAGED.resolved_prompt_buckets())
            if PAGED.warmup_compile else 0)
    prefills = handle.metrics.report()["continuous_batching.0.prefill_batches"]
    assert fa.flash_attention.launches == CFG["num_layers"] * (prefills + warm) > 0
    return tokens, handle


def test_paged_serving_under_the_health_plane_keeps_its_tokens():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    mdef = get_model_def("char_transformer", **CFG)
    model = mdef.to_model(mdef.init_params(0))
    want, _ = run(model, health=False)
    got, handle = run(model, health=True)
    assert got == want and len(got) == 12
    assert handle.health.ticks >= 1
    gauges = handle.metrics.snapshot()["health"]
    assert {"job", "continuous_batching"} <= set(gauges)
