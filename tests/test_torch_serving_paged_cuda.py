"""The port's paged KV pool on the card (``cuda``-marked; they skip
without an NVIDIA GPU).  This file imports neither flax nor the JAX
package, so it collects on a machine that has neither.

- The pool (pages + the scratch page) is allocated on ``cuda``.
- Paged serving on the card equals dense serving on the card, and both
  equal the CPU's paged run, with prefix sharing and with tiering.
- A paged decode step's H2D is the ``[S]`` token and length vectors and
  the ``[S, C/page_tokens]`` block tables, nothing else.
"""

import dataclasses

import numpy as np
import pytest
import torch

from flink_tensorflow_tpu_torch.core.runtime import KeyedSubtask
from flink_tensorflow_tpu_torch.functions.runner import PagedDecodeStepRunner
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.serving import (
    ContinuousBatchingOperator,
    GenerateRequest,
    ServingConfig,
)

pytestmark = pytest.mark.cuda

CAPACITY = 40
CFG = dict(vocab_size=48, embed_dim=32, num_heads=2, num_layers=2, capacity=CAPACITY)
PAGED = ServingConfig(max_active_seqs=4, token_budget=40, capacity=CAPACITY, paged_kv=True,
                      page_tokens=8, hbm_pages=12, prefix_sharing=False,
                      tier_high_watermark=0.6, tier_low_watermark=0.3, host_cache_sessions=0)


def needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.fixture(scope="module")
def model():
    mdef = get_model_def("char_transformer", **CFG)
    return mdef.to_model(mdef.init_params(0))


def requests(n=12, max_new=8, seed=7):
    rng = np.random.RandomState(seed)
    return [GenerateRequest(session_id=f"s{i}", prompt=rng.randint(1, 48, (int(rng.randint(4, 10)),)),
                            max_new_tokens=max_new) for i in range(n)]


def serve(model, cfg, reqs, device):
    op = ContinuousBatchingOperator("continuous_batching", model, cfg, device=device)
    sub = KeyedSubtask(op)
    out = {}
    for ev in sub.run(reqs):
        out.setdefault(ev.session_id, []).append(ev.token)
    return out, sub.ctx.metrics.report()


def test_pool_is_on_cuda(model):
    needs_cuda()
    op = ContinuousBatchingOperator("cb", model, PAGED)   # no device: cuda
    sub = KeyedSubtask(op)
    sub.open()
    try:
        runner = op._runner
        assert isinstance(runner, PagedDecodeStepRunner)
        assert runner._kc.is_cuda and runner._vc.is_cuda
        assert runner._kc.shape[0] == PAGED.hbm_pages + 1   # pages + scratch
        assert float(runner._kc.abs().sum()) == 0.0
    finally:
        sub.close()


@pytest.mark.parametrize("arm", ["tiered", "prefix"])
def test_paged_equals_dense_on_the_card(model, arm, tmp_path):
    needs_cuda()
    if arm == "tiered":
        reqs = requests()
        paged = dataclasses.replace(PAGED, spill_dir=str(tmp_path))
    else:
        reqs = [dataclasses.replace(r, prompt=np.arange(1, 13)) for r in requests(8)]
        paged = dataclasses.replace(PAGED, token_budget=256, max_active_seqs=2,
                                    prefix_sharing=True, hbm_pages=None)
    dense, _ = serve(model, ServingConfig(max_active_seqs=paged.max_active_seqs,
                                          token_budget=2048, capacity=CAPACITY), reqs, "cuda")
    got, rep = serve(model, paged, reqs, "cuda")
    cpu, _ = serve(model, paged, reqs, "cpu")
    assert got == dense == cpu
    if arm == "tiered":
        assert rep["continuous_batching.0.kv_spilled_sessions"] >= 1
        assert rep["continuous_batching.0.kv_revived_cold"] >= 1
    else:
        assert rep["continuous_batching.0.kv_cow_splits"] >= 1


def test_decode_step_h2d_is_tokens_lengths_and_tables(model):
    needs_cuda()
    runner = PagedDecodeStepRunner(model, pool_slots=4, capacity=CAPACITY, page_tokens=8,
                                   device="cuda")
    runner.open()
    try:
        runner.prefill([np.arange(1, 7), np.arange(3, 12)], [6, 9], [0, 2], batch_bucket=2)
        before = runner.step_h2d_bytes
        for length in (6, 9):
            runner.ensure_writable(0 if length == 6 else 2, length)
        runner.decode_step([5, 0, 7, 0], [6, 0, 9, 0], [0, 2])
        # tokens [4] + lengths [4] int32, tables [4, 5] int32.
        assert runner.step_h2d_bytes - before == 4 * 4 + 4 * 4 + 4 * 5 * 4
        assert runner._kc.is_cuda
    finally:
        runner.close()


def test_decode_step_copies_three_vectors_to_the_card(model):
    """The profiler's own count of host-to-device copies in one paged
    decode step: the token, length and table vectors."""
    needs_cuda()
    runner = PagedDecodeStepRunner(model, pool_slots=4, capacity=CAPACITY, page_tokens=8,
                                   device="cuda")
    runner.open()
    try:
        runner.prefill([np.arange(1, 7)], [6], [1], batch_bucket=1)
        runner.ensure_writable(1, 6)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            runner.decode_step([0, 5, 0, 0], [0, 6, 0, 0], [1])
            torch.cuda.synchronize()
        h2d = [e for e in prof.events() if "HtoD" in e.name]
        assert len(h2d) == 3, [e.name for e in h2d]
    finally:
        runner.close()
