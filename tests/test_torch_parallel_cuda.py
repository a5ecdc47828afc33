"""The parallel layer and frozen graphs on the card (``cuda``-marked; they
skip without an NVIDIA GPU).  This file imports neither flax nor the JAX
package, so it collects on a machine that has neither.  They mirror
``chip_smoke.py`` phase 13 at small sizes, f32 with TF32 off:

- (a) the gang's step over a real NCCL group of one equals the one-card
  step bit for bit, over 3 adam steps of a small ResNet;
- (b) two gloo ranks sharing ``cuda:0`` (``tests/_torch_dist_worker.py``)
  hold the one-card step on the global batch, batch norm's statistics
  included, to 1e-5 of each collection's largest magnitude (f32 summed in
  another order), and their states equal each other bit for bit;
- (c) the ring's block step for 8 simulated ranks and Ulysses' per-rank
  call launch K1 exactly n(n+1)/2 (causal), n^2 and n times, and their
  outputs hold to the plain path at ``chip_smoke.py``'s phase 3
  tolerances (bf16/f16: atol 3e-3 and rtol 2**-7), as do ``ring_attention``
  and ``ulysses_attention`` through the group of one;
- (d) a frozen Inception (75 px) through ``GraphWindowFunction`` equals
  ``ModelWindowFunction`` on the card, labels and scores bit for bit.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from flink_tensorflow_tpu_torch.core.environment import StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.functions.model_function import (
    GraphWindowFunction,
    ModelWindowFunction,
)
from flink_tensorflow_tpu_torch.models.loaders import freeze_method
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.ops import flash_attention as fa
from flink_tensorflow_tpu_torch.parallel import dp, multihost, optim
from flink_tensorflow_tpu_torch.parallel.mesh import make_mesh, replicate
from flink_tensorflow_tpu_torch.parallel.ring_attention import (
    full_attention,
    ring_attention,
    ring_flash_block,
)
from flink_tensorflow_tpu_torch.parallel.ulysses import ulysses_attention, ulysses_local_attention
from flink_tensorflow_tpu_torch.tensors.batching import BucketPolicy
from flink_tensorflow_tpu_torch.tensors.value import TensorValue

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESNET = dict(num_classes=4, image_size=32, width=8, stage_sizes=(1, 1), compute_dtype="float32")
TOL = {torch.bfloat16: (3e-3, 2 ** -7), torch.float16: (3e-3, 2 ** -7)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def resnet_case(steps=3, batch=8):
    mdef = get_model_def("resnet50", **RESNET)
    rng = np.random.RandomState(4)
    batches = [{"image": rng.uniform(-1, 1, (batch, 32, 32, 3)).astype(np.float32),
                "label": rng.randint(0, 4, (batch,)).astype(np.int32),
                "valid": np.ones((batch,), np.float32)} for _ in range(steps)]
    return mdef, batches


def one_card_steps(mdef, batches, mesh):
    opt = optim.adam(1e-3, eps=1e-3)
    state = replicate(mesh, dp.init_train_state(mdef, opt, 0))
    step = dp.make_dp_train_step(mdef, opt, mesh)
    losses = []
    for i, b in enumerate(batches):
        state, m = step(state, {k: torch.from_numpy(v).to(mesh.device) for k, v in b.items()}, i)
        losses.append(float(m["loss"]))
    return losses, {c: {n: t.cpu() for n, t in coll.items()}
                    for c, coll in state["variables"].items()}


@pytest.mark.cuda
def test_dp_over_an_nccl_group_of_one_equals_the_one_card_step(card):
    mdef, batches = resnet_case()
    want = one_card_steps(mdef, batches, make_mesh({"data": 1}))
    multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        assert torch.distributed.get_backend() == "nccl"
        mesh = make_mesh({"data": 1})
        assert mesh.distributed
        got = one_card_steps(mdef, batches, mesh)
    finally:
        multihost.shutdown()
    assert got[0] == want[0]
    for c in want[1]:
        for n, t in want[1][c].items():
            assert torch.equal(got[1][c][n], t), n


@pytest.mark.cuda
def test_two_gloo_ranks_sharing_the_card_hold_the_one_card_step(card, tmp_path):
    mdef, batches = resnet_case(steps=2)
    opt = optim.sgd(0.05)
    host = dp.init_train_state(mdef, opt, 0)
    inputs = {"architecture": "resnet50", "config": dict(mdef.config), "lr": 0.05,
              "state": host, "batches": batches}
    torch.save(inputs, tmp_path / "in.pt")
    port = free_port()
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "tests", "_torch_dist_worker.py"),
                               "--scenario", "dp", "--rank", str(r), "--world", "2",
                               "--port", str(port), "--dir", str(tmp_path), "--device", "cuda",
                               "--backend", "gloo"], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    mesh = make_mesh({"data": 1})
    state = replicate(mesh, host)
    step = dp.make_dp_train_step(mdef, opt, mesh)
    losses = []
    for i, b in enumerate(batches):
        state, m = step(state, {k: torch.from_numpy(v).cuda() for k, v in b.items()}, i)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=1e-5)
    for c, coll in state["variables"].items():
        peak = max(float(t.abs().max()) for t in coll.values())
        for n, t in coll.items():
            assert torch.equal(ranks[0]["variables"][c][n], ranks[1]["variables"][c][n]), n
            assert float((ranks[0]["variables"][c][n] - t.cpu()).abs().max()) <= 1e-5 * peak, n


def hold(got, want, dtype):
    atol, rtol = TOL[dtype]
    over = ((got.float() - want.float()).abs() - rtol * want.float().abs()).max().item()
    assert over <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,causal", [(torch.bfloat16, 64, True),
                                            (torch.float16, 128, False)])
def test_ring_block_step_and_ulysses_launch_k1_exactly(card, dtype, d, causal):
    n, b, h, t = 8, 1, 8, 128
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, n * t, h, d, device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    want = full_attention(q, k, v, causal=causal)
    fa.flash_attention.launches = 0
    outs = []
    for me in range(n):
        o = torch.zeros((b, t, h, d), device="cuda")
        lse = torch.full((b, h, t), float("-inf"), device="cuda")
        for step in range(n):
            src = (me - step) % n
            o, lse = ring_flash_block(q[:, me * t:(me + 1) * t], k[:, src * t:(src + 1) * t],
                                      v[:, src * t:(src + 1) * t], o, lse, me=me, src=src,
                                      causal=causal)
        outs.append(o.to(dtype))
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == (n * (n + 1) // 2 if causal else n * n)
    hold(torch.cat(outs, dim=1), want, dtype)
    fa.flash_attention.launches = 0
    hs = h // n
    heads = [ulysses_local_attention(q[:, :, j * hs:(j + 1) * hs], k[:, :, j * hs:(j + 1) * hs],
                                     v[:, :, j * hs:(j + 1) * hs], causal=causal)
             for j in range(n)]
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n
    hold(torch.cat(heads, dim=2), want, dtype)


@pytest.mark.cuda
def test_ring_and_ulysses_through_an_nccl_group_of_one(card):
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn(2, 256, 4, 64, device="cuda", generator=gen).bfloat16()
               for _ in range(3))
    want = full_attention(q, k, v, causal=True)
    multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        mesh = make_mesh({"seq": 1})
        for fn in (ring_attention, ulysses_attention):
            fa.flash_attention.launches = 0
            got = fn(mesh, q, k, v, causal=True)
            torch.cuda.synchronize()
            assert fa.flash_attention.launches == 1
            hold(got, want, torch.bfloat16)
    finally:
        multihost.shutdown()


@pytest.mark.cuda
def test_frozen_inception_window_equals_the_model_window(card):
    mdef = get_model_def("inception_v3", num_classes=10, image_size=75, uint8_input=True)
    model = mdef.to_model(mdef.init_params(0))
    rng = np.random.RandomState(3)
    records = [TensorValue({"image": rng.randint(0, 256, (75, 75, 3)).astype(np.uint8)}, {"i": i})
               for i in range(16)]
    frozen = freeze_method(model, batch=8)

    def run(function):
        env = StreamExecutionEnvironment(parallelism=1)
        out = env.from_collection(records).count_window(8).apply(function).sink_to_list()
        env.execute(timeout=300)
        return {r.meta["i"]: (int(r["label"]), float(r["score"])) for r in out}

    fa.flash_attention.launches = 0
    got = run(GraphWindowFunction(frozen, batch=8, input_schema=mdef.methods["serve"].input_schema,
                                  outputs=("label", "score")))
    want = run(ModelWindowFunction(model, policy=BucketPolicy(fixed_batch=8),
                                   outputs=("label", "score")))
    assert got == want
    assert fa.flash_attention.launches == 0
