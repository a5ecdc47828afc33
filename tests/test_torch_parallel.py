"""The port's parallel layer across processes, held to the JAX package.

Each cohort is 2 or 4 processes on the CPU (``tests/_torch_dist_worker.py``,
torch and the port only), joined over gloo at ``tcp://127.0.0.1:<free
port>``; each rank runs ``torch.set_num_threads(1)``, and the test kills
every rank that outlives ``COHORT_TIMEOUT_S``.  The JAX side runs here on
the virtual CPU devices (``tests/conftest.py``), on meshes of the same
shape.  Inputs come from numpy seeds; weights from the JAX initialisers,
carried over by ``models/convert.py``.

Tolerances:

- attention (f32, ``[2, 64, 4, 16]``): 1e-5 absolute against the JAX
  function and against ``full_attention`` (both sum f32 products in
  another order; ``tests/test_parallel.py`` holds the JAX ring to
  ``full_attention`` at the same bar); every rank's global output equal
  bit for bit;
- data-parallel steps in f32 (SGD, 2 steps): the loss to 1e-5 relative,
  params and batch statistics to 1e-5 of the collection's largest
  magnitude; every rank's state equal bit for bit (the state stays
  replicated).  The ResNet at 2 ranks is also run with batch norm's
  moments left local to each rank: that run must miss the JAX step by
  more than 100 times the bar, or the test could not tell global
  statistics from local ones;
- at one rank the cohort's step equals the single-device step bit for
  bit (an all-reduce over one rank is a copy).
"""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("flax")

import jax
import jax.numpy as jnp
import optax

from flink_tensorflow_tpu.models import get_model_def as jax_model_def
from flink_tensorflow_tpu.models.zoo import resnet as jresnet
from flink_tensorflow_tpu.models.zoo._common import weighted_metrics as jax_weighted
from flink_tensorflow_tpu.models.zoo.lenet import LeNet as JaxLeNet
from flink_tensorflow_tpu.parallel import init_train_state as jax_init_state
from flink_tensorflow_tpu.parallel import make_dp_train_step as jax_dp_step
from flink_tensorflow_tpu.parallel import make_mesh as jax_make_mesh
from flink_tensorflow_tpu.parallel import replicate as jax_replicate
from flink_tensorflow_tpu.parallel import shard_batch as jax_shard_batch
from flink_tensorflow_tpu.parallel.ring_attention import _block_attention as jax_block
from flink_tensorflow_tpu.parallel.ring_attention import _combine_blocks as jax_combine
from flink_tensorflow_tpu.parallel.ring_attention import full_attention as jax_full
from flink_tensorflow_tpu.parallel.ring_attention import (
    ring_attention as jax_ring,
)
from flink_tensorflow_tpu.parallel.ring_attention import (
    ring_decode_attention as jax_ring_decode,
)
from flink_tensorflow_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
from flink_tensorflow_tpu.parallel.ulysses import (
    ulysses_decode_attention as jax_ulysses_decode,
)
from flink_tensorflow_tpu_torch.models.convert import train_state_from_jax
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.parallel import collectives, dp, multihost
from flink_tensorflow_tpu_torch.parallel.mesh import make_mesh, spans_processes
from flink_tensorflow_tpu_torch.parallel.optim import sgd
from flink_tensorflow_tpu_torch.parallel.ring_attention import (
    _block_attention,
    _combine_blocks,
    full_attention,
    ring_flash_block,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_dist_worker.py")
COHORT_TIMEOUT_S = 25.0
ATTN_TOL = 1e-5
DP_TOL = 1e-5
DP_LR = 0.05
RESNET_CFG = dict(num_classes=4, image_size=32, width=8, stage_sizes=(1, 1))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cohort(scenario: str, world: int, directory, inputs, *extra: str):
    """Run ``world`` ranks of ``scenario`` on ``inputs``; every rank's
    results, in rank order.  Ranks still alive after
    ``COHORT_TIMEOUT_S`` are killed and the test fails."""
    directory = str(directory)
    os.makedirs(directory, exist_ok=True)
    torch.save(inputs, os.path.join(directory, "in.pt"))
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, WORKER, "--scenario", scenario, "--rank", str(r),
                               "--world", str(world), "--port", str(port), "--dir", directory,
                               *extra], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=COHORT_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"{scenario} cohort of {world} outlived {COHORT_TIMEOUT_S}s")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [torch.load(os.path.join(directory, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def jax_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return jax_make_mesh(axes, devices=jax.devices()[:n])


# -- attention ------------------------------------------------------------

def attention_inputs():
    rng = np.random.RandomState(2)
    b, t, h, d = 2, 64, 4, 16
    q, k, v = (rng.randn(b, t, h, d).astype(np.float32) for _ in range(3))
    return {"q": q, "k": k, "v": v,
            "qd": rng.randn(b, 1, h, d).astype(np.float32),
            "kd": rng.randn(b, 32, h, d).astype(np.float32),
            "vd": rng.randn(b, 32, h, d).astype(np.float32),
            "lengths": np.array([21, 7], np.int32),
            "odd_heads": np.zeros((2, 16, 6, 8), np.float32)}


@pytest.fixture(scope="module")
def attention_runs(tmp_path_factory):
    inputs = attention_inputs()
    runs = {mesh: cohort("attention", 4, tmp_path_factory.mktemp(mesh.replace(",", "_")),
                         inputs, "--mesh", mesh)
            for mesh in ("seq=4", "data=2,seq=2")}
    return inputs, runs


def _axes(mesh: str):
    return {k: int(v) for k, v in (p.split("=") for p in mesh.split(","))}


def _close(got, want, tol=ATTN_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=0)


@pytest.mark.parametrize("mesh", ["seq=4", "data=2,seq=2"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", ["flash", "einsum"])
@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_sequence_parallel_attention_matches_jax(attention_runs, kind, impl, causal, mesh):
    """Every rank returns the global output; it matches the JAX function
    on the same mesh shape and ``full_attention``, and the ranks agree
    bit for bit.  The ring exchanges n - 1 times per call (rotation at
    the top of each step), Ulysses all-to-alls 4 times (q, k, v in, the
    output back)."""
    inputs, runs = attention_runs
    name = f"{kind}_{impl}_{int(causal)}"
    ranks = runs[mesh]
    got = ranks[0][name]
    for r in ranks[1:]:
        assert torch.equal(r[name], got)
    q, k, v = inputs["q"], inputs["k"], inputs["v"]
    jfn = jax_ring if kind == "ring" else jax_ulysses
    want = jfn(jax_mesh(_axes(mesh)), q, k, v, causal=causal, impl=impl)
    _close(got, want)
    _close(got, jax_full(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    seq = _axes(mesh)["seq"]
    if kind == "ring":
        assert ranks[0][f"{name}_hops"] == seq - 1
    else:
        assert ranks[0][f"{name}_a2a"] == 4


@pytest.mark.parametrize("mesh", ["seq=4", "data=2,seq=2"])
@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_decode_attention_matches_jax(attention_runs, kind, mesh):
    inputs, runs = attention_runs
    got = runs[mesh][0][f"{kind}_decode"]
    for r in runs[mesh][1:]:
        assert torch.equal(r[f"{kind}_decode"], got)
    jfn = jax_ring_decode if kind == "ring" else jax_ulysses_decode
    want = jfn(jax_mesh(_axes(mesh)), inputs["qd"], inputs["kd"], inputs["vd"],
               inputs["lengths"])
    _close(got, np.asarray(want))


@pytest.mark.parametrize("kind", ["ulysses", "ulysses_decode"])
def test_indivisible_heads_are_refused(attention_runs, kind):
    """Six heads over a seq axis of 4: refused on every rank, with the
    word the reference's test looks for (``tests/test_parallel.py:160``)."""
    _, runs = attention_runs
    for r in runs["seq=4"]:
        assert "divisible" in r[f"{kind}_odd_heads_error"]


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_block_step_for_simulated_ranks_equals_full_attention(n, causal):
    """``ring_flash_block`` driven for n simulated ranks in one process,
    each fed the blocks in the order the ring delivers them (rank ``me``
    holds block ``(me - i) mod n`` at step i): the concatenated outputs
    are ``full_attention``'s.  This is what the card phase drives."""
    rng = np.random.RandomState(7)
    b, t, h, d = 1, 8, 2, 16
    q, k, v = (torch.from_numpy(rng.randn(b, n * t, h, d).astype(np.float32)) for _ in range(3))
    blocks = [(q[:, i * t:(i + 1) * t], k[:, i * t:(i + 1) * t], v[:, i * t:(i + 1) * t])
              for i in range(n)]
    outs, visited = [], 0
    for me in range(n):
        o = torch.zeros((b, t, h, d))
        lse = torch.full((b, h, t), float("-inf"))
        for step in range(n):
            src = (me - step) % n
            visited += not (causal and src > me)
            o, lse = ring_flash_block(blocks[me][0], blocks[src][1], blocks[src][2], o, lse,
                                      me=me, src=src, causal=causal)
        outs.append(o)
    _close(torch.cat(outs, dim=1), full_attention(q, k, v, causal=causal))
    assert visited == (n * (n + 1) // 2 if causal else n * n)


def test_block_attention_and_combine_match_jax():
    rng = np.random.RandomState(3)
    b, t, h, d = 2, 8, 2, 16
    q, k, v = (rng.randn(b, t, h, d).astype(np.float32) for _ in range(3))
    m = np.full((b, h, t), -np.inf, np.float32)
    m[:, :, :2] = 0.5
    l = rng.rand(b, h, t).astype(np.float32)
    o = rng.randn(b, t, h, d).astype(np.float32)
    mask = np.tril(np.ones((t, t), bool))
    want = jax_block(*(jnp.asarray(x) for x in (q, k, v, m, l, o)), jnp.asarray(mask))
    got = _block_attention(*(torch.from_numpy(x) for x in (q, k, v, m, l, o)),
                           torch.from_numpy(mask))
    for g, w in zip(got, want):
        _close(g, w)
    lse_a = np.where(rng.rand(b, h, t) < 0.3, -np.inf, rng.randn(b, h, t)).astype(np.float32)
    lse_b = np.where(rng.rand(b, h, t) < 0.3, -np.inf, rng.randn(b, h, t)).astype(np.float32)
    o_b = rng.randn(b, t, h, d).astype(np.float32)
    want = jax_combine(jnp.asarray(o), jnp.asarray(lse_a), jnp.asarray(o_b), jnp.asarray(lse_b))
    got = _combine_blocks(*(torch.from_numpy(x) for x in (o, lse_a, o_b, lse_b)))
    for g, w in zip(got, want):
        _close(g, w)


# -- meshes and cohorts in this process -------------------------------------

def test_a_mesh_over_processes_needs_a_cohort():
    with pytest.raises(ValueError, match="multihost.initialize"):
        make_mesh({"data": 2}, devices=["cpu"])
    with pytest.raises(ValueError, match="one device"):
        make_mesh({"data": 2}, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="unknown mesh axes"):
        make_mesh({"bogus": 2})
    local = make_mesh({"data": 1, "seq": 1}, devices=["cpu"])
    assert not local.distributed and not spans_processes(local)
    assert local.axis_size("seq") == 1 and local.axis_index("data") == 0


def test_initialize_alone_is_a_no_op_and_refuses_half_a_cohort():
    topo = multihost.initialize(device="cpu")
    assert topo == multihost.HostTopology(0, 1, 1, 1)
    with pytest.raises(ValueError, match="coordinator address"):
        multihost.initialize(None, 2, 0, device="cpu")
    with pytest.raises(ValueError, match="process_id is required"):
        multihost.initialize("127.0.0.1:1", 2, None, device="cpu")
    with pytest.raises(RuntimeError, match="needs a cohort"):
        multihost.global_mesh({"data": 1}, device="cpu")


def test_batch_moments_pass_through_outside_a_step():
    mean, msq = torch.randn(4), torch.rand(4)
    got = collectives.batch_moments(mean, msq)
    assert got[0] is mean and got[1] is msq


# -- data parallelism -------------------------------------------------------

def jax_lenet_f32():
    jdef = jax_model_def("lenet")
    module = JaxLeNet(compute_dtype=jnp.float32)

    def loss_fn(variables, batch, rng):
        logits = module.apply(variables, batch["image"])
        labels = batch["label"]
        per_ex = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
        hits = (jnp.argmax(logits, -1) == labels).astype(jnp.float32)
        loss, acc = jax_weighted(per_ex, hits, batch.get("valid"))
        return loss, ({}, {"loss": loss, "accuracy": acc})

    return dataclasses.replace(jdef, module=module, loss_fn=loss_fn)


def jax_resnet_f32():
    jdef = jax_model_def("resnet50", **RESNET_CFG)
    module = jresnet.ResNet(stage_sizes=RESNET_CFG["stage_sizes"],
                            num_classes=RESNET_CFG["num_classes"], width=RESNET_CFG["width"],
                            compute_dtype=jnp.float32)

    def init_fn(rng):
        return module.init(rng, jnp.zeros((1, 32, 32, 3)), train=False)

    def loss_fn(variables, batch, rng):
        logits, new_state = module.apply(variables, batch["image"], train=True,
                                         mutable=["batch_stats"])
        labels = batch["label"]
        per_ex = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
        hits = (jnp.argmax(logits, -1) == labels).astype(jnp.float32)
        loss, acc = jax_weighted(per_ex, hits, batch.get("valid"))
        return loss, (new_state, {"loss": loss, "accuracy": acc})

    return dataclasses.replace(jdef, module=module, init_fn=init_fn, loss_fn=loss_fn)


def perturb_bn(variables, seed: int):
    """Batch-norm scales, biases and running statistics moved off their
    init values, so no block's last batch norm is the zero map."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name, a = path[-1].key, np.asarray(leaf)
        if name == "scale":
            return rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(fill, variables)


def dp_case(model: str, steps: int = 2, batch: int = 8):
    """(JAX def, port def, initial JAX state, global batches): the
    ResNet's last global batch row is a pad row (``valid`` 0), so the
    ranks' valid counts differ and the gradient average must weight them."""
    rng = np.random.RandomState(11)
    if model == "lenet":
        jdef, mdef = jax_lenet_f32(), get_model_def("lenet", compute_dtype="float32")
        shape, classes = (28, 28, 1), 10
    else:
        jdef = jax_resnet_f32()
        mdef = get_model_def("resnet50", compute_dtype="float32", **RESNET_CFG)
        shape, classes = (32, 32, 3), RESNET_CFG["num_classes"]
    state = jax_init_state(jdef, optax.sgd(DP_LR), jax.random.key(0))
    if model == "resnet":
        state["variables"] = jax.tree.map(jnp.asarray, perturb_bn(state["variables"], 1))
    batches = []
    for _ in range(steps):
        valid = np.ones((batch,), np.float32)
        if model == "resnet":
            valid[-1] = 0.0
        batches.append({"image": rng.uniform(-1, 1, (batch, *shape)).astype(np.float32),
                        "label": rng.randint(0, classes, (batch,)).astype(np.int32),
                        "valid": valid})
    return jdef, mdef, state, batches


def jax_np_state(state):
    return jax.tree.map(np.asarray, {k: v for k, v in state.items() if k != "rng"})


def run_jax_dp(jdef, state, batches, n):
    mesh = jax_mesh({"data": n})
    step = jax_dp_step(jdef, optax.sgd(DP_LR), mesh)
    # A copy: the step donates its state.
    state = jax_replicate(mesh, jax.tree.map(jnp.array, state))
    losses = []
    for b in batches:
        state, m = step(state, jax_shard_batch(mesh, b))
        losses.append(float(m["loss"]))
    return jax_np_state(state), losses


def collection_err(got: dict, want: dict) -> float:
    peak = max(float(np.abs(w.float().numpy()).max()) for w in want.values())
    return max(float((got[k].float() - want[k].float()).abs().max()) for k in want) / peak


def dp_inputs(model: str):
    jdef, mdef, state, batches = dp_case(model)
    port_state = train_state_from_jax(jax_np_state(state), mdef)
    inputs = {"architecture": mdef.architecture, "config": dict(mdef.config), "lr": DP_LR,
              "state": port_state, "batches": batches}
    return jdef, mdef, state, batches, inputs


@pytest.mark.parametrize("model,n", [("lenet", 2), ("lenet", 4), ("resnet", 2)])
def test_dp_step_across_processes_matches_jax_dp(tmp_path, model, n):
    """``make_dp_train_step`` over ``{"data": n}`` gloo ranks against the
    JAX step on ``{"data": n}`` of the virtual devices: the losses, the
    params and (ResNet) the running statistics, which batch norm takes
    over the GLOBAL batch in both."""
    jdef, mdef, state, batches, inputs = dp_inputs(model)
    want_state, want_losses = run_jax_dp(jdef, state, batches, n)
    want = train_state_from_jax(want_state, mdef)["variables"]
    ranks = cohort("dp", n, tmp_path, inputs)
    for r in ranks:
        for coll in want:
            for name in want[coll]:
                assert torch.equal(r["variables"][coll][name], ranks[0]["variables"][coll][name])
        assert r["step"] == len(batches)
    got = ranks[0]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=DP_TOL)
    for coll in want:
        if want[coll]:
            assert collection_err(got["variables"][coll], want[coll]) <= DP_TOL, coll
    # Collectives per step: the count all-reduce, one for the gradients
    # and metrics, and per batch norm one in the forward and one in the
    # backward pass.
    bns = sum(1 for n_ in want.get("batch_stats", {}) if n_.endswith(".mean"))
    assert got["calls"][0] == {"all_reduce": 2 + 2 * bns}


def test_dp_with_batch_statistics_local_to_each_rank_misses_jax(tmp_path):
    """The negative control: the same ResNet cohort with batch norm's
    moments left per rank lands far from the JAX step, so the twin above
    does hold global statistics."""
    jdef, mdef, state, batches, inputs = dp_inputs("resnet")
    want_state, want_losses = run_jax_dp(jdef, state, batches, 2)
    want = train_state_from_jax(want_state, mdef)["variables"]
    got = cohort("dp", 2, tmp_path, inputs, "--local-batch-stats")[0]
    assert collection_err(got["variables"]["batch_stats"], want["batch_stats"]) > 100 * DP_TOL
    assert collection_err(got["variables"]["params"], want["params"]) > 100 * DP_TOL


def test_dp_over_a_cohort_of_one_equals_the_single_device_step(tmp_path):
    """A real process group of one: its step is the one-device step bit
    for bit (what the card phase holds over NCCL)."""
    _, mdef, _, batches, inputs = dp_inputs("resnet")
    got = cohort("dp", 1, tmp_path, inputs)[0]
    state = train_state_from_jax(jax_np_state(dp_case("resnet")[2]), mdef)
    step = dp.make_dp_train_step(mdef, sgd(DP_LR), make_mesh({"data": 1}, devices=["cpu"]))
    losses = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # as the rank runs: CPU reductions split by thread
    try:
        for i, b in enumerate(batches):
            state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()}, i)
            losses.append(float(m["loss"]))
    finally:
        torch.set_num_threads(threads)
    assert got["losses"] == losses
    for coll in state["variables"]:
        for name, t in state["variables"][coll].items():
            assert torch.equal(got["variables"][coll][name], t), name


def test_gang_across_processes_restores_from_a_common_checkpoint(tmp_path):
    """Two processes, each running ``count_window -> DPTrainWindowFunction``
    at parallelism 1 on its own partition with count-based checkpoints:
    every checkpoint lands at the same step on both ranks, both ranks end
    with the same state, and both restarted from checkpoint 2 end with
    the uninterrupted run's state and losses, bit for bit."""
    from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, spec

    rng = np.random.RandomState(5)
    records = 48
    inputs = {"config": dict(RESNET_CFG, uint8_input=True), "global_batch": 8, "every_n": 8,
              "images": rng.randint(0, 256, (records, 32, 32, 3)).astype(np.uint8),
              "labels": (np.arange(records) % 4).astype(np.int32),
              "schema": RecordSchema({"image": spec((32, 32, 3), np.uint8),
                                      "label": spec((), np.int32)})}
    ranks = cohort("gang", 2, tmp_path, inputs, "--restore-id", "2")
    for r in ranks:
        assert r["num_processes"] == 2
        # Checkpoint 2 cut each 24-record partition after its 16th record:
        # 4 windows of 4, 4 global steps.
        assert r["checkpoint_step"] == 4
        assert [s for s, _ in r["steps_a"]] == list(range(1, 7))
        assert [s for s, _ in r["steps_b"]] == [5, 6]
        assert r["steps_b"] == r["steps_a"][4:]
        assert r["steps_a"] == ranks[0]["steps_a"]
        for name, t in r["params_a"]["params"].items():
            assert torch.equal(t, ranks[0]["params_a"]["params"][name]), name
            assert torch.equal(r["params_b"]["params"][name], t), name
        for name, t in r["params_a"]["batch_stats"].items():
            assert torch.equal(r["params_b"]["batch_stats"][name], t), name
