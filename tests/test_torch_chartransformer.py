"""The port's char transformer and DecodeStepRunner held against the JAX
package's, on the same weights (numpy, from a seed, through the bridge).

Tolerances: caches atol 1e-5 (f32 throughout, another summation order);
generated tokens equal.  Small size: 2 layers, embed_dim 32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flink_tensorflow_tpu.functions.runner import DecodeStepRunner as JaxRunner
from flink_tensorflow_tpu.models import get_model_def as jax_model_def
from flink_tensorflow_tpu_torch.functions.runner import DecodeStepRunner
from flink_tensorflow_tpu_torch.models.convert import params_from_jax
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def

CFG = dict(vocab_size=48, embed_dim=32, num_heads=2, num_layers=2, capacity=40)


@pytest.fixture(scope="module")
def models():
    port_def = get_model_def("char_transformer", **CFG)
    tree = port_def.init_params(7)
    jax_def = jax_model_def("char_transformer", **CFG)
    jax_model = jax_def.to_model(jax.tree.map(jnp.asarray, tree))
    return port_def.to_model(tree), jax_model, tree


def _prompts(seed=0, b=3, t=16):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(1, CFG["vocab_size"], (b, t)).astype(np.int32)
    lengths = np.asarray([5, t, 9][:b], np.int32)
    return tokens, lengths


def test_bridge_keeps_names_layouts_and_untied_head(models):
    port, _, tree = models
    sd = params_from_jax(tree)
    assert set(sd) == set(port.params.state_dict())
    assert sd["layers.1.w1"].shape == (32, 128)  # (in, out), as in JAX
    np.testing.assert_array_equal(port.params.head.detach().numpy(), tree["head"])
    assert port.params.head.data_ptr() != port.params.emb.data_ptr()


def test_prefill_matches_jax(models):
    port, jm, _ = models
    tokens, lengths = _prompts()
    want = jm.method("prefill").fn(jm.params, {"tokens": jnp.asarray(tokens),
                                               "lengths": jnp.asarray(lengths)})
    got = port.method("prefill").fn(port.params, {"tokens": torch.from_numpy(tokens),
                                                  "lengths": torch.from_numpy(lengths)})
    np.testing.assert_array_equal(got["next_token"].numpy(), np.asarray(want["next_token"]))
    assert got["next_token"].dtype == torch.int32
    for name in ("k_cache", "v_cache"):
        assert got[name].shape == (3, 2, 16, 2, 16)
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), atol=1e-5)


def test_decode_steps_match_jax_and_mask_inactive_rows(models):
    port, jm, _ = models
    tokens, lengths = _prompts(seed=1)
    pre = jm.method("prefill").fn(jm.params, {"tokens": jnp.asarray(tokens),
                                              "lengths": jnp.asarray(lengths)})
    pad = ((0, 0), (0, 0), (0, CFG["capacity"] - 16), (0, 0), (0, 0))
    jk = jnp.pad(pre["k_cache"], pad)
    jv = jnp.pad(pre["v_cache"], pad)
    pk = torch.from_numpy(np.array(jk))
    pv = torch.from_numpy(np.array(jv))
    tok = np.array(pre["next_token"])
    lens = lengths.copy()
    decode = jm.method("decode_step").fn
    for _ in range(4):
        out = decode(jm.params, {"token": jnp.asarray(tok), "lengths": jnp.asarray(lens),
                                 "k_cache": jk, "v_cache": jv})
        got = port.params.decode_step({"token": torch.from_numpy(tok),
                                       "lengths": torch.from_numpy(lens),
                                       "k_cache": pk, "v_cache": pv})
        np.testing.assert_array_equal(got["next_token"].numpy(), np.asarray(out["next_token"]))
        np.testing.assert_allclose(pk.numpy(), np.asarray(out["k_cache"]), atol=1e-5)
        np.testing.assert_allclose(pv.numpy(), np.asarray(out["v_cache"]), atol=1e-5)
        jk, jv, tok = out["k_cache"], out["v_cache"], np.array(out["next_token"])
        lens = lens + 1
    # An inactive row keeps every byte, even at lengths == 0.
    before = pk.clone()
    port.params.decode_step({"token": torch.from_numpy(tok),
                             "lengths": torch.zeros(3, dtype=torch.int32),
                             "k_cache": pk, "v_cache": pv,
                             "active": torch.tensor([False, True, False])})
    assert torch.equal(pk[0], before[0]) and torch.equal(pk[2], before[2])
    assert not torch.equal(pk[1], before[1])


def test_runner_matches_jax_runner(models):
    """Same admissions, same decode steps, same tokens; the pool rows the
    two runners hold agree."""
    port, jm, _ = models
    kw = dict(pool_slots=4, capacity=CFG["capacity"], prompt_buckets=(16,))
    jr = JaxRunner(jm, **kw)
    pr = DecodeStepRunner(port, device="cpu", **kw)
    jr.open()
    pr.open()
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, 48, (n,)).astype(np.int32) for n in (6, 11, 3)]
    slots = [2, 0, 3]
    first_j = jr.prefill(prompts, [len(p) for p in prompts], slots, batch_bucket=4)
    first_p = pr.prefill(prompts, [len(p) for p in prompts], slots, batch_bucket=4)
    np.testing.assert_array_equal(first_p, first_j)
    toks = [0] * 4
    lens = [0] * 4
    for s, p, t in zip(slots, prompts, first_j):
        toks[s], lens[s] = int(t), len(p)
    for step in range(6):
        active = slots if step < 3 else slots[:2]   # one session leaves
        tj = jr.decode_step(toks, lens, active)
        tp = pr.decode_step(toks, lens, active)
        np.testing.assert_array_equal(tp[active], tj[active])
        for s in active:
            toks[s], lens[s] = int(tj[s]), lens[s] + 1
    for s in slots:
        kj, vj = jr.extract_block(s, lens[s], host=True)
        kp, vp = pr.extract_block(s, lens[s], host=True)
        np.testing.assert_allclose(kp, np.asarray(kj), atol=1e-5)
        np.testing.assert_allclose(vp, np.asarray(vj), atol=1e-5)
    assert pr.step_h2d_bytes == jr.step_h2d_bytes
    assert pr.block_d2h_events == jr.block_d2h_events == 3


def test_host_block_is_not_a_view_of_the_pool(models):
    """A host block taken from a CPU pool (barrier snapshot, host-mode
    preemption) keeps its bytes when the slot is written again: a new
    session prefilled into the slot must not change a pending snapshot."""
    port, _, _ = models
    pr = DecodeStepRunner(port, device="cpu", pool_slots=2, capacity=CFG["capacity"],
                          prompt_buckets=(16,))
    pr.open()
    rng = np.random.RandomState(3)
    first, second = (rng.randint(1, 48, (n,)).astype(np.int32) for n in (7, 9))
    pr.prefill([first], [7], [0], batch_bucket=1)
    k, v = pr.extract_block(0, 7, host=True)
    k_saved, v_saved = k.copy(), v.copy()
    pr.prefill([second], [9], [0], batch_bucket=1)
    assert not np.array_equal(pr._kc[0].numpy(), k_saved)
    np.testing.assert_array_equal(k, k_saved)
    np.testing.assert_array_equal(v, v_saved)
