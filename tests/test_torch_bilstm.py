"""The port's BiLSTM held to the flax definition on the same weights, and
the BiLSTM example job held to the JAX package's.

Flax ``variables`` come from the JAX package's initialiser (vocab 50,
embed 8, hidden 16) with every bias drawn from a seeded normal, carried
into the port with ``models/convert.py:bilstm_from_flax``.  For the f32
twin the JAX module is built with ``compute_dtype=float32`` and the same
weights (its embedding table is then f32: the bf16 table widened, exact).

What is held, relative to the largest magnitude of the reference output:

- every route of the recurrence (``models/zoo/bilstm.py:LSTM_ROUTES``; on
  the CPU ``torch.lstm`` runs PyTorch's own kernel in place of cuDNN) at
  mixed lengths, at length 0 and across buckets.  f32: 1e-5 (observed
  about 2e-7); bf16: 3e-2 (every product and gate rounds to bf16 in
  another order; observed about 4e-3); the ``cudnn_bf16`` route in an f32
  model keeps the gates and ``c`` in bf16 and is held to bf16's 3e-2;
- a record of length 0: flax takes its state at step ``length - 1``, which
  wraps to the last step, so it equals the same row at length T;
- gradients of ``loss_fn``, by norm per parameter: f32 1e-4; bf16 at most
  1.5 times the JAX package's own bf16-vs-f32 distance or 1e-2, whichever
  is larger (and below 0.5).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("flax")

import jax
import jax.numpy as jnp

from flink_tensorflow_tpu import StreamExecutionEnvironment as JaxEnv
from flink_tensorflow_tpu.functions import ModelWindowFunction as JaxModelWindowFunction
from flink_tensorflow_tpu.models import get_model_def as jax_model_def
from flink_tensorflow_tpu.models.zoo.bilstm import BiLSTMClassifier as JaxBiLSTM
from flink_tensorflow_tpu_torch.core.environment import StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.functions.model_function import ModelWindowFunction
from flink_tensorflow_tpu_torch.models.convert import bilstm_from_flax
from flink_tensorflow_tpu_torch.models.zoo.bilstm import LSTM_ROUTES
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.tensors.value import TensorValue
from test_torch_lenet import (
    BF16_TOL,
    F32_TOL,
    GRAD_BF16_NOISE_FACTOR,
    GRAD_F32_TOL,
    f32,
    norm_err,
    rel_err,
    with_random_biases,
)

CFG = dict(vocab_size=50, embed_dim=8, hidden_dim=16)
DTYPES = ("float32", "bfloat16")


@pytest.fixture(scope="module")
def variables():
    mdef = jax_model_def("bilstm", **CFG)
    return with_random_biases(jax.jit(mdef.init_fn)(jax.random.key(0)), 2)


def jax_logits(variables, dtype, tokens, lengths):
    module = JaxBiLSTM(**CFG, compute_dtype=getattr(jnp, dtype))
    if dtype == "float32":
        variables = jax.tree.map(lambda x: np.asarray(x, np.float32), variables)
    return np.asarray(jax.jit(module.apply)(variables, jnp.asarray(tokens), jnp.asarray(lengths)))


def port_logits(variables, dtype, tokens, lengths, route=None):
    module = get_model_def("bilstm", **CFG, compute_dtype=dtype).to_model(variables).params
    with torch.no_grad():
        return module(torch.from_numpy(tokens), torch.from_numpy(lengths), route=route).numpy()


def tolerance(dtype, route):
    return F32_TOL if dtype == "float32" and route != "cudnn_bf16" else BF16_TOL


MIXED_TOKENS = np.random.RandomState(3).randint(0, 50, (6, 8)).astype(np.int32)
MIXED_LENGTHS = np.array([8, 3, 1, 0, 5, 8], np.int32)


@pytest.mark.parametrize("route", LSTM_ROUTES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_mixed_lengths_and_length_zero(variables, dtype, route):
    """Rows of lengths 8, 3, 1, 0, 5 and 8 in one batch of 8 steps."""
    want = jax_logits(variables, dtype, MIXED_TOKENS, MIXED_LENGTHS)
    got = port_logits(variables, dtype, MIXED_TOKENS, MIXED_LENGTHS, route)
    assert rel_err(got, want) <= tolerance(dtype, route)


@pytest.mark.parametrize("dtype", DTYPES)
def test_length_zero_takes_the_last_step(variables, dtype):
    """flax's ``x[length - 1]`` wraps at length 0: both directions' states
    are taken after the whole padded row, as at length T."""
    at_t = MIXED_LENGTHS.copy()
    at_t[3] = MIXED_TOKENS.shape[1]
    for logits in (jax_logits, port_logits):
        zero = logits(variables, dtype, MIXED_TOKENS, MIXED_LENGTHS)
        full = logits(variables, dtype, MIXED_TOKENS, at_t)
        np.testing.assert_array_equal(zero[3], full[3])


@pytest.mark.parametrize("dtype", DTYPES)
def test_bilstm_padding_invariance(variables, dtype):
    """Twin of ``tests/test_models.py::test_bilstm_padding_invariance``:
    the same sequence padded to 8 and to 16 gives the same logits (the
    JAX test's atol 2e-2), and the JAX package's."""
    tokens = np.array([3, 7, 11, 2], np.int32)
    lengths = np.array([4], np.int32)
    out = {}
    for t in (8, 16):
        padded = np.pad(tokens, (0, t - 4))[None]
        out[t] = port_logits(variables, dtype, padded, lengths)
        assert rel_err(out[t], jax_logits(variables, dtype, padded, lengths)) <= \
            tolerance(dtype, None)
    np.testing.assert_allclose(out[8], out[16], atol=2e-2)


def test_serve_outputs_and_the_bridge(variables):
    mdef = get_model_def("bilstm", **CFG)
    model = mdef.to_model(variables)
    assert mdef.methods["serve"].needs_lengths
    with torch.no_grad():
        out = mdef.methods["serve"].fn(model.params, {"tokens": torch.from_numpy(MIXED_TOKENS)},
                                       {"tokens": torch.from_numpy(MIXED_LENGTHS)})
    assert out["label"].dtype == torch.int32 and out["label"].shape == (6,)
    np.testing.assert_allclose(out["prob"].sum(-1).numpy(), 1.0, rtol=1e-5)
    module, p = model.params, variables["params"]
    assert module.embed.weight.dtype == torch.bfloat16
    np.testing.assert_array_equal(f32(module.embed.weight),
                                  np.asarray(p["Embed_0"]["embedding"], np.float32))
    cell = p["OptimizedLSTMCell_1"]   # the reverse direction
    hidden = CFG["hidden_dim"]
    for k, gate in enumerate("ifgo"):
        rows = slice(k * hidden, (k + 1) * hidden)
        np.testing.assert_array_equal(module.bwd.weight_ih_l0[rows].detach().numpy(),
                                      cell[f"i{gate}"]["kernel"].T)
        np.testing.assert_array_equal(module.bwd.weight_hh_l0[rows].detach().numpy(),
                                      cell[f"h{gate}"]["kernel"].T)
        np.testing.assert_array_equal(module.bwd.bias_hh_l0[rows].detach().numpy(),
                                      cell[f"h{gate}"]["bias"])
    assert not module.bwd.bias_ih_l0.detach().any()


def grads_of(dtype, variables, batch):
    """(JAX loss, port loss, JAX grads under the port's names, port grads)."""
    module_j = JaxBiLSTM(**CFG, compute_dtype=getattr(jnp, dtype))
    if dtype == "float32":
        variables = jax.tree.map(lambda x: np.asarray(x, np.float32), variables)

    def jax_loss(params):
        import optax

        logits = module_j.apply({"params": params}, batch["tokens"], batch["tokens_len"])
        per_ex = optax.softmax_cross_entropy_with_integer_labels(logits, batch["label"])
        w = batch["valid"].astype(jnp.float32)
        return (per_ex * w).sum() / w.sum()

    if dtype == "bfloat16":  # the registered loss_fn is the bf16 module's
        jloss, _ = jax_model_def("bilstm", **CFG).loss_fn(variables, batch, jax.random.key(0))
        assert float(jloss) == pytest.approx(float(jax_loss(variables["params"])), rel=1e-6)
    jloss, jgrads = jax.value_and_grad(jax_loss)(variables["params"])
    want = bilstm_from_flax({"params": jax.tree.map(np.asarray, jgrads)},
                            get_model_def("bilstm", **CFG, compute_dtype="float32")
                            .make_module()).state_dict()
    mdef = get_model_def("bilstm", **CFG, compute_dtype=dtype)
    module = mdef.to_model(variables).params.train()
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss, (_, metrics) = mdef.loss_fn(module, tbatch, None)
    loss.backward()
    got = {n: p.grad for n, p in module.named_parameters() if p.grad is not None}
    assert 0.0 <= float(metrics["accuracy"]) <= 1.0
    return float(jloss), float(loss.detach()), want, got


def test_loss_fn_and_gradients(variables):
    batch = {"tokens": jnp.asarray(MIXED_TOKENS), "tokens_len": jnp.asarray(MIXED_LENGTHS),
             "label": jnp.asarray([0, 1, 1, 0, 1, 0], jnp.int32),
             "valid": jnp.asarray([1, 1, 1, 1, 1, 0], jnp.float32)}
    jl32, pl32, want32, got32 = grads_of("float32", variables, batch)
    assert pl32 == pytest.approx(jl32, rel=F32_TOL)
    names = [n for n in want32 if n != "fwd.bias_ih_l0" and n != "bwd.bias_ih_l0"]
    for name in names:
        assert norm_err(got32[name], want32[name]) <= GRAD_F32_TOL, name
    jl16, pl16, want16, got16 = grads_of("bfloat16", variables, batch)
    assert pl16 == pytest.approx(jl16, rel=BF16_TOL)
    for name in names:
        noise = norm_err(want16[name], want32[name])   # the reference's own bf16 error
        err = norm_err(got16[name], want16[name])
        assert err <= max(GRAD_BF16_NOISE_FACTOR * noise, 1e-2) and err < 0.5, (name, err, noise)


@pytest.mark.parametrize("route", ["cudnn_f32", "cudnn_bf16"])
def test_fused_weights_are_built_once_and_follow_the_parameters(variables, route):
    """Outside autograd a fused route rounds and casts each direction's
    weights once and reuses them; a parameter written in place rebuilds
    them (the JAX module on the new weights agrees again), and with
    gradients on the route differentiates through the parameters
    themselves (its gradient equals the plain loop's in f32)."""
    mdef = get_model_def("bilstm", **CFG, compute_dtype="float32")
    module = mdef.to_model(variables).params
    x, n = torch.from_numpy(MIXED_TOKENS), torch.from_numpy(MIXED_LENGTHS)
    with torch.no_grad():
        module(x, n, route=route)
        first = module._fused.get("fwd", module.fwd, torch.float32, torch.float32
                                  if route == "cudnn_f32" else torch.bfloat16)
        module(x, n, route=route)
        again = module._fused.get("fwd", module.fwd, torch.float32, first[0].dtype)
        assert again is first
        module.fwd.weight_hh_l0.mul_(0.5)
        got = module(x, n, route=route).numpy()
        assert module._fused.get("fwd", module.fwd, torch.float32, first[0].dtype) is not first
    halved = jax.tree.map(np.asarray, variables)
    halved["params"]["OptimizedLSTMCell_0"] = {
        k: ({**v, "kernel": v["kernel"] * np.float32(0.5)} if k.startswith("h") else v)
        for k, v in halved["params"]["OptimizedLSTMCell_0"].items()}
    assert rel_err(got, jax_logits(halved, "float32", MIXED_TOKENS, MIXED_LENGTHS)) <= \
        tolerance("float32", route)
    grads = {}
    for r in (route, "plain"):
        module.zero_grad()
        module(x, n, route=r).square().sum().backward()
        grads[r] = {k: p.grad.clone() for k, p in module.named_parameters() if p.grad is not None}
    assert "fwd.weight_hh_l0" in grads[route]
    tol = GRAD_F32_TOL if route == "cudnn_f32" else BF16_TOL
    for name, want in grads["plain"].items():
        if name.endswith("bias_ih_l0"):
            continue
        assert norm_err(grads[route][name], want) <= tol, name


def test_bilstm_example_job_gives_the_jax_jobs_labels():
    """``examples/bilstm_stream.py --smoke`` (24 records of
    ``synthetic_texts(24, 1000, 48)``, vocab 1000, hidden 64, ``rebalance
    -> count_window(8, timeout_s=0.05) -> ModelWindowFunction``, the JAX
    package's initial weights) through both packages: every id once, the
    JAX job's label wherever its top-2 gap exceeds twice the bf16
    tolerance, probabilities within it."""
    from examples.bilstm_stream import synthetic_texts

    cfg = dict(vocab_size=1000, hidden_dim=64)
    jdef = jax_model_def("bilstm", **cfg)
    variables = jax.tree.map(np.asarray, jax.jit(jdef.init_fn)(jax.random.key(0)))
    records = synthetic_texts(24, 1000, 48)

    env = JaxEnv(parallelism=1)
    want = (env.from_collection(records, parallelism=1, schema=jdef.input_schema).rebalance()
            .count_window(8, timeout_s=0.05)
            .apply(JaxModelWindowFunction(jdef.to_model(variables)), name="bilstm")
            .sink_to_list())
    env.execute("bilstm-text-classification", timeout=600)

    env = StreamExecutionEnvironment(parallelism=1)
    env.set_device_provider(lambda task, index: "cpu")
    got = (env.from_collection([TensorValue(dict(r.fields), dict(r.meta)) for r in records],
                               parallelism=1).rebalance()
           .count_window(8, timeout_s=0.05)
           .apply(ModelWindowFunction(get_model_def("bilstm", **cfg).to_model(variables)),
                  name="bilstm")
           .sink_to_list())
    env.execute(timeout=600)
    assert sorted(r.meta["id"] for r in got) == list(range(24))
    want_logits = np.stack([np.asarray(r["logits"]) for r in sorted(want, key=lambda r: r.meta["id"])])
    got_by_id = {r.meta["id"]: r for r in got}
    got_logits = np.stack([np.asarray(got_by_id[i]["logits"]) for i in range(24)])
    scale = np.abs(want_logits).max()
    assert np.abs(got_logits - want_logits).max() <= BF16_TOL * scale
    top2 = np.sort(want_logits, -1)
    clear = (top2[:, 1] - top2[:, 0]) > 2 * BF16_TOL * scale
    assert clear.sum() >= 12
    np.testing.assert_array_equal(
        np.array([int(got_by_id[i]["label"]) for i in range(24)])[clear],
        np.argmax(want_logits, -1)[clear])
