"""``serving.continuous_batching`` on a keyed stream of the port's runtime,
held to the JAX package's ``run_pipeline`` (``tests/test_serving.py``) on
the same weights (JAX's initialiser, carried over by
``models/convert.py:params_from_jax``): an uninterrupted run, a crash
mid-generation restarted from count-based checkpoints, and a crash at
parallelism 2 restored at parallelism 3 all give the JAX tokens byte for
byte.  Twins of ``tests/test_serving.py::TestServingFailover``."""

import numpy as np
import pytest

import jax

from flink_tensorflow_tpu import StreamExecutionEnvironment as JaxEnv
from flink_tensorflow_tpu import serving as jax_serving
from flink_tensorflow_tpu.models import get_model_def as jax_model_def
from flink_tensorflow_tpu_torch import RestartStrategy, StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.checkpoint.store import latest_checkpoint_id
from flink_tensorflow_tpu_torch.core import functions as fn
from flink_tensorflow_tpu_torch.core.runtime import JobFailure
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.serving import GenerateRequest, ServingConfig, continuous_batching

CAPACITY = 40
CFG = dict(vocab_size=48, embed_dim=32, num_heads=2, num_layers=2, capacity=CAPACITY)
SERVING = dict(max_active_seqs=3, token_budget=80, capacity=CAPACITY)


@pytest.fixture(scope="module")
def models():
    jdef = jax_model_def("char_transformer", **CFG)
    params = jdef.init_params(jax.random.PRNGKey(0))
    port = get_model_def("char_transformer", **CFG).to_model(jax.tree.map(np.asarray, params))
    return jdef.to_model(params), port


def make_requests(n, max_new, seed, cls=GenerateRequest):
    rng = np.random.RandomState(seed)
    return [cls(session_id=f"s{i}", prompt=rng.randint(1, 48, (int(rng.randint(4, 10)),)),
                max_new_tokens=max_new)
            for i in range(n)]


def tokens_by_session(events):
    out = {}
    for ev in events:
        if ev.index < 0:
            continue
        prev = out.setdefault(ev.session_id, {}).get(ev.index)
        # At-least-once delivery may repeat an index across a restart, but
        # a repeat must never differ (greedy decoding).
        assert prev is None or prev == ev.token, (ev.session_id, ev.index)
        out[ev.session_id][ev.index] = ev.token
    return {sid: [toks[i] for i in sorted(toks)] for sid, toks in out.items()}


def jax_tokens(jmodel, n, max_new, seed, parallelism=1):
    env = JaxEnv(parallelism=1)
    out = jax_serving.continuous_batching(
        env.from_collection(make_requests(n, max_new, seed, jax_serving.GenerateRequest))
        .key_by(lambda r: r.session_id),
        jmodel, config=jax_serving.ServingConfig(**SERVING),
        parallelism=parallelism).sink_to_list()
    env.execute("jax-ref", timeout=300)
    return tokens_by_session(out)


def run_pipeline(env, model, requests, parallelism=1, tap=None):
    env.set_device_provider(lambda task, index: "cpu")
    stream = continuous_batching(
        env.from_collection(requests, parallelism=1).key_by(lambda r: r.session_id),
        model, config=ServingConfig(**SERVING), parallelism=parallelism)
    if tap is not None:
        stream = stream.map(tap, name="tap")
    return stream.sink_to_list()


class CrashOnce(fn.MapFunction):
    """Passes TokenEvents through and raises once, at the ``at``-th."""

    def __init__(self, at):
        self.at = at
        self.seen = 0
        self.crashed = False

    def clone(self):
        return self  # one counter across subtasks and restarts

    def map(self, value):
        self.seen += 1
        if not self.crashed and self.seen >= self.at:
            self.crashed = True
            raise RuntimeError("injected mid-generation crash")
        return value


def test_uninterrupted_pipeline_equals_jax(models):
    jmodel, model = models
    want = jax_tokens(jmodel, 8, 12, seed=5)
    env = StreamExecutionEnvironment(parallelism=1)
    out = run_pipeline(env, model, make_requests(8, 12, seed=5), parallelism=2)
    env.execute("port", timeout=120)
    assert tokens_by_session(out) == want and len(want) == 8


def test_mid_generation_failover_byte_identical(models, tmp_path):
    jmodel, model = models
    want = jax_tokens(jmodel, 8, 32, seed=2)
    assert all(len(v) == 32 for v in want.values())
    tap = CrashOnce(at=192)
    env = StreamExecutionEnvironment(parallelism=1)
    # Count-based checkpoints: deterministic positions after the 4th and
    # 8th source records, so checkpoints with live caches precede the crash.
    env.enable_checkpointing(str(tmp_path / "chk"), every_n_records=4)
    env.source_throttle_s = 0.01
    out = run_pipeline(env, model, make_requests(8, 32, seed=2), tap=tap)
    result = env.execute("crash", timeout=300, restart_strategy=RestartStrategy(max_restarts=2))
    assert result.restarts == 1 and tap.crashed
    assert tokens_by_session(out) == want
    rep = env.metric_registry.report()
    # Restored sessions resumed from checkpointed caches, not re-prefilled.
    assert rep["continuous_batching.0.cache_h2d_blocks"] >= 1
    assert rep["recovery.restarts_total"] == 1
    assert rep["checkpoint.completed"] >= 2


def test_rescale_redistributes_sessions_by_key_group(models, tmp_path):
    """Crash at parallelism 2 after the last count-based checkpoint, with
    no restart strategy; restore at parallelism 3 in a fresh environment.
    The union of both runs' tokens equals the JAX run (sessions done before
    the checkpoint emitted in run 1; restored ones re-emit in full)."""
    jmodel, model = models
    want = jax_tokens(jmodel, 12, 24, seed=4, parallelism=2)
    d = str(tmp_path / "chk")
    env = StreamExecutionEnvironment(parallelism=1)
    env.enable_checkpointing(d, every_n_records=4)
    out1 = run_pipeline(env, model, make_requests(12, 24, seed=4), parallelism=2,
                        tap=CrashOnce(at=150))
    with pytest.raises(JobFailure):
        env.execute("phase1", timeout=300)
    assert latest_checkpoint_id(d) == 3
    env2 = StreamExecutionEnvironment(parallelism=1)
    env2.enable_checkpointing(d)
    out2 = run_pipeline(env2, model, make_requests(12, 24, seed=4), parallelism=3)
    env2.execute("rescaled", restore_from=d, restore_checkpoint_id=3, timeout=300)
    assert tokens_by_session(list(out1) + list(out2)) == want
    assert len(tokens_by_session(list(out2))) >= 1


def test_unkeyed_stream_raises_type_error(models):
    env = StreamExecutionEnvironment(parallelism=1)
    with pytest.raises(TypeError, match="KeyedStream"):
        continuous_batching(env.from_collection(make_requests(2, 4, seed=0)), models[1])
