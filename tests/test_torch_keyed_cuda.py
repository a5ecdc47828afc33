"""Keyed serving and checkpoints of the port on the card (``cuda``-marked;
they skip without an NVIDIA GPU).  This file imports neither flax nor the
JAX package, so it collects on a machine that has neither.

- A checkpoint written by a keyed serving job on the card restores on
  ``device="cpu"``, and tensors in keyed state come back as CPU tensors.
- A restart frees the failed attempt's KV pool before it opens its own.
"""

import numpy as np
import pytest
import torch

from flink_tensorflow_tpu_torch import (
    ProcessFunction,
    RestartStrategy,
    StateDescriptor,
    StreamExecutionEnvironment,
)
from flink_tensorflow_tpu_torch.checkpoint.store import latest_checkpoint_id, read_checkpoint
from flink_tensorflow_tpu_torch.core import functions as fn
from flink_tensorflow_tpu_torch.core.runtime import JobFailure
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.serving import GenerateRequest, ServingConfig
from flink_tensorflow_tpu_torch.serving.cell import keyed_job

CFG = dict(vocab_size=48, embed_dim=32, num_heads=2, num_layers=2, capacity=40)
SERVING = ServingConfig(max_active_seqs=3, token_budget=80, capacity=40)


def needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def requests(n=10, max_new=16, seed=4):
    rng = np.random.RandomState(seed)
    return [GenerateRequest(session_id=f"s{i}", prompt=rng.randint(1, 48, (int(rng.randint(4, 10)),)),
                            max_new_tokens=max_new) for i in range(n)]


def tokens(events):
    out = {}
    for ev in events:
        if ev.index >= 0:
            prev = out.setdefault(ev.session_id, {}).get(ev.index)
            assert prev is None or prev == ev.token, (ev.session_id, ev.index)
            out[ev.session_id][ev.index] = ev.token
    return {sid: [t[i] for i in sorted(t)] for sid, t in out.items()}


class CrashOnce(fn.MapFunction):
    def __init__(self, at):
        self.at, self.seen, self.crashed = at, 0, False

    def clone(self):
        return self

    def map(self, value):
        self.seen += 1
        if not self.crashed and self.seen >= self.at:
            self.crashed = True
            raise RuntimeError("injected crash")
        return value


def model():
    mdef = get_model_def("char_transformer", **CFG)
    return mdef.to_model(mdef.init_params(3))


def walk(obj):
    if isinstance(obj, dict):
        for v in obj.values():
            yield from walk(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from walk(v)
    else:
        yield obj


@pytest.mark.cuda
def test_card_checkpoint_restores_on_the_cpu(tmp_path):
    needs_cuda()
    m, reqs = model(), requests()
    env, ref = keyed_job(m, SERVING, reqs, device="cpu")
    env.execute(timeout=300)
    want = tokens(ev for _, ev in ref)

    d = str(tmp_path)
    env, first = keyed_job(m, SERVING, reqs, tap=CrashOnce(len(ref) // 2))
    env.enable_checkpointing(d, every_n_records=3)
    with pytest.raises(JobFailure):
        env.execute(timeout=300)
    cid, snaps = read_checkpoint(d)
    assert not any(isinstance(x, torch.Tensor) and x.device.type != "cpu" for x in walk(snaps))
    env, second = keyed_job(m, SERVING, reqs, device="cpu")
    env.execute(timeout=300, restore_from=d, restore_checkpoint_id=cid)
    assert tokens([ev for _, ev in first] + [ev for _, ev in second]) == want
    assert env.metric_registry.report()["continuous_batching.0.cache_h2d_blocks"] >= 1


@pytest.mark.cuda
def test_cuda_tensors_in_keyed_state_read_back_as_cpu_tensors(tmp_path):
    needs_cuda()
    acc = StateDescriptor("acc")

    class Accumulate(ProcessFunction):
        def process_element(self, value, ctx, out):
            state = ctx.state(acc)
            prev = state.value()
            state.update(torch.full((4,), float(value), device="cuda")
                         + (0 if prev is None else prev))

    env = StreamExecutionEnvironment(parallelism=2)
    env.enable_checkpointing(str(tmp_path), every_n_records=10)
    env.from_collection(list(range(40))).key_by(lambda x: x % 3).process(Accumulate()) \
        .sink_to_list()
    env.execute(timeout=120)
    _, snaps = read_checkpoint(str(tmp_path))
    table = {}
    for snap in snaps["keyed_process"].values():
        table.update(snap["keyed"].get("acc", {}))
    assert set(table) == {0, 1, 2}
    for key, value in table.items():
        assert value.device.type == "cpu"
        assert value.tolist() == [float(sum(range(key, 40, 3)))] * 4


@pytest.mark.cuda
def test_restart_frees_the_failed_attempts_kv_pool(tmp_path):
    needs_cuda()
    m, reqs = model(), requests(n=12, max_new=24)
    d = str(tmp_path)
    env, out = keyed_job(m, SERVING, reqs, tap=CrashOnce(120))
    env.enable_checkpointing(d, every_n_records=4)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    result = env.execute(timeout=300, restart_strategy=RestartStrategy(max_restarts=1))
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    assert result.restarts == 1 and latest_checkpoint_id(d) is not None
    at_open = env.metric_registry.group("continuous_batching.0").histogram(
        "device_bytes_at_open").values
    pool = 2 * 4 * SERVING.max_active_seqs * CFG["num_layers"] * SERVING.capacity * CFG["embed_dim"]
    assert len(at_open) == 2
    assert at_open[1] - before < pool // 2, (before, at_open, pool)
    assert after - before < pool // 2, (before, after, pool)
    assert set(tokens(ev for _, ev in out)) == {r.session_id for r in reqs}
