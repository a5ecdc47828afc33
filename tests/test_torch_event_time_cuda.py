"""Event-time windows and the two-phase-commit sink with a model on the
card (``cuda``-marked; they skip without an NVIDIA GPU).  This file
imports neither flax nor the JAX package, so it collects on a machine
that has neither.

Inception-v3 at 75 px and 10 classes (the port's initialiser, bf16) on
``chip_smoke.py`` phase 11's stream at a small depth: 256 records as 8
cameras at 32 frames/s, shuffled within blocks of 64, watermarks every 64.

- (a) ``key_by(camera).time_window(1.0) -> ModelWindowFunction(
  fixed_batch=32, pipeline_depth=3)``: every result stamped with its own
  window's end, labels and scores equal to a direct call on the card on
  each window's records in arrival order, bit for bit, and a downstream
  ``time_window_all(1.0)`` sees no late record.
- (d) the same model job into ``ExactlyOnceRecordFileSink`` with
  checkpoints every 64 records and one crash after checkpoint 2 under
  ``RestartStrategy(max_restarts=1)``: the committed records equal (a)'s,
  each once.
"""

import copy
import threading

import numpy as np
import pytest
import torch

from flink_tensorflow_tpu_torch import RestartStrategy, StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.checkpoint.store import latest_checkpoint_id
from flink_tensorflow_tpu_torch.core import functions as fn
from flink_tensorflow_tpu_torch.functions.model_function import ModelWindowFunction
from flink_tensorflow_tpu_torch.io.files import ExactlyOnceRecordFileSink, read_committed
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.tensors.batching import BucketPolicy
from flink_tensorflow_tpu_torch.tensors.value import TensorValue

N, CAMERAS, FPS, BLOCK, SIZE = 256, 8, 32, 64, 75


def needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.fixture(scope="module")
def cell():
    needs_cuda()
    mdef = get_model_def("inception_v3", num_classes=10, image_size=SIZE, uint8_input=True)
    model = mdef.to_model(mdef.init_params(0))
    pixels = np.random.RandomState(0).randint(0, 256, (N, SIZE, SIZE, 3), dtype=np.uint8)
    rng = np.random.RandomState(1)
    order = np.concatenate([lo + rng.permutation(BLOCK) for lo in range(0, N, BLOCK)])
    times = (np.arange(N) // CAMERAS) / FPS
    records = [TensorValue({"image": pixels[i]},
                           {"id": int(i), "camera": int(i % CAMERAS), "t": float(times[i])})
               for i in order]
    return mdef, model, pixels, order, times, records


class Stamps(fn.ProcessFunction):
    def __init__(self):
        self.stamps, self.lock = {}, threading.Lock()

    def clone(self):
        return self

    def process_element(self, value, ctx, out):
        with self.lock:
            self.stamps[int(value.meta["id"])] = ctx.timestamp
        out.collect(value, ctx.timestamp)


class Count(fn.WindowFunction):
    def process_window(self, key, window, elements, out):
        out.collect((window.start, len(elements)))


def windows(env, model, records):
    return (env.from_collection(records)
            .assign_timestamps(lambda r: r.meta["t"], out_of_orderness_s=0.25, watermark_every=64)
            .key_by(lambda r: r.meta["camera"]).time_window(1.0)
            .apply(ModelWindowFunction(model, outputs=("label", "score"),
                                       policy=BucketPolicy(fixed_batch=32),
                                       warmup_batches=(32,), pipeline_depth=3), name="model"))


@pytest.mark.cuda
def test_keyed_time_windows_stamp_each_result_with_its_window_end(cell):
    needs_cuda()
    mdef, model, pixels, order, times, records = cell
    tap = Stamps()
    env = StreamExecutionEnvironment(parallelism=1)
    results = windows(env, model, records).process(tap)
    got = results.sink_to_list()
    counted = results.time_window_all(1.0).apply(Count(), late_tag="late")
    counts = counted.sink_to_list()
    late = counted.side_output("late").sink_to_list()
    env.execute(timeout=300)
    assert sorted(int(r.meta["id"]) for r in got) == list(range(N))
    assert tap.stamps == {i: float(times[i] // 1 + 1) for i in range(N)}
    assert late == [] and sorted(counts) == [(1.0, 256)]
    by_id = {int(r.meta["id"]): r for r in got}
    module = copy.deepcopy(model.params).to("cuda").eval()
    serve = mdef.methods["serve"].fn
    with torch.inference_mode():
        for cam in range(CAMERAS):
            ids = [int(i) for i in order if i % CAMERAS == cam]
            out = serve(module, {"image": torch.from_numpy(pixels[ids]).cuda()})
            labels, scores = out["label"].cpu().numpy(), out["score"].cpu().numpy()
            for j, i in enumerate(ids):
                assert int(by_id[i]["label"]) == labels[j] and float(by_id[i]["score"]) == scores[j]


class CrashOnce(fn.MapFunction):
    def __init__(self, at, directory):
        self.at, self.directory, self.seen, self.crashed = at, directory, 0, False

    def clone(self):
        return self

    def map(self, value):
        self.seen += 1
        if (not self.crashed and self.seen >= self.at
                and (latest_checkpoint_id(self.directory) or 0) >= 2):
            self.crashed = True
            raise RuntimeError("injected crash")
        return value


@pytest.mark.cuda
def test_two_phase_commit_sink_is_exactly_once_across_a_crash(cell, tmp_path):
    needs_cuda()
    _, model, _, _, _, records = cell
    env = StreamExecutionEnvironment(parallelism=1)
    clean = windows(env, model, records).sink_to_list()
    env.execute(timeout=300)
    chk, out = str(tmp_path / "chk"), str(tmp_path / "out")
    env = StreamExecutionEnvironment(parallelism=1)
    env.enable_checkpointing(chk, every_n_records=64)
    tap = CrashOnce(N // 2, chk)
    windows(env, model, records).map(tap).add_sink(ExactlyOnceRecordFileSink(out))
    result = env.execute(timeout=300, restart_strategy=RestartStrategy(max_restarts=1))
    assert result.restarts == 1 and tap.crashed
    committed = read_committed(out)
    assert sorted(int(r.meta["id"]) for r in committed) == list(range(N))
    want = {int(r.meta["id"]): (int(r["label"]), float(r["score"])) for r in clean}
    assert {int(r.meta["id"]): (int(r["label"]), float(r["score"])) for r in committed} == want
