"""The transfer plane on the card (``cuda``-marked; they skip without an
NVIDIA GPU).  This file imports neither flax nor the JAX package, so it
collects on a machine that has neither.

- The ring's arena is page-locked on the card route.
- Under a stress run with six transfer lanes and a ring of four batches,
  no slot is written again before the H2D event of the batch that last
  claimed it has completed, and the outputs equal the list path's.
- Narrowing on the card route gives the CPU route's bytes, and the
  widened values are equal.
"""

import threading

import numpy as np
import pytest
import torch

from flink_tensorflow_tpu_torch import StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.functions.model_function import ModelWindowFunction
from flink_tensorflow_tpu_torch.models import lenet_cell
from flink_tensorflow_tpu_torch.native.ring import TensorRing
from flink_tensorflow_tpu_torch.tensors.batching import Batch, BucketPolicy
from flink_tensorflow_tpu_torch.tensors.transfer import DeviceTransfer, scale_key


def needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.fixture(scope="module")
def lenet():
    needs_cuda()
    _, model, _, records = lenet_cell.lenet_cell(0, records=4096)
    return model, records


@pytest.mark.cuda
def test_the_arena_is_pinned(lenet):
    model, _ = lenet
    f = ModelWindowFunction(model, policy=BucketPolicy(fixed_batch=64))
    f.open(type("Ctx", (), {"device": "cuda", "metrics": None})())
    try:
        ring = f._ring
        assert ring.arena.is_pinned() and ring.pinned_bytes == ring.arena.numel()
        assert ring.capacity == 4 * 64      # (pipeline depth 2 - 1 + 3) batches
    finally:
        f.close()
    assert ring.closed


def run(model, records, **kw):
    env = StreamExecutionEnvironment(parallelism=1)
    out = (env.from_collection(records).count_window(64)
           .apply(ModelWindowFunction(model, policy=BucketPolicy(fixed_batch=64),
                                      outputs=("label", "logits"), transfer_lanes=6, **kw),
                  name="m")
           .sink_to_list())
    result = env.execute(timeout=300)
    return out, result.metrics


@pytest.mark.cuda
def test_no_slot_is_reused_before_its_h2d_event_completes(lenet, monkeypatch):
    model, records = lenet
    lock = threading.Lock()
    shipped = []          # (first byte, end byte, H2D event) of each ring batch
    violations = []
    ship_batch, try_push = DeviceTransfer.ship_batch, TensorRing.try_push

    def recording_ship(self, batch):
        out = ship_batch(self, batch)
        a = batch.arrays["image"]
        with lock:
            shipped.append((a.ctypes.data, a.ctypes.data + a.nbytes, out.copied))
        return out

    def checked_push(self, record):
        # The slot this push takes; the ring's copier writes it after.
        if self._ring.poppable() < self.capacity:
            slot = self._submitted & (self.capacity - 1)
            at = self._regions["image"][slot:slot + 1].ctypes.data
            with lock:
                for lo, hi, event in shipped:
                    if lo <= at < hi and not event.query():
                        violations.append(slot)
                shipped[:] = [x for x in shipped if not x[2].query()]
        return try_push(self, record)

    monkeypatch.setattr(DeviceTransfer, "ship_batch", recording_ship)
    monkeypatch.setattr(TensorRing, "try_push", checked_push)
    # Pipeline depth 12 against a ring of 4 batches: ingestion waits on
    # the oldest batch again and again, and every slot is reused 16 times.
    on, metrics = run(model, records, ring_capacity=256)
    monkeypatch.undo()
    off, _ = run(model, records, use_ring=False)
    assert violations == []
    assert metrics["m.0.ring_batches"] == 64
    assert [r.meta["id"] for r in on] == [r.meta["id"] for r in off] == list(range(4096))
    for a, b in zip(on, off):
        assert np.array_equal(a["logits"], b["logits"]) and a["label"] == b["label"]


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["bf16", "f16", "int8"])
def test_narrowing_on_the_card_equals_the_cpu_path(wire):
    needs_cuda()
    rng = np.random.RandomState(2)
    x = (rng.standard_normal((64, 28, 28, 1)) * 3).astype(np.float32)
    batch = Batch(arrays={"image": x}, valid=np.ones(64, bool), lengths={}, metas=[{}] * 64)
    card = DeviceTransfer(torch.device("cuda"), wire_dtype=wire)
    cpu = DeviceTransfer(torch.device("cpu"), wire_dtype=wire)
    want, saved = cpu._narrow_arrays({"image": x})
    got = card.ship_batch(batch)
    torch.cuda.synchronize()
    assert got.wire_saved == saved
    t = got.inputs["image"]
    assert t.is_cuda
    bits = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    assert bits.cpu().numpy().tobytes() == np.asarray(want["image"]).tobytes()
    host = cpu.ship_batch(batch)
    widened = t.float()
    cpu_widened = host.inputs["image"].float()
    if wire == "int8":
        assert float(got.inputs[scale_key("image")].cpu()) == float(want[scale_key("image")])
        widened = widened * got.inputs[scale_key("image")]
        cpu_widened = cpu_widened * host.inputs[scale_key("image")]
    assert torch.equal(widened.cpu(), cpu_widened)
