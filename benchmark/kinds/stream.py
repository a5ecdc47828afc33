"""``stream``: the closed loop, ``source -> count_window(window, timeout_s)
-> ModelWindowFunction(fixed batch, warmup, lanes, depth) -> sink``
through the ring, on the configuration's model.

The check takes a sample of the results that reached the sink inside the
window, drawn from the seed (reservoir sampling), each matched to its own
record id, and runs the reference over the same pixels after the window.
"""

from __future__ import annotations

import math
import time
import typing

import numpy as np

from benchmark import check, jobs, load, weights
from benchmark.reference import arith as ref_arith
from flink_tensorflow_tpu_torch.functions.model_function import ModelWindowFunction
from flink_tensorflow_tpu_torch.tensors.batching import BucketPolicy
from flink_tensorflow_tpu_torch.tensors.value import TensorValue


class Reservoir:
    """A uniform sample of ``size`` items of a stream, from ``seed``, with
    a comparison per item and a draw only where an item is taken
    (Li's Algorithm L)."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.items: typing.List[typing.Any] = []
        self.seen = 0
        self._rng = np.random.default_rng([int(seed), 3])
        self._w = 1.0
        self._next = size

    def _skip(self) -> None:
        self._w *= math.exp(math.log(1.0 - self._rng.random()) / self.size)
        self._next += int(math.log(1.0 - self._rng.random()) / math.log1p(-self._w)) + 1

    def offer(self, make: typing.Callable[[], typing.Any]) -> None:
        """Count one item; take ``make()`` if the sample takes it."""
        k = self.seen
        self.seen += 1
        if k < self.size:
            self.items.append(make())
            if k == self.size - 1:
                self._skip()
        elif k == self._next:
            self.items[int(self._rng.integers(self.size))] = make()
            self._skip()


class StreamJob(jobs.Job):
    kind = "stream"
    loop = "inference"

    def __init__(self, cell, seed, device, trace):
        super().__init__(cell, seed, device, trace)
        mix = self.mix
        self.pool = load.pool(seed, mix["pool"], jobs.image_shape(self.config), salt=1)
        self.mdef, module = jobs.port_model(self.config, seed, device)
        self.model = self.mdef.to_model(module)
        self.kept = Reservoir(int(mix["check_sample"]), seed)
        self.batch = int(mix["window"])
        self._back = 0
        fn = ModelWindowFunction(
            self.model, policy=BucketPolicy(fixed_batch=self.batch),
            warmup_batches=(self.batch,), outputs=tuple(mix["outputs"]),
            transfer_lanes=int(mix["transfer_lanes"]), pipeline_depth=int(mix["pipeline_depth"]))
        source = jobs.Closed(self.make, self.batch, self.feed, int(mix["outstanding"]))
        (self.env.from_source(source, name="source")
         .count_window(self.batch, timeout_s=float(mix["timeout_s"]))
         .apply(fn, name="model")
         .sink_to_callable(self.sink))

    def make(self, i: int) -> TensorValue:
        return TensorValue({"image": self.pool[i % len(self.pool)]}, {"id": i})

    def sink(self, record) -> None:
        now = time.monotonic()
        rid = int(record.meta["id"])
        with self.lock:
            self.times.append(now)
            self.ids.append(rid)
        self._back += 1
        if self._back == self.batch:     # a window's results: the source may go on
            self.feed.back(self._back)
            self._back = 0
        if self.t0 <= now < self.t1:
            self.kept.offer(lambda: (rid, np.array(record["logits"], np.float32),
                                     int(record["label"])))

    def warm(self) -> bool:
        return len(self.times) >= int(self.mix["warmup_records"])

    def check(self):
        kept = sorted(self.kept.items, key=lambda item: item[0])
        ids = np.array([rid for rid, _, _ in kept])
        logits = np.stack([lg for _, lg, _ in kept])
        labels = np.array([label for _, _, label in kept])
        ref = weights.reference_module(self.config, self.seed, self.device)
        ref_arith.no_tf32()
        ref_logits = check.reference_logits(ref, self.pool[ids % len(self.pool)], self.device)
        return check.forward_numbers(ref_logits, logits, labels), self.attempted(), self.failed()

    def attempted(self) -> int:
        return self.in_window(self.t0, self.t1) + self.failed()

    def failed(self) -> int:
        """Records emitted whose result never came, or came twice."""
        with self.lock:
            ids = list(self.ids)
        return (self.feed.emitted - len(set(ids))) + (len(ids) - len(set(ids)))


JOB = StreamJob
