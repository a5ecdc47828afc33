"""``train``: the closed loop into ``count_window(batch) ->
DPTrainWindowFunction(adam)`` on a ``{"data": 1}`` mesh, losses into the
sink.

The set-up drives the program's train function through its first steps
(the window's own call and feed, on rows that all differ) and reads its
state after them through the function's own ``snapshot_state``; the
same object trains on through the window.  The check replays those
steps in the reference.  Every step the window drives has to reach the
sink once, in order of its number, with a finite loss.
"""

from __future__ import annotations

import math
import time
import typing

import numpy as np
import torch

from benchmark import check, jobs, load, weights
from benchmark.reference import arith as ref_arith
from flink_tensorflow_tpu_torch.functions.training_function import DPTrainWindowFunction
from flink_tensorflow_tpu_torch.parallel import dp
from flink_tensorflow_tpu_torch.parallel.mesh import make_mesh
from flink_tensorflow_tpu_torch.parallel.optim import adam
from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, spec
from flink_tensorflow_tpu_torch.tensors.value import TensorValue


class _Capture:
    """States the set-up reads through the train function's own snapshot
    after the given windows (steps)."""

    def __init__(self, at: typing.Sequence[int]):
        self.at = set(at)
        self.windows = 0
        self.states: typing.Dict[int, typing.Any] = {}


class _CapturingTrain(DPTrainWindowFunction):
    """The program's train function, whose clone also hands the states
    after the check's steps to the set-up.  It adds nothing to a step."""

    bench_capture: typing.Optional[_Capture] = None

    def process_window(self, key, window, elements, out) -> None:
        super().process_window(key, window, elements, out)
        cap = self.bench_capture
        cap.windows += 1
        if cap.windows in cap.at:
            cap.states[cap.windows] = self.snapshot_state()["state"]


class TrainJob(jobs.Job):
    kind = "train"
    loop = "training"

    def __init__(self, cell, seed, device, trace):
        super().__init__(cell, seed, device, trace)
        config, mix = self.config, self.mix
        self.batch = int(config["train_batch_per_worker"])
        self.steps_checked = int(mix["check_steps"])
        shape = jobs.image_shape(config)
        self.pool = load.pool(seed, mix["pool"], shape, salt=2)
        self.labels = (np.arange(len(self.pool)) % int(config["num_classes"])).astype(np.int32)
        self.mdef, module = jobs.port_model(config, seed, device)
        opt = config["optimizer"]
        self.opt = opt
        optimizer = adam(opt["learning_rate"], opt["b1"], opt["b2"], opt["eps"])
        self.rng = weights.derive(seed, 5)
        variables = dp.module_variables(module)
        state = {"variables": variables, "opt_state": optimizer.init(variables["params"]),
                 "step": torch.zeros((), dtype=torch.int32), "rng": self.rng}
        self.port_names = [n for n, _ in module.named_parameters()]
        self.port_buffers = [n for n, _ in module.named_buffers()]
        schema = RecordSchema({"image": spec(shape, np.uint8), "label": spec((), np.int32)})
        fn = _CapturingTrain(self.mdef, optimizer, train_schema=schema, global_batch=self.batch)
        fn.bench_capture = self.capture = _Capture((1, self.steps_checked))
        fn.restore_state({"state": state})
        self.fn = fn
        self.env.set_mesh(make_mesh({"data": 1}, devices=[str(device)]))
        #: ``(step, loss)`` of every result, in the order it came.
        self.losses: typing.List[typing.Tuple[int, float]] = []
        source = jobs.Closed(self.make, self.batch, self.feed,
                             int(mix["outstanding_steps"]) * self.batch)
        (self.env.from_source(source, name="source")
         .count_window(self.batch)
         .apply(fn, name="train")
         .sink_to_callable(self.sink))

    def make(self, i: int) -> TensorValue:
        j = i % len(self.pool)
        return TensorValue({"image": self.pool[j], "label": self.labels[j]}, {"id": i})

    def sink(self, record) -> None:
        now = time.monotonic()
        step = int(record["step"])
        with self.lock:
            self.times.append(now)
            self.ids.append(step)
        self.losses.append((step, float(record["loss"])))
        self.feed.back(self.batch)

    def warm(self) -> bool:
        if len(self.times) >= int(self.mix["warmup_steps"]):
            # The job holds its own copy now; drop the set-up's.
            self.fn.restore_state({"state": None})
            return True
        return False

    def in_window(self, t0: float, t1: float) -> int:
        """Records in the steps whose loss reached the sink in the window."""
        return super().in_window(t0, t1) * self.batch

    def check(self):
        n = self.steps_checked
        cap = self.capture.states
        ref = weights.reference_module(self.config, self.seed, self.device)
        ref_arith.no_tf32()
        p0 = [p.detach().clone() for p in ref.parameters()]
        batches = [(self.pool[np.arange(k * self.batch, (k + 1) * self.batch) % len(self.pool)],
                    self.labels[np.arange(k * self.batch, (k + 1) * self.batch) % len(self.pool)])
                   for k in range(n)]
        opt = self.opt
        ref_losses, ref_grad, ref_after, ref_moments = check.reference_steps(
            ref, batches, rng=self.rng, lr=opt["learning_rate"], b1=opt["b1"], b2=opt["b2"],
            eps=opt["eps"], device=self.device)
        b1 = opt["b1"]
        mu = cap[1]["opt_state"]["mu"]
        prog_grad = [mu[name].float() / (1 - b1) for name in self.port_names]
        after = cap[n]["variables"]["params"]
        prog_delta = [after[name].float() - p.cpu() for name, p in zip(self.port_names, p0)]
        ref_delta = [a - p for a, p in zip(ref_after, p0)]
        first = dict(self.losses[:n])
        prog_losses = [first.get(k + 1, float("nan")) for k in range(n)]
        m = float(self.config["batch_norm_momentum"])
        bs = cap[1]["variables"]["batch_stats"]
        stats = [bs[name] for name in self.port_buffers]   # (mean, var) per norm
        # Running statistics start at mean 0 and variance 1 (weights.py).
        prog_moments = [(mean / (1 - m), (var - m) / (1 - m))
                        for mean, var in zip(stats[0::2], stats[1::2])]
        numbers = check.train_numbers(prog_losses, ref_losses, prog_grad, ref_grad,
                                      prog_delta, ref_delta, prog_moments, ref_moments)
        return numbers, self.attempted(), self.failed()

    def attempted(self) -> int:
        return self.in_window(self.t0, self.t1) + self.failed()

    def failed(self) -> int:
        """Records of the steps the source fed that did not reach the sink
        as step ``k`` in k-th place with a finite loss: a step lost, sent
        twice, out of order or with a loss that is not a number."""
        steps = self.feed.emitted // self.batch
        losses = list(self.losses)
        good = sum(1 for k, (step, loss) in enumerate(losses[:steps])
                   if step == k + 1 and math.isfinite(loss))
        return self.batch * (steps - good + max(0, len(losses) - steps))


JOB = TrainJob
