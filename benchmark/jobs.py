"""What every kind of job a traffic mix runs shares.

A mix's ``"job"`` names a kind, a module ``kinds/<kind>.py`` whose
``JOB`` is a subclass of :class:`Job` built through the program's own
entry points (``kinds/stream.py``: the closed loop into
``ModelWindowFunction``; ``kinds/train.py``: the closed loop into
``DPTrainWindowFunction``).  So a later change adds a kind as a file.

Each job builds the weights and the record pool from the seed, starts
the program's job, and reports when it is warm (:meth:`Job.warm`); the
harness then measures the window and calls :meth:`Job.finish` and
:meth:`Job.check`.  The sink keeps, for every result, its id and the
time it arrived, so every rate is over all the window's work.

A kind says what loop it drives (:attr:`Job.loop`), which the rate
readers go by, and prices its record for the traced run's rooflines
and MFU (:meth:`Job.work_count`): by default an image forward pass or a
training step's batch; a kind whose records are token sequences prices
its own, a served request being its prefill and its decode steps.
"""

from __future__ import annotations

import os
import threading
import typing

import numpy as np
import torch

from benchmark import load, spec, weights
from benchmark.reference import count as counting
from flink_tensorflow_tpu_torch.core import functions as port_fn
from flink_tensorflow_tpu_torch.core.environment import StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def

#: Seconds a job may take to end once its source stops.
END_S = 120.0


def kind(name: str, base: str = spec.HERE) -> typing.Type["Job"]:
    """The job class of the kind a mix names: ``JOB`` of
    ``<base>/kinds/<name>.py``, loaded by path as the metric readers are."""
    return spec.load_module(os.path.join(base, "kinds", name + ".py"), "JOB")


class Closed(load.ClosedSource, port_fn.SourceFunction):
    pass


def image_shape(config) -> typing.Tuple[int, int, int]:
    return (config["image_size"], config["image_size"], 3)


def port_model(config, seed: int, device: torch.device):
    """``(model def, the program's module)`` with the seed's weights."""
    mdef = get_model_def(config["architecture"], **config["port"])
    with torch.device(device):
        module = mdef.make_module()
    weights.into_program(config, module, seed, device)
    return mdef, module


class Job:
    """What every kind shares: the environment, the sink's arrival log,
    the window and the registry readings."""

    kind = ""
    #: The loop the job drives, which the end-to-end rate readers go by:
    #: ``"inference"`` (a closed loop whose records' results reach the
    #: sink, ``metrics/records_per_s.py``) or ``"training"``
    #: (``metrics/train_records_per_s.py``).
    loop = ""

    def __init__(self, cell, seed: int, device: torch.device, trace: bool):
        self.cell = cell
        self.config = cell.config
        self.mix = cell.mix
        self.seed = seed
        self.device = device
        self.t0 = self.t1 = float("nan")
        #: The marks the program's counters are read between: the
        #: window, or in a traced run the profiled slice.
        self.counted = ("t0", "t1")
        self.handle = None
        self.env = StreamExecutionEnvironment(parallelism=1)
        self.env.configure(trace=trace)
        if device.type != "cuda":   # the CPU tests only
            self.env.set_device_provider(lambda name, index: str(device))
        self.lock = threading.Lock()
        self.times: typing.List[float] = []
        self.ids: typing.List[int] = []
        self.feed = load.Feed()
        self._marks: typing.Dict[str, typing.Dict[typing.Tuple[str, str], int]] = {}

    # -- the harness's view ---------------------------------------------------
    def start(self) -> None:
        self.handle = self.env.execute_async(self.kind)

    def warm(self) -> bool:
        raise NotImplementedError

    def mark(self, at: str) -> None:
        """Note how many values each histogram of the job holds, so a
        reader can take the values between two marks alone."""
        self._marks[at] = {key: h.count for key, h in self._histograms().items()}

    def _histograms(self):
        return {key: m for key, m in self.handle.metrics.all_metrics().items()
                if hasattr(m, "values") and hasattr(m, "count")}

    def counted_values(self, name: str) -> typing.List[float]:
        """The values histograms named ``name`` took between the marks
        ``counted`` names."""
        start, end = self.counted
        out: typing.List[float] = []
        for key, hist in self._histograms().items():
            if key[1] != name:
                continue
            a = self._marks.get(start, {}).get(key, 0)
            b = self._marks.get(end, {}).get(key, hist.count)
            values = hist.values
            if b <= len(values):    # the reservoir has not overflowed
                out.extend(values[a:b])
        return out

    def in_window(self, t0: float, t1: float) -> int:
        """Results that reached the sink in ``[t0, t1)``."""
        with self.lock:
            times = np.asarray(self.times)
        return int(((times >= t0) & (times < t1)).sum())

    def stop(self) -> None:
        self.feed.stop.set()

    def finish(self) -> None:
        """Stop the load and wait for the job to end."""
        self.stop()
        self.handle.wait(END_S)

    def check(self) -> typing.Tuple[typing.Dict[str, float], int, int]:
        """``(numbers read, records attempted, records failed)``."""
        raise NotImplementedError

    def work_count(self) -> counting.Count:
        """The work of one record, which the traced run's rooflines and
        MFU read: here the configuration's reference on an image forward,
        or in a training loop on a step's batch of
        ``train_batch_per_worker`` (``reference/count.py``)."""
        config = self.config
        train = self.loop == "training"
        return counting.count(
            weights.reference_class(config),
            {**weights.reference_kwargs(config), "compute_dtype": config["compute_dtype"]},
            batch=int(config["train_batch_per_worker"]) if train else 1,
            image_size=config["image_size"], train=train)
