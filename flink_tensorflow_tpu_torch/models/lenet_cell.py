"""The MNIST LeNet streaming cell (``BASELINE.json`` config 2).

The JAX package's MNIST bench (``bench.py:bench_mnist``, ``:1708-1773``)
at its full size: 16,384 f32 28x28x1 records from
``np.random.RandomState(0).rand``, each with its own bytes and an id,
through ``from_collection -> count_window(512, timeout_s=5.0) ->
ModelWindowFunction(fixed_batch=512, warmup_batches=(512,),
outputs=("label",)) -> sink_to_callable`` at parallelism 1, LeNet-5 with
10 classes in bf16.  Weights are the port's initialiser's, from
``torch.Generator`` seed ``seed``.
"""

from __future__ import annotations

import typing

import numpy as np

from flink_tensorflow_tpu_torch.functions.model_function import ModelWindowFunction
from flink_tensorflow_tpu_torch.models.stream_cell import CellRun, run_job
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.tensors.batching import BucketPolicy
from flink_tensorflow_tpu_torch.tensors.value import TensorValue

RECORDS = 16384
BATCH = 512
TIMEOUT_S = 5.0
NAME = "lenet"


def lenet_cell(seed: int = 0, records: int = RECORDS):
    """``(model_def, model, images [records, 28, 28, 1] f32, records)``."""
    mdef = get_model_def("lenet")
    model = mdef.to_model(mdef.init_params(seed))
    images = np.random.RandomState(0).rand(records, 28, 28, 1).astype(np.float32)
    # Read-only: each TensorValue shares its row instead of copying it.
    images.setflags(write=False)
    values = [TensorValue({"image": images[i]}, {"id": i}) for i in range(records)]
    return mdef, model, images, values


def run_cell(model, records: typing.Sequence[TensorValue], *, batch: int = BATCH,
             device_provider=None, warmup: bool = True, timeout: float = 600.0,
             **options) -> CellRun:
    """Run the cell's job once; ``options`` go to the window function
    (``wire_dtype``, ``use_ring``, ...)."""
    fn = ModelWindowFunction(model, policy=BucketPolicy(fixed_batch=batch),
                             warmup_batches=(batch,) if warmup else (), outputs=("label",),
                             **options)
    return run_job(records, lambda s: s.count_window(batch, timeout_s=TIMEOUT_S)
                   .apply(fn, name=NAME),
                   device_provider=device_provider, timeout=timeout)
