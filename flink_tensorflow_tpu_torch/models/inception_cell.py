"""The Inception-v3 streaming cell the port is measured on.

The JAX package's own Inception bench (``bench.py:bench_inception``,
``:771-835``), at its full size: 2048 uint8 299x299x3 records from
``np.random.RandomState(0)``, each with its own bytes, through
``from_collection -> count_window(128, timeout_s=5.0) ->
ModelWindowFunction(fixed_batch=128, warmup_batches=(128,),
outputs=("label", "score"), pipeline_depth=6) -> sink_to_callable``, at
parallelism 1, Inception-v3 with 1000 classes in bf16.  Weights are the
port's initialiser's, from ``torch.Generator`` seed ``seed``.
"""

from __future__ import annotations

import typing

import numpy as np

from flink_tensorflow_tpu_torch.functions.model_function import ModelWindowFunction
from flink_tensorflow_tpu_torch.models.stream_cell import run_job
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.tensors.batching import BucketPolicy
from flink_tensorflow_tpu_torch.tensors.value import TensorValue

RECORDS = 2048
BATCH = 128
DEPTH = 6
CLASSES = 1000
IMAGE = 299
TIMEOUT_S = 5.0


def inception_cell(seed: int = 0, records: int = RECORDS):
    """``(model_def, model, pixels [records, 299, 299, 3] uint8, records)``."""
    mdef = get_model_def("inception_v3", num_classes=CLASSES, image_size=IMAGE,
                         uint8_input=True)
    model = mdef.to_model(mdef.init_params(seed))
    pixels = np.random.RandomState(0).randint(0, 256, (records, IMAGE, IMAGE, 3),
                                              dtype=np.uint8)
    # Read-only: each TensorValue shares its row instead of copying it.
    pixels.setflags(write=False)
    values = [TensorValue({"image": pixels[i]}, {"id": i}) for i in range(records)]
    return mdef, model, pixels, values


def run_cell(model, records: typing.Sequence[TensorValue], *, device_provider=None,
             warmup: bool = True, timeout: float = 600.0):
    """Run the cell's job once in the default layout.  Returns
    ``(results, sink arrival times, metric report, seconds of
    execute())``; :func:`run_cell_job` returns the whole ``CellRun`` and
    picks the layout."""
    run = run_cell_job(model, records, device_provider=device_provider, warmup=warmup,
                       timeout=timeout)
    return run.results, run.arrivals, run.metrics, run.seconds


def run_cell_job(model, records: typing.Sequence[TensorValue], *, device_provider=None,
                 warmup: bool = True, timeout: float = 600.0, chaining: bool = True):
    """Run the cell's job once (``chaining=False``: one thread per
    operator) and return its ``CellRun``."""
    fn = ModelWindowFunction(model, policy=BucketPolicy(fixed_batch=BATCH),
                             warmup_batches=(BATCH,) if warmup else (),
                             outputs=("label", "score"), pipeline_depth=DEPTH)
    return run_job(records, lambda s: s.count_window(BATCH, timeout_s=TIMEOUT_S)
                   .apply(fn, name="inception"),
                   device_provider=device_provider, timeout=timeout,
                   config={"chaining": chaining})


def trailing_exclude(records: int = RECORDS) -> int:
    """``bench.py``'s exclusion: the last ``pipeline_depth`` windows."""
    return max(0, min(DEPTH * BATCH, records - 2 * BATCH))
