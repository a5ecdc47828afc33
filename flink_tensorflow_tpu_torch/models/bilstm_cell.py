"""The BiLSTM streaming cell (``BASELINE.json`` config 3): variable-length
records, length buckets and per-record lengths.

The JAX package's BiLSTM bench (``bench.py:bench_bilstm``, ``:1780-1846``)
at its full size: vocab 20,000, embed 128, hidden 256, 2 classes, bf16;
4,096 records of 4-192 int32 tokens drawn from ``np.random.RandomState(0)``
in the bench's order (``:1794-1800``: a length, then that many tokens),
each with its id and length; ``from_collection -> count_window(64,
timeout_s=5.0) -> ModelWindowFunction(warmup_batches=(64,),
warmup_length_bucket=256, outputs=("label", "prob")) -> sink_to_callable``
at parallelism 1.  Batches pad to the default ladders (powers of two in
both the batch and the length).  Weights are the port's initialiser's.
"""

from __future__ import annotations

import typing

import numpy as np

from flink_tensorflow_tpu_torch.functions.model_function import ModelWindowFunction
from flink_tensorflow_tpu_torch.models.stream_cell import CellRun, run_job
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.tensors.value import TensorValue

RECORDS = 4096
BATCH = 64
VOCAB = 20000
HIDDEN = 256
MAX_LEN = 192
WARMUP_LENGTH_BUCKET = 256
TIMEOUT_S = 5.0
NAME = "bilstm"


def bilstm_records(records: int = RECORDS, vocab: int = VOCAB, max_len: int = MAX_LEN,
                   seed: int = 0) -> typing.List[TensorValue]:
    rng = np.random.RandomState(seed)
    out = []
    for i in range(records):
        length = int(rng.randint(4, max_len + 1))
        out.append(TensorValue({"tokens": rng.randint(0, vocab, (length,)).astype(np.int32)},
                               {"id": i, "length": length}))
    return out


def bilstm_cell(seed: int = 0, records: int = RECORDS):
    """``(model_def, model, records)``."""
    mdef = get_model_def("bilstm", vocab_size=VOCAB, embed_dim=128, hidden_dim=HIDDEN,
                         num_classes=2)
    model = mdef.to_model(mdef.init_params(seed))
    return mdef, model, bilstm_records(records)


def run_cell(model, records: typing.Sequence[TensorValue], *, batch: int = BATCH,
             device_provider=None, warmup: bool = True, timeout: float = 600.0) -> CellRun:
    """Run the cell's job once."""
    fn = ModelWindowFunction(model, warmup_batches=(batch,) if warmup else (),
                             warmup_length_bucket=WARMUP_LENGTH_BUCKET,
                             outputs=("label", "prob"))
    return run_job(records, lambda s: s.count_window(batch, timeout_s=TIMEOUT_S)
                   .apply(fn, name=NAME),
                   device_provider=device_provider, timeout=timeout)
