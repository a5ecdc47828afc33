"""BiLSTM text-classification streaming inference with dynamic batching.

Port of ``examples/bilstm_stream.py``: token sequences of 4 to
``max_len`` tokens, a count-or-timeout window, and a batcher that buckets
both the batch size and the sequence length.

Run:  python -m flink_tensorflow_tpu_torch.examples.bilstm_stream --records 256 --batch 16
"""

import time

import numpy as np

from flink_tensorflow_tpu_torch.examples._common import base_parser, place, report
from flink_tensorflow_tpu_torch.tensors.value import TensorValue


def synthetic_texts(n, vocab, max_len, seed=0):
    rng = np.random.RandomState(seed)
    records = []
    for i in range(n):
        length = int(rng.randint(4, max_len + 1))
        records.append(TensorValue({"tokens": rng.randint(0, vocab, (length,)).astype(np.int32)},
                                   {"id": i, "length": length}))
    return records


def parse(argv=None):
    args = base_parser(__doc__).parse_args(argv)
    if args.smoke:
        args.records, args.batch = 24, 8
    return args


def sizes(args):
    """``(vocab, hidden, max_len)``."""
    return (1000, 64, 48) if args.smoke else (20000, 256, 192)


def model_def(args):
    from flink_tensorflow_tpu_torch.models import get_model_def

    vocab, hidden, _ = sizes(args)
    return get_model_def("bilstm", vocab_size=vocab, hidden_dim=hidden)


def run(args, params, results=None):
    """The job over ``params``; ``results`` receives every output record."""
    from flink_tensorflow_tpu_torch.core import StreamExecutionEnvironment
    from flink_tensorflow_tpu_torch.functions import ModelWindowFunction

    vocab, _, max_len = sizes(args)
    mdef = model_def(args)
    model = mdef.to_model(params)
    records = synthetic_texts(args.records, vocab, max_len)

    env = place(StreamExecutionEnvironment(parallelism=args.parallelism), args)
    out = (
        env.from_collection(records, parallelism=1, schema=mdef.input_schema)
        .rebalance()
        .count_window(args.batch, timeout_s=0.05)
        .apply(ModelWindowFunction(model), name="bilstm", parallelism=args.parallelism)
        .sink_to_list()
    )
    t0 = time.time()
    job = env.execute("bilstm-text-classification", timeout=600)
    assert len(out) == args.records
    if results is not None:
        results.extend(out)
    pos = sum(int(r["label"]) for r in out)
    return report("bilstm_streaming_inference", job.metrics, t0, args.records,
                  {"positive_fraction": round(pos / len(out), 3)})


def main(argv=None):
    args = parse(argv)
    return run(args, model_def(args).init_fn(0))


if __name__ == "__main__":
    main()
