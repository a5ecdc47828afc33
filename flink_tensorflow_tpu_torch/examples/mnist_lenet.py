"""MNIST LeNet windowed micro-batch inference.

Port of ``examples/mnist_lenet.py``: a count-or-timeout window collects
B digit images and each fired window runs one batched forward.

Run:  python -m flink_tensorflow_tpu_torch.examples.mnist_lenet --records 512 --batch 64
"""

import time

from flink_tensorflow_tpu_torch.examples._common import (
    base_parser,
    place,
    report,
    synthetic_images,
)


def parse(argv=None):
    args = base_parser(__doc__).parse_args(argv)
    if args.smoke:
        args.records, args.batch = 32, 8
    return args


def model_def(args):
    from flink_tensorflow_tpu_torch.models import get_model_def

    return get_model_def("lenet")


def run(args, params, results=None):
    """The job over ``params``; ``results`` receives every output record."""
    from flink_tensorflow_tpu_torch.core import StreamExecutionEnvironment
    from flink_tensorflow_tpu_torch.functions import ModelWindowFunction

    mdef = model_def(args)
    model = mdef.to_model(params)
    records = synthetic_images(args.records, 28, channels=1)

    env = place(StreamExecutionEnvironment(parallelism=args.parallelism), args)
    out = (
        env.from_collection(records, parallelism=1, schema=mdef.input_schema)
        .rebalance()
        .count_window(args.batch, timeout_s=0.02)
        .apply(ModelWindowFunction(model), name="lenet", parallelism=args.parallelism)
        .sink_to_list()
    )
    t0 = time.time()
    job = env.execute("mnist-lenet-microbatch", timeout=600)
    assert len(out) == args.records
    if results is not None:
        results.extend(out)
    hist = {}
    for r in out:
        hist[int(r["label"])] = hist.get(int(r["label"]), 0) + 1
    return report("mnist_lenet_microbatch", job.metrics, t0, args.records,
                  {"label_histogram": hist})


def main(argv=None):
    args = parse(argv)
    return run(args, model_def(args).init_fn(0))


if __name__ == "__main__":
    main()
