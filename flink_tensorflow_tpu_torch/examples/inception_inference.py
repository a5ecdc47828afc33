"""Inception-v3 streaming image labeling — the flagship job.

Port of ``examples/inception_inference.py``: a bounded stream of images
through a count-or-timeout window into ``ModelWindowFunction``, each
fired window one bf16 forward of ``[B, 299, 299, 3]`` on the card.  With
``--bundle-dir`` the model is exported once and every operator replica
loads the bundle at open (the artifact deployment); with
``--output-dir`` the results also go through the two-phase-commit file
sink, committed on durable checkpoints.

Run:  python -m flink_tensorflow_tpu_torch.examples.inception_inference --records 512 --batch 32
      python -m flink_tensorflow_tpu_torch.examples.inception_inference --smoke --cpu
      python -m flink_tensorflow_tpu_torch.examples.inception_inference --bundle-dir /tmp/incep
"""

import os
import sys
import time

from flink_tensorflow_tpu_torch.examples._common import (
    base_parser,
    place,
    report,
    synthetic_images,
)


def parse(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--bundle-dir", default=None,
                   help="serve from a saved model bundle (exported on first run)")
    p.add_argument("--output-dir", default=None,
                   help="also write results through the exactly-once two-phase-commit "
                        "file sink (committed on durable checkpoints)")
    args = p.parse_args(argv)
    if args.smoke:
        args.records, args.batch = 16, 8
    return args


def model_def(args):
    from flink_tensorflow_tpu_torch.models import get_model_def

    return get_model_def("inception_v3", num_classes=10 if args.smoke else 1000)


def run(args, params, results=None):
    """The job over ``params`` (a module of ``model_def(args)`` or flax
    variables as numpy).  ``results``, when given, receives every output
    record.  Returns the report."""
    from flink_tensorflow_tpu_torch.core import StreamExecutionEnvironment
    from flink_tensorflow_tpu_torch.functions import ModelWindowFunction
    from flink_tensorflow_tpu_torch.models import SavedModelLoader, save_bundle
    from flink_tensorflow_tpu_torch.tensors import BucketPolicy

    mdef = model_def(args)
    if args.bundle_dir:
        if not os.path.isdir(args.bundle_dir):
            save_bundle(mdef, mdef.build_module(params), args.bundle_dir)
        else:
            print(f"serving EXISTING bundle {args.bundle_dir} as-is "
                  "(its architecture config wins over this run's flags)", file=sys.stderr)
        model = SavedModelLoader(args.bundle_dir)
    else:
        model = mdef.to_model(params)
    records = synthetic_images(args.records, 299)

    env = place(StreamExecutionEnvironment(parallelism=args.parallelism), args)
    if args.output_dir:
        env.enable_checkpointing(args.output_dir + ".chk", every_n_records=4 * args.batch)
    labeled = (
        env.from_collection(records, parallelism=1, schema=mdef.input_schema)
        .rebalance()
        .count_window(args.batch, timeout_s=0.05)
        .apply(ModelWindowFunction(model, policy=BucketPolicy(fixed_batch=args.batch),
                                   warmup_batches=(args.batch,)),
               name="inception", parallelism=args.parallelism)
    )
    out = labeled.sink_to_list()
    if args.output_dir:
        from flink_tensorflow_tpu_torch.io import ExactlyOnceRecordFileSink

        labeled.add_sink(ExactlyOnceRecordFileSink(args.output_dir),
                         name="committed_results", parallelism=args.parallelism)
    t0 = time.time()
    job = env.execute("inception-v3-labeling", timeout=3600)
    assert len(out) == args.records, (len(out), args.records)
    if results is not None:
        results.extend(out)
    extra = {"sample_labels": [int(r["label"]) for r in out[:5]]}
    if args.output_dir:
        from flink_tensorflow_tpu_torch.io import read_committed

        extra["committed_records"] = len(read_committed(args.output_dir))
    return report("inception_v3_streaming_inference", job.metrics, t0, args.records, extra)


def main(argv=None):
    args = parse(argv)
    return run(args, model_def(args).init_fn(0))


if __name__ == "__main__":
    main()
