"""Wide&Deep online training on a keyed stream.

Port of ``examples/widedeep_online.py``: click events keyed by user, the
model takes an adam step per mini-batch as events arrive.  Params and
optimizer state are operator state, so checkpoint barriers snapshot
them; 8 steps are fused into one dispatch.

Run:  python -m flink_tensorflow_tpu_torch.examples.widedeep_online --records 512 --batch 8
"""

import time

import numpy as np

from flink_tensorflow_tpu_torch.examples._common import base_parser, place, report
from flink_tensorflow_tpu_torch.tensors.value import TensorValue

CONFIG = dict(hash_buckets=1000, embed_dim=8, num_cat_slots=4, num_dense=8, num_wide=16,
              hidden=(32, 16))


def synthetic_events(n, num_wide, num_dense, slots, buckets, users=16, seed=0):
    rng = np.random.RandomState(seed)
    records = []
    for _ in range(n):
        user = int(rng.randint(users))
        # Click probability follows one wide feature per user cohort, so
        # the model has something to learn online.
        x_wide = rng.rand(num_wide).astype(np.float32)
        label = np.int32(x_wide[user % num_wide] > 0.5)
        records.append(TensorValue({
            "wide": x_wide,
            "dense": rng.rand(num_dense).astype(np.float32),
            "cat": rng.randint(0, buckets, (slots,)).astype(np.int32),
            "label": label,
        }, meta={"user": user}))
    return records


def parse(argv=None):
    args = base_parser(__doc__).parse_args(argv)
    if args.smoke:
        args.records, args.batch = 64, 4
    return args


def model_def(args):
    from flink_tensorflow_tpu_torch.models import get_model_def

    return get_model_def("widedeep", **CONFIG)


def run(args, mdef, out=None):
    """The job training ``mdef`` (its ``init_fn`` gives the initial
    weights).  ``out`` receives every per-step metrics record."""
    from flink_tensorflow_tpu_torch.core import StreamExecutionEnvironment
    from flink_tensorflow_tpu_torch.functions import OnlineTrainFunction
    from flink_tensorflow_tpu_torch.parallel import optim
    from flink_tensorflow_tpu_torch.tensors import RecordSchema, spec

    cfg = CONFIG
    schema = RecordSchema({
        "wide": spec((cfg["num_wide"],)),
        "dense": spec((cfg["num_dense"],)),
        "cat": spec((cfg["num_cat_slots"],), np.int32),
        "label": spec((), np.int32),
    })
    records = synthetic_events(args.records, cfg["num_wide"], cfg["num_dense"],
                               cfg["num_cat_slots"], cfg["hash_buckets"])

    env = place(StreamExecutionEnvironment(parallelism=args.parallelism), args)
    steps = (
        env.from_collection(records, parallelism=1, schema=schema)
        .key_by(lambda r: r.meta["user"])
        .process(OnlineTrainFunction(mdef, optim.adam(1e-2), train_schema=schema,
                                     scope="subtask", seed=0, mini_batch=args.batch,
                                     steps_per_dispatch=8),
                 name="online_train", parallelism=args.parallelism)
        .sink_to_list()
    )
    t0 = time.time()
    job = env.execute("widedeep-online-training", timeout=600)
    if out is not None:
        out.extend(steps)
    losses = [float(r["loss"]) for r in steps]
    k = max(1, len(losses) // 5)
    return report("widedeep_online_training", job.metrics, t0, args.records, {
        "steps": len(losses),
        "loss_first": round(float(np.mean(losses[:k])), 4),
        "loss_last": round(float(np.mean(losses[-k:])), 4),
    })


def main(argv=None):
    args = parse(argv)
    return run(args, model_def(args))


if __name__ == "__main__":
    main()
