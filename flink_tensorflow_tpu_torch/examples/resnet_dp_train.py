"""ResNet-50 data-parallel training through the gang operator.

Port of ``examples/resnet_dp_train.py``: every fired window is one train
step of ``DPTrainWindowFunction`` over a ``{data: N}`` mesh.  The port
runs one device per process, so this one-process job trains on a mesh of
one device (its card, or the host under ``--cpu``); a mesh over several
cards is a cohort of processes (``multihost_dp_train``).

Run:  python -m flink_tensorflow_tpu_torch.examples.resnet_dp_train --records 512 --batch 64
      python -m flink_tensorflow_tpu_torch.examples.resnet_dp_train --smoke --cpu
"""

import sys
import time

import numpy as np

from flink_tensorflow_tpu_torch.examples._common import base_parser, report
from flink_tensorflow_tpu_torch.tensors.value import TensorValue


def parse(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--image-size", type=int, default=None)
    args = p.parse_args(argv)
    if args.smoke:
        args.records, args.batch = 64, 16
    return args


def sizes(args):
    """``(image_size, classes)``."""
    return args.image_size or (32 if args.smoke else 224), 10 if args.smoke else 1000


def model_def(args):
    from flink_tensorflow_tpu_torch.models import get_model_def

    size, classes = sizes(args)
    if args.smoke:
        return get_model_def("resnet50", num_classes=classes, image_size=size, width=8,
                             stage_sizes=(1, 1))
    return get_model_def("resnet50", num_classes=classes, image_size=size)


def training_records(args):
    size, classes = sizes(args)
    rng = np.random.RandomState(0)
    records = []
    for i in range(args.records):
        label = i % classes
        img = rng.rand(size, size, 3) * 0.3 + (label / classes) * 0.7
        records.append(TensorValue({"image": img.astype(np.float32), "label": np.int32(label)}))
    return records


def run(args, mdef, out=None):
    """The job training ``mdef`` (its ``init_fn`` gives the initial
    weights).  ``out`` receives every per-step metrics record."""
    from flink_tensorflow_tpu_torch.core import StreamExecutionEnvironment
    from flink_tensorflow_tpu_torch.functions import DPTrainWindowFunction
    from flink_tensorflow_tpu_torch.parallel import make_mesh, optim
    from flink_tensorflow_tpu_torch.tensors import RecordSchema, spec

    size, _ = sizes(args)
    mesh = make_mesh({"data": 1}, devices=["cpu"] if args.cpu else None)
    schema = RecordSchema({"image": spec((size, size, 3)), "label": spec((), np.int32)})
    if args.parallelism != 1:
        print("note: --parallelism is ignored here: the gang operator runs at stream "
              "parallelism 1 on the mesh's device", file=sys.stderr)
    env = StreamExecutionEnvironment(parallelism=1)
    env.set_mesh(mesh)
    steps = (
        env.from_collection(training_records(args), parallelism=1, schema=schema)
        .count_window(args.batch)
        .apply(DPTrainWindowFunction(mdef, optim.adam(1e-3), train_schema=schema,
                                     global_batch=args.batch),
               name="dp_train")
        .sink_to_list()
    )
    t0 = time.time()
    job = env.execute("resnet50-dp-training", timeout=3600)
    if out is not None:
        out.extend(steps)
    losses = [float(r["loss"]) for r in steps]
    return report("resnet50_dp_training", job.metrics, t0, args.records, {
        "devices": mesh.size,
        "steps": len(losses),
        "loss_first": round(losses[0], 4) if losses else None,
        "loss_last": round(losses[-1], 4) if losses else None,
    })


def main(argv=None):
    args = parse(argv)
    return run(args, model_def(args))


if __name__ == "__main__":
    main()
