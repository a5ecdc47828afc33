"""Split-based source pipeline: skewed files, readers that pull splits,
and a timer-driven window fused into the source chain.

Port of ``examples/split_source_pipeline.py``:

- a skewed ``FileSplitSource`` (one big file and a tail of small ones)
  at parallelism 4: readers pull splits, so the fast ones take the tail
  while one reads the big file;
- a second stage whose count-or-timeout window chains into a
  single-reader split source (its mailbox wait is wakeable), so that
  path has no queue between operators.

No model runs here: ``--cpu`` is accepted and changes nothing.

Run:  python -m flink_tensorflow_tpu_torch.examples.split_source_pipeline --records 512
"""

import os
import tempfile
import time

import numpy as np

from flink_tensorflow_tpu_torch.core import functions as fn
from flink_tensorflow_tpu_torch.examples._common import base_parser, report
from flink_tensorflow_tpu_torch.tensors.value import TensorValue


class SumWindow(fn.WindowFunction):
    def process_window(self, key, window, elements, out):
        out.collect(sum(elements))


def parse(argv=None):
    args = base_parser(__doc__).parse_args(argv)
    if args.smoke:
        args.records, args.batch = 64, 8
    return args


def write_skewed_files(n: int, directory: str):
    """Eight record files holding ``n`` records: halves, quarters, an
    eighth, then five equal small ones (the last takes the remainder)."""
    from flink_tensorflow_tpu_torch.io.files import write_record_file

    shares = [n // 2, n // 4, n // 8] + [0] * 5
    shares[3:] = [(n - sum(shares[:3])) // 5] * 5
    shares[-1] += n - sum(shares)
    paths, idx = [], 0
    for f, size in enumerate(shares):
        path = os.path.join(directory, f"part-{f}.rec")
        write_record_file(path, [TensorValue({"x": np.float32(idx + i)}, {"id": idx + i})
                                 for i in range(size)])
        idx += size
        paths.append(path)
    return paths


def run(args):
    from flink_tensorflow_tpu_torch.analysis.chaining import compute_chains
    from flink_tensorflow_tpu_torch.core import StreamExecutionEnvironment
    from flink_tensorflow_tpu_torch.sources import FileSplitSource, ReplaySplitSource

    paths = write_skewed_files(args.records, tempfile.mkdtemp(prefix="split_example_"))
    t0 = time.time()
    env = StreamExecutionEnvironment(parallelism=1)
    env.source_throttle_s = 0.0005  # keeps the four readers overlapped
    collected = (
        env.from_source(FileSplitSource(paths), name="files", parallelism=4)
        .rebalance()
        .map(lambda r: float(r.fields["x"]), name="unwrap", parallelism=4)
        .sink_to_list()
    )
    env.execute("split-files", timeout=600)
    rep = env.metric_registry.report()
    splits_per_subtask = {i: rep[f"files.{i}.splits_completed"] for i in range(4)}

    env2 = StreamExecutionEnvironment(parallelism=1)
    sums = (
        env2.from_source(ReplaySplitSource(sorted(collected), num_splits=4),
                         name="replay", parallelism=1)
        .count_window(args.batch, timeout_s=0.05)
        .apply(SumWindow(), name="window", parallelism=1)
        .sink_to_list()
    )
    chains = compute_chains(env2.graph).names()
    env2.execute("split-window-chain", timeout=600)

    return report("split_source_pipeline", env2.metric_registry.report(), t0,
                  len(collected), extra={
                      "records": len(collected),
                      "splits_per_subtask": splits_per_subtask,
                      "every_subtask_got_work": all(v >= 1 for v in splits_per_subtask.values()),
                      "window_chain": chains[0],
                      "window_sum": sum(sums),
                  })


def main(argv=None):
    return run(parse(argv))


if __name__ == "__main__":
    main()
