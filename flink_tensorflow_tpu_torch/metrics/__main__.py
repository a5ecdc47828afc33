"""``python -m flink_tensorflow_tpu_torch.metrics <pipeline.py>`` — job inspector."""

import sys

from flink_tensorflow_tpu_torch.metrics.inspector import main

if __name__ == "__main__":
    sys.exit(main())
