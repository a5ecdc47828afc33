"""Training: mean of the train function's step_gap_s (the step stream's
idle time before each step's first device work, from the program's own
CUDA events) over the profiled slice's steps, ms."""

from benchmark import readers


def read(job):
    return readers.counted_mean_ms(job, "train", "step_gap_s")
