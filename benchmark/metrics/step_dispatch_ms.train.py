"""Training: mean of the train function's step_dispatch_s over the profiled
slice's steps, ms."""

from benchmark import readers


def read(job):
    return readers.counted_mean_ms(job, "train", "step_dispatch_s")
