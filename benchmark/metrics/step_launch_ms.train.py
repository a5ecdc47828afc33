"""Training: mean of the train function's step_launch_s (the host's
launches of a step's forward, backward and optimizer) over the profiled
slice's steps, ms."""

from benchmark import readers


def read(job):
    return readers.counted_mean_ms(job, "train", "step_launch_s")
