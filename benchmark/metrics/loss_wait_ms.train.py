"""Training: mean of the train function's loss_wait_s (the host's wait
for the oldest step's metrics when it drains them) over the profiled
slice's steps, ms."""

from benchmark import readers


def read(job):
    return readers.counted_mean_ms(job, "train", "loss_wait_s")
