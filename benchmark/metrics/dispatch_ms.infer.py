"""Closed-loop inference: mean of the runner's dispatch_s (H2D enqueue and
kernel launches, host) over the profiled slice's batches, ms."""

from benchmark import readers


def read(job):
    return readers.counted_mean_ms(job, "stream", "dispatch_s")
