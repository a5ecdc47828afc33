"""Closed-loop inference: mean of the runner's device_gap_s (the compute
stream's idle time before each batch's first device work, from the
program's own CUDA events) over the profiled slice's batches, ms."""

from benchmark import readers


def read(job):
    return readers.counted_mean_ms(job, "stream", "device_gap_s")
