"""Closed-loop inference: mean of the window function's emit_s (the
subtask thread's time from a batch's first result leaving the runner to
its last handed downstream) over the profiled slice's batches, ms."""

from benchmark import readers


def read(job):
    return readers.counted_mean_ms(job, "stream", "emit_s")
