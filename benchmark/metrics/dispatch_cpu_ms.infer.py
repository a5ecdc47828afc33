"""Closed-loop inference: mean of the runner's dispatch_cpu_s (the lane's
CPU seconds over its dispatch_s interval, time.thread_time) over the
profiled slice's batches, ms.  Against dispatch_ms.infer, the rest is time
the lane was runnable but waiting (the interpreter lock, the ring)."""

from benchmark import readers


def read(job):
    return readers.counted_mean_ms(job, "stream", "dispatch_cpu_s")
