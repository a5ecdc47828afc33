"""Training: the least time of the forward and backward conv and matmul
work over the device kernel time, per record, %."""

from benchmark import readers


def read(job):
    return readers.roofline_pct(job, "train")
