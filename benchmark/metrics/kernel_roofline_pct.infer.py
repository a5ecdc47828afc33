"""Closed-loop inference: the least time of the conv and matmul work over
the device kernel time, per record, %."""

from benchmark import readers


def read(job):
    return readers.roofline_pct(job, "stream")
