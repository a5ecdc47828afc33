"""Closed-loop inference: records whose results reached the sink in the
window, per second."""

from benchmark import readers


def read(job):
    return readers.rate(job, "stream")
