"""Training, of any kind: records of the steps whose loss reached the sink
in the window, per second."""

from benchmark import readers


def read(job):
    return readers.rate(job, "training")
