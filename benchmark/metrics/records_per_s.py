"""Closed-loop inference, of any kind: records whose results reached the
sink in the window, per second (a served request is a record, counted
when its last token reached the sink)."""

from benchmark import readers


def read(job):
    return readers.rate(job, "inference")
