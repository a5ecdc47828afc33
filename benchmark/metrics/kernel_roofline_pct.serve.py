"""Served requests: the least time of the mean request's matmul work (the
kind's count, its decode steps' weights shared by the step's rows) times
the slice's requests, over the slice's device kernel time, %."""

from benchmark import readers


def read(job):
    return readers.roofline_pct(job, "serve")
