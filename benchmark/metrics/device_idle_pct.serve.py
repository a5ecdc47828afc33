"""Served requests: the share of the traced slice in which the card ran
nothing, %."""

from benchmark import readers


def read(job):
    return readers.idle_pct(job, "serve")
