"""Closed-loop inference: share of the traced slice in which no kernel or
copy ran on the card, %."""

from benchmark import readers


def read(job):
    return readers.idle_pct(job, "stream")
