"""Closed-loop inference: device time of host-to-device copies per batch in
the traced slice, ms."""

from benchmark import readers


def read(job):
    return readers.h2d_ms(job)
