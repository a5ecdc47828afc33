"""Served requests: FLOPs per request (the kind's own count of the pool's
mean request) at the traced slice's requests/s, over the bf16 dense
peak, %."""

from benchmark import readers


def read(job):
    return readers.mfu_pct(job, "serve")
