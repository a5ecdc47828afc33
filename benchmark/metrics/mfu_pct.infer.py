"""Closed-loop inference: FLOPs per record at the traced slice's records/s
over the bf16 dense peak, %."""

from benchmark import readers


def read(job):
    return readers.mfu_pct(job, "stream")
