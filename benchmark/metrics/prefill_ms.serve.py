"""Served requests: the runner's mean prefill over the traced slice (the
program's ``prefill_s``: one padded batch of admitted prompts, launch to
first tokens fetched), ms."""

from benchmark import readers


def read(job):
    return readers.counted_mean_ms(job, "serve", "prefill_s")
