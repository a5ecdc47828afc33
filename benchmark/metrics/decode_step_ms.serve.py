"""Served requests: the runner's mean decode step over the traced slice
(the program's ``decode_step_s``: host clock around the step's launch and
its tokens' fetch), ms."""

from benchmark import readers


def read(job):
    return readers.counted_mean_ms(job, "serve", "decode_step_s")
