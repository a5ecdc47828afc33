"""What the metric readers (``metrics/<name>.py``) share.

Each reader gets the finished job (``jobs.Job``) and returns a number,
or None where the job holds nothing for it to read, in which case the
harness leaves the metric out of the result line.  The end-to-end rates
go by the loop a job drives; the per-layer readers by its kind.
"""

from __future__ import annotations

import typing

import numpy as np

from benchmark.reference.count import PEAK_FLOPS


def rate(job, loop: str) -> typing.Optional[float]:
    """Records of a job that drives ``loop`` (``jobs.Job.loop``), whatever
    its kind, whose result reached the sink inside the window, over the
    window's seconds."""
    if job.loop != loop:
        return None
    return job.in_window(job.t0, job.t1) / job.seconds


def counted_mean_ms(job, kind: str, histogram: str) -> typing.Optional[float]:
    """The mean, in ms, of the values the program's histogram took
    between the job's counted marks (the profiled slice, in a traced run)."""
    values = job.counted_values(histogram) if job.kind == kind else []
    return float(np.mean(values)) * 1e3 if values else None


def traced_rate(job) -> typing.Optional[float]:
    s = job.slice
    return job.slice_records / s.window_s if s is not None and s.window_s > 0 else None


def roofline_pct(job, kind: str) -> typing.Optional[float]:
    """The least time of the slice's conv and matmul work (the
    reference's count) over the slice's device kernel time."""
    s = job.slice
    if job.kind != kind or s is None or s.kernel_s <= 0 or not job.slice_records:
        return None
    return 100.0 * job.count.least_s * job.slice_records / s.kernel_s


def mfu_pct(job, kind: str) -> typing.Optional[float]:
    """The count's FLOPs per record at the traced slice's records/s, over
    the card's bf16 dense peak."""
    r = traced_rate(job) if job.kind == kind else None
    if not r:
        return None
    return 100.0 * job.count.flops * r / PEAK_FLOPS


def idle_pct(job, kind: str) -> typing.Optional[float]:
    s = job.slice
    if job.kind != kind or s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def h2d_ms(job) -> typing.Optional[float]:
    """Device time of host-to-device copies per batch in the slice."""
    s = job.slice
    if job.kind != "stream" or s is None or not job.slice_records:
        return None
    return s.h2d_s / (job.slice_records / int(job.mix["window"])) * 1e3
