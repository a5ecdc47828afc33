"""The window's arithmetic: rates over all the window's work, the
check's sample over all of it, device shares from the trace's
intervals."""

import types

import numpy as np
import pytest

from benchmark import readers, trace
from benchmark.kinds.stream import Reservoir


def _closed(times, t0=10.0, t1=20.0):
    job = types.SimpleNamespace(kind="stream", loop="inference", t0=t0, t1=t1, seconds=t1 - t0)
    job.in_window = lambda a, b: int(((np.asarray(times) >= a) & (np.asarray(times) < b)).sum())
    return job


def test_a_stall_inside_the_window_lowers_the_rate():
    steady = np.arange(0.0, 30.0, 0.001)                    # 1,000 records/s
    stalled = steady[(steady < 14.0) | (steady >= 16.0)]    # 2 s of nothing
    assert readers.rate(_closed(steady), "inference") == pytest.approx(1000.0, rel=1e-3)
    assert readers.rate(_closed(stalled), "inference") == pytest.approx(800.0, rel=1e-3)
    assert readers.rate(_closed(steady), "training") is None


def test_the_reservoir_samples_the_whole_window_evenly_and_from_the_seed():
    def sample(seed, n=20_000, size=256):
        r = Reservoir(size, seed)
        for i in range(n):
            r.offer(lambda: i)
        return sorted(r.items)

    a = sample(2**31 + 5)
    assert a == sample(2**31 + 5) and a != sample(2**31 + 6)
    assert len(a) == len(set(a)) == 256
    # Uniform over the stream: as many from each fifth of it, within noise.
    counts = np.bincount(np.array(a) // 4000, minlength=5)
    assert counts.min() > 25 and counts.max() < 80
    assert sample(1, n=100) == list(range(100))     # fewer than the sample: all


def test_device_shares_from_intervals():
    dev = [(0.0, 100.0, "conv"), (50.0, 150.0, "Memcpy HtoD (Pinned -> Device)"),
           (400.0, 500.0, "conv"), (700.0, 800.0, "relu"),
           (950.0, 1200.0, "conv"), (-300.0, -100.0, "conv")]    # cut / outside the slice
    host = [(150.0, 400.0, "cudaStreamSynchronize"), (160.0, 200.0, "cudaLaunchKernel")]
    s = trace.summarize(dev, host, 0.0, 1000.0)
    assert s.window_s == pytest.approx(1e-3)
    assert s.busy_s == pytest.approx(400e-6) and s.kernel_s == pytest.approx(350e-6)
    assert s.h2d_s == pytest.approx(100e-6)
    assert s.device_ops[0] == ("conv", pytest.approx(250e-6))
    # The longest gap (150-400 us) is the synchronize's (innermost at its middle).
    assert s.idle_gaps[0][0].startswith("cudaStreamSynchronize, after Memcpy HtoD")
    assert s.idle_gaps[0][1] == pytest.approx(250e-6)
    assert s.idle_gaps[1] == ("host in Python, after conv", pytest.approx(200e-6))
    assert len(s.idle_gaps) == 3    # between device ops only
    job = types.SimpleNamespace(kind="stream", slice=s, slice_records=4,
                                mix={"window": 2}, count=types.SimpleNamespace(
                                    least_s=10e-6, flops=1e9))
    assert readers.idle_pct(job, "stream") == pytest.approx(60.0)
    assert readers.roofline_pct(job, "stream") == pytest.approx(100 * 40e-6 / 350e-6)
    assert readers.h2d_ms(job) == pytest.approx(0.05)
    assert readers.mfu_pct(job, "stream") == pytest.approx(100 * 1e9 * 4000 / 989e12)
