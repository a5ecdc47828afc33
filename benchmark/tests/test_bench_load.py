"""The load: pools come from the seed; the closed loop keeps its records
outstanding and emits whole windows."""

import threading
import time

import numpy as np
import pytest

from benchmark import load


def test_closed_source_keeps_its_records_outstanding():
    feed = load.Feed()
    src = load.ClosedSource(lambda i: i, 4, feed, outstanding=8)
    got = []

    def consume():
        for value in src.run():
            got.append(value)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    time.sleep(0.3)
    assert len(got) == 8          # nothing came back: no ninth record
    feed.back(3)
    time.sleep(0.3)
    assert len(got) == 8          # less than a window back: still nothing
    feed.back(2)
    time.sleep(0.3)
    assert len(got) == 12         # a window back: one more window, whole
    feed.stop.set()
    feed.back(100)
    t.join(5)
    assert not t.is_alive() and len(got) % 4 == 0 and feed.emitted == len(got)


def test_pool_is_the_seeds():
    a = load.pool(2**33 + 1, 4, (5, 5, 3), salt=1)
    assert a.dtype == np.uint8 and a.shape == (4, 5, 5, 3) and not a.flags.writeable
    np.testing.assert_array_equal(a, load.pool(2**33 + 1, 4, (5, 5, 3), salt=1))
    assert (a != load.pool(2**33 + 2, 4, (5, 5, 3), salt=1)).any()


def test_closed_source_keeps_at_least_a_window_outstanding():
    with pytest.raises(ValueError):
        load.ClosedSource(lambda i: i, 8, load.Feed(), outstanding=4)
