"""The program's own device timing and the spans inside the train step and
the runner's batches, on the CPU.

- The tracer's clock anchor: ``Tracer.to_unix_ns``, the Chrome export's
  ``clock`` block, and ``utils/profiling.merge_tracer`` placing the spans
  on a profile's clock.
- ``tracing/device_clock.py`` on synthetic events: an event placed through
  the anchor, re-anchoring and a refused reading, the idle time before
  each interval of a stream, the host stage named for a runner batch and
  for a gang step, and the train spans tiling ``step_dispatch_s``.
- A traced gang on a tiny ResNet records every ``train.*`` span once per
  step with its histogram; a traced runner job records the ``h2d`` span's
  split, ``dispatch_cpu_s`` and one ``batch.emit`` span per batch.  (The
  device spans themselves need the card: tests/test_torch_tracing_cuda.py.)
"""

import time

import numpy as np
import pytest

from flink_tensorflow_tpu_torch import StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.functions import DPTrainWindowFunction, ModelWindowFunction
from flink_tensorflow_tpu_torch.models import lenet_cell
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.parallel import optim
from flink_tensorflow_tpu_torch.parallel.mesh import make_mesh
from flink_tensorflow_tpu_torch.tensors.batching import BucketPolicy
from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, spec
from flink_tensorflow_tpu_torch.tensors.value import TensorValue
from flink_tensorflow_tpu_torch.tracing import Tracer
from flink_tensorflow_tpu_torch.tracing import device_clock as dc
from flink_tensorflow_tpu_torch.tracing.tracer import ANCHOR_READINGS, clock_anchor, tightest
from flink_tensorflow_tpu_torch.utils.profiling import merge_tracer


class Event:
    """A completed event at ``ms`` on a synthetic device clock."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


class Reader:
    """Anchor readings handed out in turn: ``(device ms, host s, bracket s)``."""

    def __init__(self, *readings):
        self.readings = list(readings)
        self.calls = 0

    def __call__(self):
        self.calls += 1
        ms, t, bracket = self.readings.pop(0)
        return Event(ms), t, bracket


# -- the tracer's clock ---------------------------------------------------------------

def test_clock_anchor_reads_both_clocks_at_one_instant():
    a = time.monotonic()
    mono, unix_ns = clock_anchor()
    b = time.monotonic()
    assert a <= mono <= b
    assert abs(unix_ns / 1e9 - time.time()) < 0.5


def test_to_unix_ns_and_the_exports_clock_block():
    tracer = Tracer()
    tracer.clock = (100.0, 5_000_000_000_000)
    assert tracer.to_unix_ns(100.0) == 5_000_000_000_000
    assert tracer.to_unix_ns(100.25) == 5_000_250_000_000
    assert tracer.to_unix_ns(99.5) == 4_999_500_000_000
    t = tracer.epoch + 0.25
    tracer.span("op.0", "compute", t, t + 0.01)
    trace = tracer.chrome_trace()          # re-reads the anchor
    clock = trace["clock"]
    assert clock["epoch_monotonic_s"] == tracer.epoch
    assert clock["epoch_unix_ns"] == tracer.to_unix_ns(tracer.epoch)
    (span,) = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert clock["epoch_unix_ns"] + span["ts"] * 1e3 == pytest.approx(tracer.to_unix_ns(t), abs=1e3)


def test_merge_tracer_places_spans_on_the_profiles_clock():
    tracer = Tracer()
    t = time.monotonic()
    tracer.span("op.0", "compute", t, t + 0.002)
    tracer.span("op.0.device", "device", t + 0.0005, t + 0.0015)
    tracer.events()
    base = tracer.to_unix_ns(t) - 5_000_000     # the profile starts 5 ms before the span
    profile = {"baseTimeNanoseconds": base, "traceEvents": [
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": "k", "ts": 5600.0, "dur": 800.0},
        {"ph": "X", "cat": "cpu_op", "pid": 123, "tid": 123, "name": "aten::mm", "ts": 5100.0,
         "dur": 50.0}]}
    merged = merge_tracer(profile, tracer)
    assert merged["traceEvents"][:2] == profile["traceEvents"]
    mine = merged["traceEvents"][2:]
    assert {e["pid"] for e in mine} == {124}
    names = {e["args"]["name"] for e in mine if e["name"] == "thread_name"}
    assert names == {"op.0", "op.0.device"}
    spans = {e["name"]: e for e in mine if e["ph"] == "X"}
    assert spans["compute"]["ts"] == pytest.approx(5000.0, abs=1.0)
    assert spans["device"]["ts"] == pytest.approx(5500.0, abs=1.0)
    assert spans["compute"]["dur"] == pytest.approx(2000.0, abs=0.01)
    # The kernel lies inside the device span, as the card's would.
    k = profile["traceEvents"][0]
    assert spans["device"]["ts"] <= k["ts"] and k["ts"] + k["dur"] <= (
        spans["device"]["ts"] + spans["device"]["dur"])
    assert merged["clock"]["anchor_unix_ns"] == tracer.clock[1]


# -- the device clock -----------------------------------------------------------------

def test_tightest_keeps_the_reading_taken_in_the_least_time():
    readings = iter([("a", 3e-4), ("b", 1e-4), ("c", 2e-4)])
    assert tightest(lambda: next(readings), 3) == ("b", 1e-4)


def test_device_clock_keeps_the_tightest_anchor_and_places_events():
    read = Reader((100.0, 50.0, 4e-4), (90.0, 49.99, 1e-4), (95.0, 49.995, 2e-4),
                  *[(80.0, 49.98, 3e-4)] * (ANCHOR_READINGS - 3))
    clock = dc.DeviceClock(read)
    assert read.calls == ANCHOR_READINGS
    assert clock.to_host(Event(90.0)) == pytest.approx(49.99)
    assert clock.to_host(Event(1090.0)) == pytest.approx(50.99)
    assert clock.to_host(Event(89.5)) == pytest.approx(49.9895)


def test_device_clock_reanchors_once_a_second_and_refuses_a_wide_reading():
    n = ANCHOR_READINGS
    read = Reader(*[(0.0, 10.0, 1e-4)] * n)
    clock = dc.DeviceClock(read)
    clock.reanchor(now=10.5)                    # not due: no reading
    assert read.calls == n
    read.readings.append((1000.3, 11.0, 5e-3))  # due, but 5 ms wide: refused
    clock.reanchor(now=11.0)
    assert read.calls == n + 1
    assert clock.to_host(Event(1000.3)) == pytest.approx(11.0003)
    read.readings.append((1000.8, 11.0006, 2e-5))   # still due: read again, kept
    clock.reanchor(now=11.001)
    assert read.calls == n + 2
    assert clock.to_host(Event(1000.8)) == pytest.approx(11.0006)
    clock.reanchor(now=11.5)                    # due again only at 12.0006
    assert read.calls == n + 2


def test_the_idle_time_before_each_interval_of_a_stream():
    timeline = dc.StreamTimeline()

    def gap(a, b):
        return timeline.advance(Event(a), Event(b))[1]

    assert gap(0.0, 10.0) is None       # nothing before the first
    assert gap(12.0, 20.0) == pytest.approx(0.002)
    assert gap(19.0, 25.0) == 0.0       # overlaps: another lane's launches
    assert gap(24.0, 26.0) == 0.0
    assert gap(22.0, 23.0) == 0.0       # inside the end reached so far
    assert gap(30.0, 31.0) == pytest.approx(0.004)      # from 26, the latest end


def test_overlapping_intervals_add_their_union_not_their_sum():
    """Two lanes' batches on one stream: each interval adds only its time
    past the latest end, so the device time read is the union's (what the
    roofline plane takes as busy time)."""
    timeline = dc.StreamTimeline()
    intervals = [(0.0, 10.0), (4.0, 14.0), (12.0, 13.0), (20.0, 25.0), (22.0, 30.0)]
    added = [timeline.advance(Event(a), Event(b))[0] for a, b in intervals]
    assert added == pytest.approx([0.010, 0.004, 0.0, 0.005, 0.005])
    # The union: [0, 14] and [20, 30]; the sum would be 0.034.
    assert sum(added) == pytest.approx(0.024)


def test_a_lane_that_raced_ahead_extends_the_union_back():
    """The fetch thread reads batches in dispatch order, but the other
    lane may have taken its start event first: the interval read second
    then starts before the first.  Its time before that start counts,
    within the idle time before it."""
    timeline = dc.StreamTimeline()
    read = [(4.0, 16.0), (0.0, 10.0),       # raced ahead of the first run
            (25.0, 30.0), (22.0, 28.0),     # raced into the idle time before its run
            (18.0, 20.0)]                   # lies in that idle time on its own
    result = [timeline.advance(Event(a), Event(b)) for a, b in read]
    assert [r[1] for r in result] == pytest.approx([None, 0.0, 0.009, 0.0, 0.0])
    added = [r[0] for r in result]
    assert added == pytest.approx([0.012, 0.004, 0.005, 0.003, 0.002])
    # The union: [0, 16], [18, 20] and [22, 30].
    assert sum(added) == pytest.approx(0.026)


RUNNER_STAGES = ("lane_wait", "h2d", "launch")


@pytest.mark.parametrize("lo,hi,host,share", [
    (0.8, 1.7, "window", {"window": 0.2, "lane_wait": 0.5, "h2d": 0.2}),
    (1.2, 1.9, "lane_wait", {"lane_wait": 0.3, "h2d": 0.4}),
    (1.6, 1.9, "h2d", {"h2d": 0.3}),
    (2.1, 2.2, "launch", {"launch": 0.1}),
])
def test_a_runner_batch_names_its_stage_when_the_stream_went_idle(lo, hi, host, share):
    # Dispatched at 1.0, a lane took it at 1.5, its H2D was enqueued by
    # 2.0 and its launches by 2.4.
    spans = dc.tile(RUNNER_STAGES, (1.0, 1.5, 2.0, 2.4))
    got_host, got_share = dc.host_stages(lo, hi, spans)
    assert got_host == host
    assert got_share == pytest.approx(share)
    assert sum(got_share.values()) == pytest.approx(hi - lo)


GANG = [("train.assemble", 0.0, 1.0), ("train.ship", 1.0, 2.0), ("train.launch", 2.0, 3.0),
        ("train.drain", 3.0, 5.0), ("train.emit", 5.0, 5.2),
        ("train.assemble", 6.0, 7.0), ("train.ship", 7.0, 7.4)]


@pytest.mark.parametrize("lo,hi,host,share", [
    (4.9, 6.5, "train.drain", {"train.drain": 0.1, "train.emit": 0.2, "window": 0.8,
                               "train.assemble": 0.5}),
    (5.5, 6.0, "window", {"window": 0.5}),
    (6.5, 7.2, "train.assemble", {"train.assemble": 0.5, "train.ship": 0.2}),
    (2.5, 2.6, "train.launch", {"train.launch": 0.1}),
])
def test_a_gang_step_names_the_thread_span_when_the_stream_went_idle(lo, hi, host, share):
    got_host, got_share = dc.host_stages(lo, hi, GANG)
    assert got_host == host
    assert got_share == pytest.approx(share)


def test_the_train_spans_tile_step_dispatch():
    stamps = (10.0, 10.0125, 10.0311, 10.2344)
    spans = dc.tile(DPTrainWindowFunction.STEP_SPANS, stamps)
    assert [s[0] for s in spans] == ["train.assemble", "train.ship", "train.launch"]
    for (_, _, end), (_, start, _) in zip(spans, spans[1:]):
        assert end == start
    assert sum(b - a for _, a, b in spans) == pytest.approx(stamps[-1] - stamps[0], abs=1e-12)
    with pytest.raises(ValueError):
        dc.tile(("a", "b"), (0.0, 1.0))


def test_place_records_the_device_and_idle_spans():
    t = time.monotonic() + 100.0        # the anchor's host second: no re-anchor is due
    clock = dc.DeviceClock(Reader(*[(1000.0, t, 1e-5)] * ANCHOR_READINGS))
    tracer = Tracer()
    timeline = dc.StreamTimeline()
    spans = dc.tile(RUNNER_STAGES, (t - 0.010, t - 0.005, t + 0.004, t + 0.020))
    assert dc.place(clock, timeline, Event(1000.0), Event(1012.0), spans, tracer, "infer.0",
                    {"batch": 8}) == (pytest.approx(0.012), None)
    device_s, gap = dc.place(clock, timeline, Event(1015.0), Event(1030.0), spans, tracer,
                             "infer.0", {"batch": 8})
    assert (device_s, gap) == (pytest.approx(0.015), pytest.approx(0.003))
    # Back to back: no idle span, a gap of 0 all the same.
    assert dc.place(clock, timeline, Event(1030.0), Event(1031.0), spans, tracer, "infer.0",
                    {"batch": 8}) == (pytest.approx(0.001), 0.0)
    # Overlapping the last: its whole span is recorded, its device time
    # only past the end reached (1031).
    assert dc.place(clock, timeline, Event(1030.5), Event(1033.0), spans, tracer, "infer.0",
                    {"batch": 8}) == (pytest.approx(0.002), 0.0)
    events = tracer.events()
    assert {e[0] for e in events} == {"infer.0.device"}
    device = [e for e in events if e[1] == "device"]
    assert [e[3] - t for e in device] == pytest.approx([0.0, 0.015, 0.030, 0.0305])
    assert [e[4] for e in device] == pytest.approx([0.012, 0.015, 0.001, 0.0025])
    (idle,) = [e for e in events if e[1] == "device.idle"]
    assert idle[3] == pytest.approx(t + 0.012) and idle[4] == pytest.approx(0.003)
    assert idle[5]["host"] == "launch" and idle[5]["batch"] == 8
    assert idle[5]["stages"] == pytest.approx({"launch": 0.003})


# -- traced jobs on the CPU -----------------------------------------------------------

def _gang_job(steps=4, batch=8, trace=True):
    cfg = dict(num_classes=4, image_size=32, width=8, stage_sizes=(1, 1))
    rng = np.random.RandomState(0)
    recs = [TensorValue({"image": (rng.rand(32, 32, 3) * 0.2 + (i % 4) * 0.25).astype(np.float32),
                         "label": np.int32(i % 4)}) for i in range(steps * batch)]
    env = StreamExecutionEnvironment(parallelism=1).configure(trace=trace, flight_recorder=False)
    env.set_mesh(make_mesh({"data": 1}, devices=["cpu"]))
    schema = RecordSchema({"image": spec((32, 32, 3)), "label": spec((), np.int32)})
    out = (env.from_collection(recs).count_window(batch)
           .apply(DPTrainWindowFunction(get_model_def("resnet50", **cfg), optim.adam(1e-2),
                                        train_schema=schema, global_batch=batch),
                  name="dp_train")
           .sink_to_list())
    return env, out


def test_a_traced_gang_records_every_train_span_once_per_step():
    env, out = _gang_job(steps=4)
    handle = env.execute_async("gang")
    handle.wait(300)
    assert len(out) == 4
    events = [e for e in handle.executor.tracer.events() if e[0] == "dp_train.0"]
    counts = {}
    for e in events:
        counts[e[1]] = counts.get(e[1], 0) + 1
    for name in ("train.assemble", "train.ship", "train.launch", "train.drain", "train.emit"):
        assert counts.get(name) == 4, (name, counts)
    assert sorted(e[5]["step"] for e in events if e[1] == "train.drain") == [1, 2, 3, 4]
    # No card: no device spans.
    assert not [e for e in handle.executor.tracer.events() if e[0].endswith(".device")]
    grp = env.metric_registry.group("dp_train.0")
    parts = [grp.histogram(h).values for h in DPTrainWindowFunction.STEP_HISTOGRAMS]
    dispatch = grp.histogram("step_dispatch_s").values
    assert len(dispatch) == 4 and all(len(p) == 4 for p in parts)
    for i, total in enumerate(dispatch):
        assert sum(p[i] for p in parts) == pytest.approx(total, abs=1e-9)
    assert grp.histogram("loss_wait_s").count == 4
    assert grp.histogram("step_gap_s").count == 0


@pytest.mark.parametrize("use_ring", [None, False])
def test_a_traced_runner_job_splits_h2d_and_times_the_emit(use_ring):
    _, model, _, records = lenet_cell.lenet_cell(0, records=64)
    env = StreamExecutionEnvironment(parallelism=1).configure(trace=True, flight_recorder=False)
    env.set_device_provider(lambda task, index: "cpu")
    out = (env.from_collection(records).count_window(16)
           .apply(ModelWindowFunction(model, policy=BucketPolicy(fixed_batch=16),
                                      outputs=("label",), use_ring=use_ring), name="infer")
           .sink_to_list())
    handle = env.execute_async("infer")
    handle.wait(120)
    assert len(out) == 64
    events = [e for e in handle.executor.tracer.events() if e[0] == "infer.0"]
    h2d = [e for e in events if e[1] == "h2d"]
    assert len(h2d) == 4
    for e in h2d:
        args = e[5]
        assert args["h2d_s"] >= 0 and args["launch_s"] >= 0 and args["cpu_s"] >= 0
        assert args["h2d_s"] + args["launch_s"] == pytest.approx(e[4], abs=2e-6)
    emits = [e for e in events if e[1] == "batch.emit"]
    assert [e[5]["records"] for e in emits] == [16] * 4
    grp = env.metric_registry.group("infer.0")
    assert grp.histogram("dispatch_cpu_s").count == 4
    assert grp.histogram("emit_s").count == 4
    assert grp.histogram("emit_s").values == pytest.approx([e[4] for e in emits])
    assert grp.histogram("device_gap_s").count == 0     # no card
