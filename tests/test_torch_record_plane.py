"""The port's record plane on one host (``tensors/serde.py`` batch frames,
``native/ring.py:ShmByteRing``, ``core/reactor.py``, ``core/shuffle.py``),
held to the JAX package's where both run the same inputs.

Twins of ``tests/test_record_plane.py`` and the epoch fence of
``tests/test_faults.py:373-440``: coalescing order under barriers, flush
reasons, the timeout re-arm, per-record mode, the columnar fallback,
peer death mid-frame, a clean EOF without end-of-partition, a full gate
pausing without loss, the shm edge, credit flow control and the stale
epoch.  Every server binds port 0 and reads its port back.
"""

import glob
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from flink_tensorflow_tpu_torch.core import elements as el
from flink_tensorflow_tpu_torch.core.channels import InputGate
from flink_tensorflow_tpu_torch.core.reactor import Reactor
from flink_tensorflow_tpu_torch.core.shuffle import (
    CREDIT_GRANT,
    ColumnarFrame,
    RemoteChannelWriter,
    ShuffleServer,
    _send_obj,
    credit_window,
    encode_obj_frame,
    expand_message,
)
from flink_tensorflow_tpu_torch.metrics.registry import MetricRegistry
from flink_tensorflow_tpu_torch.native.ring import ShmByteRing, shm_dir
from flink_tensorflow_tpu_torch.tensors import serde
from flink_tensorflow_tpu_torch.tensors.value import TensorValue


def _tv(i, n=16):
    return TensorValue({"x": np.full(n, i, np.float32)}, {"i": i})


def _server(gate, metrics=None, **kw):
    server = ShuffleServer("127.0.0.1", metrics=metrics, **kw)
    server.register_gate("op", 0, gate)
    server.start()
    return server


def _writer(port, metrics=None, **kw):
    return RemoteChannelWriter("127.0.0.1", port, "op", 0, 0, connect_timeout_s=10.0,
                               metrics=metrics, **kw)


def _drain(gate, n, timeout=15.0):
    out = []
    deadline = time.monotonic() + timeout
    while len(out) < n and time.monotonic() < deadline:
        item = gate.poll(timeout=0.5)
        if item is not None:
            out.append(item[1])
    return out


def _await_metric(reg, key, want, timeout=5.0):
    """Sender counters tick after the send; the receiver may deliver first."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if reg.report().get(key) == want:
            break
        time.sleep(0.01)
    return reg.report()


def _await_errors(errors, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not errors and time.monotonic() < deadline:
        time.sleep(0.02)
    return errors


@pytest.fixture(autouse=True)
def no_ring_files_left():
    """Every test removes the ring files it made in /dev/shm."""
    pattern = os.path.join(shm_dir(), f"ftt-*{os.getpid()}*")
    before = set(glob.glob(pattern))
    yield
    deadline = time.monotonic() + 5.0
    while set(glob.glob(pattern)) - before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not set(glob.glob(pattern)) - before


# -- batch frames, against the JAX codec -----------------------------------------------

def _raw_records(n=6):
    rng = np.random.RandomState(3)
    out = []
    for i in range(n):
        fields = {"x": (rng.randn(3, 4) * (i + 1)).astype(np.float32),
                  "ids": rng.randint(0, 1000, (5,)).astype(np.int64),
                  "s": np.float32(i * 0.5), "h": rng.randn(2).astype(np.float16)}
        out.append((fields, {"i": i, "tag": ("a", i)}))
    return out


@pytest.mark.parametrize("wire", [None, "f32", "bf16", "f16", "int8"])
def test_batch_frames_are_byte_equal_to_jax(wire):
    from flink_tensorflow_tpu.tensors import serde as jserde
    from flink_tensorflow_tpu.tensors.value import TensorValue as JaxTensorValue

    raw = _raw_records()
    got = serde.encode_batch([TensorValue(f, m) for f, m in raw], wire)
    want = jserde.encode_batch([JaxTensorValue(f, m) for f, m in raw], wire)
    assert bytes(got) == bytes(want)


@pytest.mark.parametrize("wire", [None, "bf16", "int8"])
def test_coalesced_frames_with_timestamps_equal_jax(wire):
    """A writer's coalesced run with timestamps: the same columnar payload
    bytes and the same timestamps as the JAX writer's."""
    from flink_tensorflow_tpu.core import elements as jel
    from flink_tensorflow_tpu.core.shuffle import RemoteChannelWriter as JaxWriter
    from flink_tensorflow_tpu.tensors.value import TensorValue as JaxTensorValue

    raw = _raw_records()
    mine = RemoteChannelWriter("127.0.0.1", 1, "op", 0, 0, wire_dtype=wire)._coalesce(
        [el.StreamRecord(TensorValue(f, m), 0.25 * i) for i, (f, m) in enumerate(raw)])
    theirs = JaxWriter("127.0.0.1", 1, "op", 0, 0, wire_dtype=wire)._coalesce(
        [jel.StreamRecord(JaxTensorValue(f, m), 0.25 * i) for i, (f, m) in enumerate(raw)])
    assert mine.payload.tobytes() == theirs.payload.tobytes()
    assert mine.timestamps == theirs.timestamps == [0.25 * i for i in range(len(raw))]


@pytest.mark.parametrize("wire", [None, "bf16", "f16", "int8"])
def test_each_package_decodes_the_others_batch_frames(wire):
    from flink_tensorflow_tpu.tensors import serde as jserde
    from flink_tensorflow_tpu.tensors.value import TensorValue as JaxTensorValue

    raw = _raw_records()
    port_frame = serde.encode_batch([TensorValue(f, m) for f, m in raw], wire)
    jax_frame = jserde.encode_batch([JaxTensorValue(f, m) for f, m in raw], wire)
    for mine, theirs in ((serde.decode_frame(jax_frame), jserde.decode_frame(jax_frame)),
                         (serde.decode_frame(port_frame), jserde.decode_frame(port_frame))):
        assert len(mine) == len(theirs) == len(raw)
        for a, b in zip(mine, theirs):
            assert a.meta == b.meta
            for name in b.fields:
                assert a[name].dtype == b[name].dtype and a[name].shape == b[name].shape
                np.testing.assert_array_equal(a[name], b[name])
    # A record frame decodes through the same entry point.
    one = serde.encode_record(TensorValue(raw[0][0], raw[0][1]))
    assert serde.decode_frame(one)[0].meta == raw[0][1]


def test_narrowed_batch_is_within_the_record_codecs_bound():
    raw = _raw_records()
    values = [TensorValue(f, m) for f, m in raw]
    for wire, rtol in (("bf16", 2 ** -8), ("f16", 2 ** -10)):
        for got, want in zip(serde.decode_batch(serde.encode_batch(values, wire)), values):
            np.testing.assert_allclose(got["x"], want["x"], rtol=rtol)
            np.testing.assert_array_equal(got["ids"], want["ids"])
    for got, want in zip(serde.decode_batch(serde.encode_batch(values, "int8")), values):
        # One absmax scale per record: error <= absmax / 254.
        bound = np.abs(want["x"]).max() / 254 + 1e-6
        assert np.abs(got["x"] - want["x"]).max() <= bound


def test_batch_signature_and_object_fields():
    assert serde.batch_signature(7) is None
    assert serde.batch_signature(_tv(0)) == serde.batch_signature(_tv(1))
    assert serde.batch_signature(_tv(0)) != serde.batch_signature(_tv(0, n=8))
    obj = TensorValue({"o": np.array([object()], dtype=object)})
    assert serde.batch_signature(obj) is None
    with pytest.raises(TypeError, match="object dtype"):
        serde.encode_batch([obj])


def test_credit_window_equals_jax():
    from flink_tensorflow_tpu.core.shuffle import credit_window as jax_window

    for capacity in (1, 4, 31, 32, 64, 100, 512, 1024, 1025, 4096, 100_000):
        assert credit_window(capacity) == jax_window(capacity)


# -- the shm byte ring ----------------------------------------------------------------

def _ring_path(tag):
    return os.path.join(shm_dir(), f"ftt-test-ring-{os.getpid()}-{tag}")


def test_ring_wraparound_parity():
    path = _ring_path("a")
    prod = ShmByteRing.create(path, 1 << 12)
    cons = ShmByteRing.attach(path)
    try:
        rng = np.random.RandomState(3)
        frames = [bytes(rng.randint(0, 256, rng.randint(1, 900), dtype=np.uint8))
                  for _ in range(300)]
        got, pending, it = [], None, iter(frames)
        while len(got) < len(frames):
            if pending is None:
                pending = next(it, None)
            if pending is not None and prod.try_write(pending):
                pending = None
            frame = cons.read()
            if frame is not None:
                got.append(bytes(frame))
        assert got == frames
    finally:
        cons.close(unlink=True)
        prod.close()
    assert not os.path.exists(path)


def test_ring_oversized_frame_rejected():
    ring = ShmByteRing.create(_ring_path("b"), 1 << 10)
    try:
        with pytest.raises(ValueError, match="exceeds"):
            ring.try_write(b"x" * (1 << 11))
    finally:
        ring.close(unlink=True)


def test_full_ring_reports_false():
    ring = ShmByteRing.create(_ring_path("c"), 1 << 10)
    try:
        writes = 0
        while ring.try_write(b"y" * 100):
            writes += 1
        assert 0 < writes <= (1 << 10) // 104 + 1
        ring.read()
        assert ring.try_write(b"y" * 100)
    finally:
        ring.close(unlink=True)


@pytest.mark.parametrize("producer", ["port", "jax"])
def test_ring_attaches_to_the_jax_rings_file(producer):
    """A ring of one package attaches to the other's file: frames, the
    doorbell flag and the credit cell cross both ways."""
    from flink_tensorflow_tpu.native.ring import ShmByteRing as JaxRing

    make, attach = (ShmByteRing, JaxRing) if producer == "port" else (JaxRing, ShmByteRing)
    path = _ring_path(f"x{producer}")
    prod = make.create(path, 1 << 11)
    cons = attach.attach(path)
    try:
        assert cons.capacity == prod.capacity == 1 << 11
        frames = [bytes([i]) * (37 * i + 1) for i in range(40)]
        got = []
        for f in frames:
            while not prod.try_write_parts([f[:5], memoryview(f[5:])], len(f)):
                got.append(bytes(cons.read()))
        while cons.readable():
            got.append(bytes(cons.read()))
        assert got == frames
        cons.set_consumer_parked(True)
        assert prod.consumer_parked()
        cons.add_credits(7)
        cons.add_credits(2)
        assert prod.credits_granted() == 9
    finally:
        cons.close(unlink=True)
        prod.close()


def test_ring_attach_of_a_bad_file_raises():
    path = _ring_path("bad")
    with open(path, "wb") as f:
        f.write(b"\0" * 300)
    try:
        with pytest.raises(ValueError, match="mismatch"):
            ShmByteRing.attach(path)
    finally:
        os.unlink(path)
    with pytest.raises(FileNotFoundError):
        ShmByteRing.attach(path)


# -- the reactor's parsers --------------------------------------------------------------

def test_frame_parsers_split_streams_at_any_byte():
    """Both framings parse a stream fed in arbitrary chunks, hand out
    writable payloads, and report a frame cut in the middle."""
    from flink_tensorflow_tpu_torch.core.reactor import LengthPrefixedParser, ShuffleFrameParser

    objs = [el.StreamRecord({"x": np.arange(300, dtype=np.float32)}), el.CheckpointBarrier(2),
            [el.StreamRecord(i) for i in range(5)]]
    wire = b"".join(b"".join(bytes(p) for p in encode_obj_frame(o)[0]) for o in objs)
    payloads = [b"abc", b"", bytes(range(256)) * 10]
    lp_wire = b"".join(len(p).to_bytes(8, "little") + p for p in payloads)
    for cut in (1, 7, 64, 1000):
        parser, lp = ShuffleFrameParser(), LengthPrefixedParser()
        got = [m for i in range(0, len(wire), cut) for m in parser.feed(wire[i:i + cut])]
        assert not parser.buffered
        assert got[1][0] == el.CheckpointBarrier(2) and len(got[2][0]) == 5
        assert got[0][0].value["x"].flags.writeable
        np.testing.assert_array_equal(got[0][0].value["x"], np.arange(300, dtype=np.float32))
        lp_got = [m for i in range(0, len(lp_wire), cut) for m in lp.feed(lp_wire[i:i + cut])]
        assert [bytes(p) for p, _ in lp_got] == payloads
        assert all(isinstance(p, bytearray) for p, _ in lp_got)
    parser = ShuffleFrameParser()
    assert parser.feed(wire[:-3]) and parser.buffered
    with pytest.raises(ConnectionError, match="oversized"):
        LengthPrefixedParser().feed((1 << 31).to_bytes(8, "little"))


# -- transport ----------------------------------------------------------------------

def test_elements_cross_in_order():
    gate = InputGate(2, capacity=64)
    server = ShuffleServer("127.0.0.1")
    server.register_gate("op", 1, gate)
    server.start()
    w = RemoteChannelWriter("127.0.0.1", server.port, "op", 1, 1, connect_timeout_s=10.0)
    try:
        sent = [el.StreamRecord({"x": 1}, 0.5), el.Watermark(1.0), el.CheckpointBarrier(3),
                el.StreamRecord([1, 2, 3]), el.EndOfPartition()]
        for e in sent:
            w.write(e)
        got = [gate.poll(timeout=10.0) for _ in sent]
        assert all(item is not None and item[0] == 1 for item in got)
        assert [type(e) for _, e in got] == [type(e) for e in sent]
        assert got[0][1].value == {"x": 1} and got[0][1].timestamp == 0.5
        assert got[2][1].checkpoint_id == 3
    finally:
        w.close()
        server.close()


def test_large_record_out_of_band_roundtrip():
    gate = InputGate(1, capacity=4)
    server = _server(gate)
    w = _writer(server.port)
    try:
        rng = np.random.RandomState(0)
        img = rng.randint(0, 256, (299, 299, 3)).astype(np.uint8)
        vec = rng.randn(1 << 20).astype(np.float32)
        w.write(el.StreamRecord(TensorValue({"image": img, "vec": vec}, {"i": 7}), 1.25))
        _, got = gate.poll(timeout=30.0)
        assert got.timestamp == 1.25 and got.value.meta["i"] == 7
        np.testing.assert_array_equal(got.value["image"], img)
        np.testing.assert_array_equal(got.value["vec"], vec)
        # A leaf that is not contiguous pickles in band.
        w.write(el.StreamRecord(TensorValue({"t": img[::2, ::2]}, {})))
        _, got2 = gate.poll(timeout=30.0)
        np.testing.assert_array_equal(got2.value["t"], img[::2, ::2])
    finally:
        w.close()
        server.close()


def test_tensors_cross_as_host_tensors():
    """Torch tensors cross as CPU tensors with their values, dtypes and
    shapes (a device tensor crosses as its host copy: the card test)."""
    gate = InputGate(1, capacity=8)
    server = _server(gate)
    w = _writer(server.port, flush_bytes=0)
    try:
        sent = {"f": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                "b": torch.ones(4, dtype=torch.bfloat16) * 1.5,
                "p": torch.nn.Parameter(torch.full((3,), 2.0))}
        w.write(el.StreamRecord(sent))
        _, got = gate.poll(timeout=10.0)
        for name, t in sent.items():
            assert got.value[name].device.type == "cpu"
            assert got.value[name].dtype == t.dtype
            assert torch.equal(got.value[name].detach(), t.detach())
    finally:
        w.close()
        server.close()


def test_control_route():
    msgs = []
    server = ShuffleServer("127.0.0.1", on_control=lambda sender, m: msgs.append((sender, m)))
    server.start()
    w = RemoteChannelWriter("127.0.0.1", server.port, ShuffleServer.CONTROL_TASK, 1, 0,
                            connect_timeout_s=10.0)
    try:
        w.write(("ckpt_durable", 7, 1))
        deadline = time.monotonic() + 10.0
        while not msgs and time.monotonic() < deadline:
            time.sleep(0.02)
        assert msgs == [(1, ("ckpt_durable", 7, 1))]
    finally:
        w.close()
        server.close()


def test_traffic_counters():
    reg = MetricRegistry()
    gate = InputGate(1)
    server = _server(gate, metrics=reg)
    w = _writer(server.port, metrics=reg)
    try:
        for i in range(5):
            w.write(el.StreamRecord(i))
        w.write(el.EndOfPartition())
        assert len(_drain(gate, 6)) == 6
        report = _await_metric(reg, "shuffle.out.op.0.ch0.records", 5)
        assert report["shuffle.out.op.0.ch0.records"] == 5
        assert report["shuffle.in.op.0.ch0.records"] == 5
        assert report["shuffle.out.op.0.ch0.bytes"] == report["shuffle.in.op.0.ch0.bytes"] > 0
        assert report["reactor.connections"] == 1
    finally:
        w.close()
        server.close()


# -- coalescing ---------------------------------------------------------------------

def test_barrier_forces_flush_order_preserved():
    gate = InputGate(1, capacity=64)
    server = _server(gate)
    w = _writer(server.port, flush_bytes=1 << 20, flush_ms=10_000.0)
    try:
        for i in range(5):
            w.write(el.StreamRecord(_tv(i)))
        w.write(el.CheckpointBarrier(1))
        for i in range(5, 8):
            w.write(el.StreamRecord(_tv(i)))
        w.write(el.EndOfPartition())
        got = _drain(gate, 10)
        assert [type(e) for e in got] == ([el.StreamRecord] * 5 + [el.CheckpointBarrier]
                                          + [el.StreamRecord] * 3 + [el.EndOfPartition])
        assert [e.value.meta["i"] for e in got[:5]] == list(range(5))
        assert got[5].checkpoint_id == 1
        assert [e.value.meta["i"] for e in got[6:9]] == [5, 6, 7]
    finally:
        w.close()
        server.close()


def _flush_run(pkg, n=40):
    """40 records at flush_bytes 2000, a barrier, a watermark, EOP: the
    flush reasons a writer books."""
    if pkg == "jax":
        from flink_tensorflow_tpu.core import elements as E
        from flink_tensorflow_tpu.core.channels import InputGate as G
        from flink_tensorflow_tpu.core.shuffle import RemoteChannelWriter as W
        from flink_tensorflow_tpu.core.shuffle import ShuffleServer as S
        from flink_tensorflow_tpu.metrics.registry import MetricRegistry as R
        from flink_tensorflow_tpu.tensors.value import TensorValue as T
    else:
        E, G, W, S, R, T = el, InputGate, RemoteChannelWriter, ShuffleServer, MetricRegistry, \
            TensorValue
    reg = R()
    gate = G(1, capacity=256)
    server = S("127.0.0.1", metrics=reg)
    server.register_gate("op", 0, gate)
    server.start()
    w = W("127.0.0.1", server.port, "op", 0, 0, connect_timeout_s=10.0, metrics=reg,
          flush_bytes=2_000, flush_ms=10_000.0)
    try:
        for i in range(n):
            w.write(E.StreamRecord(T({"x": np.full(16, i, np.float32)}, {"i": i})))
        w.write(E.CheckpointBarrier(1))
        w.write(E.StreamRecord(T({"x": np.zeros(16, np.float32)}, {"i": n})))
        w.write(E.Watermark(2.0))
        w.write(E.EndOfPartition())
        got = []
        deadline = time.monotonic() + 15.0
        while len(got) < n + 4 and time.monotonic() < deadline:
            item = gate.poll(timeout=0.5)
            if item is not None:
                got.append(item[1])
        scope = "shuffle.out.op.0.ch0"
        deadline = time.monotonic() + 5.0
        while reg.report().get(f"{scope}.records") != n + 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        report = reg.report()
    finally:
        w.close()
        server.close()
    flushes = {r: report[f"{scope}.flush_{r}"] for r in ("size", "timeout", "barrier", "close")}
    return ([type(e).__name__ for e in got], flushes, report[f"{scope}.records"],
            report["wire.flush_total"]["count"], report["shuffle.in.op.0.ch0.records"])


def test_flush_reasons_equal_jax():
    """The same writes through both packages: the same element order, the
    same flush reasons, records and flushes (``flush_size`` at 2000
    estimated bytes, ``flush_barrier`` ahead of the barrier and the
    watermark, none on the timeout)."""
    got = _flush_run("port")
    assert got == _flush_run("jax")
    kinds, flushes, records, total, received = got
    assert flushes["size"] >= 1 and flushes["barrier"] == 2 and flushes["timeout"] == 0
    assert records == received == 41 and total == sum(flushes.values())


def test_timeout_flush():
    reg = MetricRegistry()
    gate = InputGate(1, capacity=64)
    server = _server(gate)
    w = _writer(server.port, metrics=reg, flush_bytes=1 << 20, flush_ms=20.0)
    try:
        for i in range(3):
            w.write(el.StreamRecord(_tv(i)))
        assert [e.value.meta["i"] for e in _drain(gate, 3)] == [0, 1, 2]
        report = _await_metric(reg, "shuffle.out.op.0.ch0.flush_timeout", 1)
        assert report["shuffle.out.op.0.ch0.flush_timeout"] == 1
    finally:
        w.close()
        server.close()


def test_timeout_flush_rearms_across_idle_gaps():
    reg = MetricRegistry()
    gate = InputGate(1, capacity=64)
    server = _server(gate)
    w = _writer(server.port, metrics=reg, flush_bytes=1 << 20, flush_ms=10.0)
    try:
        for i in range(3):
            w.write(el.StreamRecord(_tv(i)))
            assert [e.value.meta["i"] for e in _drain(gate, 1)] == [i]
            time.sleep(0.05)
        report = _await_metric(reg, "shuffle.out.op.0.ch0.flush_timeout", 3)
        assert report["shuffle.out.op.0.ch0.flush_timeout"] == 3
    finally:
        w.close()
        server.close()


@pytest.mark.parametrize("knobs", [dict(flush_bytes=0), dict(flush_bytes=1 << 20, flush_ms=0.0)])
def test_per_record_modes_send_a_frame_per_record(knobs):
    reg = MetricRegistry()
    gate = InputGate(1, capacity=64)
    server = _server(gate)
    w = _writer(server.port, metrics=reg, **knobs)
    try:
        for i in range(4):
            w.write(el.StreamRecord(_tv(i)))
        w.write(el.EndOfPartition())
        assert len(_drain(gate, 5)) == 5
        hist = reg.report()["shuffle.out.op.0.ch0.frame_records"]
        # flush_bytes 0 books no flushes (each record is sent alone);
        # flush_ms 0 flushes every record as a frame of one.
        assert hist["count"] in (0, 4) and (hist["count"] == 0 or hist["p99"] == 1)
    finally:
        w.close()
        server.close()


def test_columnar_roundtrip_with_timestamps():
    gate = InputGate(1, capacity=64)
    server = _server(gate)
    w = _writer(server.port, flush_bytes=1 << 20, flush_ms=10_000.0)
    try:
        for i in range(6):
            w.write(el.StreamRecord(_tv(i), timestamp=0.5 * i))
        frame = w._coalesce([el.StreamRecord(_tv(i)) for i in range(3)])
        assert isinstance(frame, ColumnarFrame) and frame.timestamps is None
        assert [r.value.meta["i"] for r in expand_message(frame)] == [0, 1, 2]
        w.write(el.EndOfPartition())
        got = _drain(gate, 7)
        for i, e in enumerate(got[:6]):
            assert e.timestamp == 0.5 * i and e.value.meta["i"] == i
            np.testing.assert_array_equal(e.value["x"], np.full(16, i, np.float32))
    finally:
        w.close()
        server.close()


def test_heterogeneous_run_falls_back_to_list():
    gate = InputGate(1, capacity=64)
    server = _server(gate)
    w = _writer(server.port, flush_bytes=1 << 20, flush_ms=10_000.0)
    try:
        assert not isinstance(w._coalesce([el.StreamRecord(_tv(0)), el.StreamRecord(7)]),
                              ColumnarFrame)
        assert type(w._coalesce([el.StreamRecord(_tv(0)), el.StreamRecord(_tv(1, n=8))])) is list
        w.write(el.StreamRecord(_tv(0)))
        w.write(el.StreamRecord(7))
        w.write(el.StreamRecord(TensorValue({"y": np.ones((2, 2), np.float64)}, {"i": 2})))
        w.write(el.EndOfPartition())
        got = _drain(gate, 4)
        np.testing.assert_array_equal(got[0].value["x"], _tv(0)["x"])
        assert got[1].value == 7 and got[2].value.meta["i"] == 2
    finally:
        w.close()
        server.close()


@pytest.mark.parametrize("wire,rtol", [("bf16", 2 ** -8), ("f16", 2 ** -10)])
def test_columnar_narrowed_wire_dtype(wire, rtol):
    gate = InputGate(1, capacity=64)
    server = _server(gate)
    w = _writer(server.port, flush_bytes=1 << 20, flush_ms=10_000.0, wire_dtype=wire)
    try:
        vals = [TensorValue({"x": (np.arange(16, dtype=np.float32) - 8) * (i + 1)}, {"i": i})
                for i in range(4)]
        for v in vals:
            w.write(el.StreamRecord(v))
        w.write(el.EndOfPartition())
        for v, e in zip(vals, _drain(gate, 5)[:4]):
            assert e.value["x"].dtype == np.float32
            np.testing.assert_allclose(e.value["x"], v["x"], rtol=rtol, atol=1e-6)
    finally:
        w.close()
        server.close()


def test_decoded_oob_buffers_are_writable():
    gate = InputGate(1, capacity=64)
    server = _server(gate)
    w = _writer(server.port, flush_bytes=1 << 20, flush_ms=10_000.0)
    try:
        w.write(el.StreamRecord({"x": np.arange(1000, dtype=np.float32)}))
        w.write(el.StreamRecord({"x": np.ones(500, np.float32)}))
        w.write(el.EndOfPartition())
        for e in _drain(gate, 3)[:2]:
            arr = e.value["x"]
            assert arr.flags.writeable
            arr += 1.0
    finally:
        w.close()
        server.close()


# -- truncation ---------------------------------------------------------------------

def _raw_conn(port):
    s = socket.create_connection(("127.0.0.1", port), timeout=10.0)
    _send_obj(s, ("op", 0, 0))
    return s


def test_peer_death_mid_coalesced_frame_raises():
    errors = []
    gate = InputGate(1)
    server = _server(gate, on_error=errors.append)
    try:
        s = _raw_conn(server.port)
        parts, _ = encode_obj_frame([el.StreamRecord(_tv(i)) for i in range(8)])
        frame = b"".join(bytes(p) for p in parts)
        s.sendall(frame[:len(frame) - 11])
        s.close()
        assert _await_errors(errors), "mid-frame truncation was not reported"
        assert "truncat" in str(errors[0]) or "mid-frame" in str(errors[0])
    finally:
        server.close()


def test_clean_eof_without_eop_is_peer_loss():
    errors = []
    gate = InputGate(1)
    server = _server(gate, on_error=errors.append)
    try:
        s = _raw_conn(server.port)
        _send_obj(s, el.StreamRecord(_tv(1)))
        s.close()
        assert _await_errors(errors) and "EndOfPartition" in str(errors[0])
    finally:
        server.close()


def test_disconnect_before_eop_reports_error():
    errors = []
    gate = InputGate(1)
    server = _server(gate, on_error=errors.append)
    w = _writer(server.port)
    try:
        w.write(el.StreamRecord(1))
        w.write(el.Watermark(0.0))  # flushes the buffered record
        assert gate.poll(timeout=10.0) is not None
        w._sock.close()
        assert _await_errors(errors), "peer loss was not reported"
    finally:
        server.close()


def test_unknown_route_is_a_placement_error():
    errors = []
    gate = InputGate(1)
    server = _server(gate, on_error=errors.append)
    w = RemoteChannelWriter("127.0.0.1", server.port, "other", 3, 0, connect_timeout_s=10.0,
                            flush_bytes=0, reconnect_timeout_s=0.0)
    try:
        w.write(el.StreamRecord(1))
        assert _await_errors(errors) and "placement mismatch" in str(errors[0])
    finally:
        w.close()
        server.close()


# -- backpressure ---------------------------------------------------------------------

def test_full_gate_pauses_and_resumes_lossless():
    reg = MetricRegistry()
    gate = InputGate(1, capacity=4)
    server = _server(gate, metrics=reg)
    w = _writer(server.port, flush_bytes=600, flush_ms=2.0)
    n = 300

    def produce():
        for i in range(n):
            w.write(el.StreamRecord(_tv(i, n=8)))
        w.write(el.EndOfPartition())

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        got = []
        deadline = time.monotonic() + 30.0
        while len(got) < n + 1 and time.monotonic() < deadline:
            item = gate.poll(timeout=0.5)
            if item is None:
                continue
            got.append(item[1])
            time.sleep(0.0005)
        assert len(got) == n + 1
        assert [e.value.meta["i"] for e in got[:-1]] == list(range(n))
        assert isinstance(got[-1], el.EndOfPartition)
        assert reg.report()["shuffle.in.op.0.ch0.gate_paused"] > 0
    finally:
        t.join(timeout=5)
        w.close()
        server.close()


# -- shm edges ---------------------------------------------------------------------------

def test_same_host_edge_rides_the_ring():
    gate = InputGate(1, capacity=256)
    server = _server(gate)
    w = _writer(server.port, flush_bytes=4_000, flush_ms=5.0, shm=True)
    try:
        for i in range(100):
            w.write(el.StreamRecord(_tv(i)))
        w.write(el.EndOfPartition())
        got = _drain(gate, 101)
        assert [e.value.meta["i"] for e in got[:-1]] == list(range(100))
        # The transport was the ring, and the receiver removed its name as
        # soon as it had attached (the mappings live on).
        assert w._ring is not None
        assert not os.path.exists(w._ring.path)
    finally:
        w.close()
        server.close()


def test_barriers_and_watermarks_cross_the_ring():
    gate = InputGate(1, capacity=64)
    server = _server(gate)
    w = _writer(server.port, flush_bytes=1 << 20, flush_ms=10_000.0, shm=True)
    try:
        w.write(el.StreamRecord(_tv(0)))
        w.write(el.Watermark(1.5))
        w.write(el.CheckpointBarrier(3))
        w.write(el.StreamRecord(_tv(1)))
        w.write(el.EndOfPartition())
        got = _drain(gate, 5)
        assert [type(e) for e in got] == [el.StreamRecord, el.Watermark, el.CheckpointBarrier,
                                          el.StreamRecord, el.EndOfPartition]
        assert got[1].timestamp == 1.5 and got[2].checkpoint_id == 3
    finally:
        w.close()
        server.close()


def test_a_ring_no_receiver_attached_is_removed_on_cancel():
    """The receiver removes a ring's name once it has attached; a writer
    closed before end-of-partition (a cancel) removes it when no receiver
    ever did."""
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)  # accepts the connection, never reads the handshake
    w = _writer(listener.getsockname()[1], flush_bytes=0, shm=True)
    try:
        w.write(el.StreamRecord(_tv(0)))
        path = w._ring.path
        assert os.path.exists(path)
        w.close()
        assert not os.path.exists(path)
    finally:
        w.close()
        listener.close()


def test_shm_requires_local_host():
    assert not RemoteChannelWriter("198.51.100.7", 1, "op", 0, 0, shm=True).shm
    assert RemoteChannelWriter("localhost", 1, "op", 0, 0, shm=True).shm
    assert RemoteChannelWriter(socket.gethostname(), 1, "op", 0, 0, shm=True).shm


def test_doorbell_suppressed_wakes_after_idle_gaps():
    gate = InputGate(1, capacity=256)
    server = _server(gate)
    w = _writer(server.port, flush_bytes=64, flush_ms=2.0, shm=True)
    try:
        total = 0
        for _ in range(5):
            for i in range(10):
                w.write(el.StreamRecord(_tv(total + i)))
            total += 10
            assert [e.value.meta["i"] for e in _drain(gate, 10)] == list(range(total - 10, total))
            time.sleep(0.03)
            assert w._ring is not None and w._ring.consumer_parked()
        w.write(el.EndOfPartition())
        assert len(_drain(gate, 1)) == 1
    finally:
        w.close()
        server.close()


# -- credit flow control ----------------------------------------------------------------

@pytest.fixture()
def reactor():
    r = Reactor()
    r.start()
    yield r
    r.close()


def test_stalled_consumer_bounds_sender_queue(reactor):
    reg = MetricRegistry()
    gate = InputGate(1, capacity=64)
    window = credit_window(64)
    server = _server(gate, metrics=reg)
    w = _writer(server.port, metrics=reg, flush_bytes=1024, flush_ms=0.0, flow_control=True,
                reactor=reactor)
    n = 300
    written = [0]

    def produce():
        for i in range(n):
            w.write(el.StreamRecord(_tv(i)))
            written[0] += 1
        w.write(el.EndOfPartition())

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        time.sleep(1.0)
        assert written[0] < n, "the producer must park at zero credit"
        bound = window * (1024 + 1024)
        assert w._conn is not None and w._conn.peak_send_queue_bytes <= bound
        got = _drain(gate, n + 1, timeout=30.0)
        assert [e.value.meta["i"] for e in got[:-1]] == list(range(n))
        assert isinstance(got[-1], el.EndOfPartition)
        assert w._conn is None or w._conn.peak_send_queue_bytes <= bound
        report = reg.report()
        assert report["shuffle.out.op.0.ch0.credit_starved_s"] > 0.3
        assert report["shuffle.in.op.0.ch0.credit_grants"] > 0
    finally:
        t.join(timeout=10)
        w.close()
        server.close()


def test_flow_control_off_queue_grows(reactor):
    gate = InputGate(1, capacity=64)
    server = _server(gate)
    w = _writer(server.port, flush_bytes=1024, flush_ms=0.0, reactor=reactor)
    n = 1500
    try:
        for i in range(n):
            w.write(el.StreamRecord(_tv(i, n=256)))
        assert w._conn.peak_send_queue_bytes > 50_000
        assert len(_drain(gate, n, timeout=30.0)) == n
    finally:
        w.close()
        server.close()


def test_barrier_bypasses_zero_credit_and_drain_replenishes(reactor):
    reg = MetricRegistry()
    gate = InputGate(1, capacity=4)  # low water 2, window 2
    assert credit_window(4) == 2
    server = _server(gate, metrics=reg)
    w = _writer(server.port, metrics=reg, flush_bytes=1, flush_ms=0.0, flow_control=True,
                reactor=reactor)
    try:
        # rec0 drains below low water (replenished); rec1 and rec2 leave the
        # gate at or over it (withheld): 3 spent, 1 granted, window 2 -> 0.
        for i in range(3):
            w.write(el.StreamRecord(_tv(i)))
            deadline = time.monotonic() + 5.0
            while gate.depth < i + 1 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert gate.depth == i + 1
            time.sleep(0.05)
        assert w._fc_credits_now() == 0
        done = threading.Event()

        def control_plane():
            w.write(el.CheckpointBarrier(7))
            w.write(el.EndOfPartition())
            done.set()

        t = threading.Thread(target=control_plane, daemon=True)
        t.start()
        assert done.wait(timeout=5.0), "barrier/EOP wedged on a zero-credit edge"
        got = _drain(gate, 5)
        assert [type(e) for e in got] == [el.StreamRecord] * 3 + [el.CheckpointBarrier,
                                                                   el.EndOfPartition]
        assert got[3].checkpoint_id == 7
        t.join(timeout=5)
    finally:
        w.close()
        server.close()


def test_shm_ring_credits_park_and_recover():
    reg = MetricRegistry()
    gate = InputGate(1, capacity=64)
    server = _server(gate, metrics=reg)
    w = _writer(server.port, metrics=reg, flush_bytes=1024, flush_ms=0.0, shm=True,
                flow_control=True)
    n = 300
    written = [0]

    def produce():
        for i in range(n):
            w.write(el.StreamRecord(_tv(i)))
            written[0] += 1
        w.write(el.CheckpointBarrier(3))
        w.write(el.EndOfPartition())

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        time.sleep(1.0)
        assert w._ring is not None, "a same-host edge must ride the ring"
        assert written[0] < n, "the producer must park on ring credits"
        got = _drain(gate, n + 2, timeout=30.0)
        assert [e.value.meta["i"] for e in got[:n]] == list(range(n))
        assert isinstance(got[n], el.CheckpointBarrier)
        assert isinstance(got[n + 1], el.EndOfPartition)
        assert reg.report()["shuffle.out.op.0.ch0.credit_starved_s"] > 0.3
    finally:
        t.join(timeout=10)
        w.close()
        server.close()


def test_stale_generation_grants_dropped():
    w = RemoteChannelWriter("127.0.0.1", 1, "op", 0, 0)
    with w._fc_cv:
        w._fc_gen = 3
        w._fc_credits = 0
    w._on_grant(((CREDIT_GRANT, 5),), 3)
    assert w._fc_credits == 5
    w._on_grant(((CREDIT_GRANT, 100),), 2)
    assert w._fc_credits == 5


def test_a_blocking_writer_stays_credit_free():
    """Flow control needs a grant lane (a reactor or the ring)."""
    gate = InputGate(1, capacity=4)
    server = _server(gate)
    w = _writer(server.port, flush_bytes=0, flow_control=True)
    try:
        w.write(el.StreamRecord(0))
        assert not w._fc_active
        assert len(_drain(gate, 1)) == 1
    finally:
        w.close()
        server.close()


# -- the restart-epoch fence ----------------------------------------------------------

def test_zombie_frames_dropped():
    reg = MetricRegistry()
    errors = []
    server = ShuffleServer("127.0.0.1", 0, on_error=errors.append, metrics=reg, epoch=2)
    gate = InputGate(1, capacity=64)
    server.register_gate("sum", 0, gate)
    server.start()
    try:
        zombie = RemoteChannelWriter("127.0.0.1", server.port, "sum", 0, 0, epoch=1,
                                     flush_bytes=0)
        for i in range(5):
            zombie.write(el.StreamRecord(("zombie", i), None))
        zombie.write(el.EndOfPartition())
        zombie.close()
        live = RemoteChannelWriter("127.0.0.1", server.port, "sum", 0, 0, epoch=2,
                                   flush_bytes=0)
        for i in range(3):
            live.write(el.StreamRecord(("live", i), None))
        live.write(el.EndOfPartition())
        live.close()
        got = _drain(gate, 4, timeout=10.0)
    finally:
        time.sleep(0.2)
        server.close()
    assert [e.value for e in got if isinstance(e, el.StreamRecord)] == [
        ("live", 0), ("live", 1), ("live", 2)]
    assert reg.report()["recovery.stale_epoch_frames"] >= 6
    assert not errors


def test_same_epoch_not_fenced():
    server = ShuffleServer("127.0.0.1", 0, epoch=3)
    gate = InputGate(1, capacity=16)
    server.register_gate("t", 0, gate)
    server.start()
    try:
        w = RemoteChannelWriter("127.0.0.1", server.port, "t", 0, 0, epoch=3, flush_bytes=0)
        w.write(el.StreamRecord("x", None))
        w.write(el.EndOfPartition())
        w.close()
        item = gate.poll(timeout=5.0)
        assert item is not None and item[1].value == "x"
    finally:
        server.close()


def test_reconnect_resends_the_frame_in_flight():
    """A transport that breaks between frames reconnects within the budget
    and resends the frame; the edge counts the reconnect."""
    reg = MetricRegistry()
    gate = InputGate(1, capacity=64)
    server = _server(gate, metrics=reg)
    w = _writer(server.port, metrics=reg, flush_bytes=0)
    try:
        w.write(el.StreamRecord(0))
        assert len(_drain(gate, 1)) == 1
        w._sock.shutdown(socket.SHUT_RDWR)
        w._sock.close()
        w.write(el.StreamRecord(1))
        w.write(el.EndOfPartition())
        got = _drain(gate, 2)
        assert got[0].value == 1 and isinstance(got[1], el.EndOfPartition)
        assert reg.report()["shuffle.out.op.0.ch0.reconnects"] == 1
    finally:
        w.close()
        server.close()


def test_gate_listeners_and_batch_put():
    gate = InputGate(1, capacity=4)
    space, drained = [], []
    gate.add_space_listener(lambda: space.append(1))
    gate.add_drain_listener(lambda: drained.append(1))
    assert gate.try_put_batch(0, [el.StreamRecord(i) for i in range(6)]) == 4
    assert gate.try_put_batch(0, [el.StreamRecord(9)]) == 0
    assert gate.depth == 4
    gate.poll(timeout=0)   # full -> not full
    assert space == [1] and drained == []
    gate.poll(timeout=0)
    gate.poll(timeout=0)   # below low water (2)
    assert drained == [1]
    gate.wake()
    assert gate.depth == 1  # a wake sentinel is no element
    gate.close()
    assert len(space) == 2 and len(drained) == 2
    assert gate.try_put_batch(0, [el.StreamRecord(0)]) == 1  # a closed gate drops


def test_shuffle_probe_delivers_every_arm():
    """``core/shuffle_probe.py`` at a small size: every arm delivers every
    record across the process boundary (it raises otherwise) and the
    bench's ratios are there."""
    from flink_tensorflow_tpu_torch.core.shuffle_probe import ARMS, shuffle_bench

    result = shuffle_bench(((64, 300), (1024, 50)), passes=1)
    assert sorted(result["arms"]) == sorted(ARMS)
    for rows in result["arms"].values():
        assert [r["records"] for r in rows] == [300, 50]
        assert all(r["wire_sustained_mb_s"] > 0 for r in rows)
    assert len(result["coalesce_columnar_speedup_small_records"]) == 2
    assert len(result["shm_vs_loopback_tcp_ratio"]) == 2
