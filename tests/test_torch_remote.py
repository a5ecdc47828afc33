"""The job-to-job pipe of the port (``io/remote.py``: ``RemoteSink`` and
``RemoteSource``) held to the JAX package's (``tests/test_remote.py``,
``tests/test_faults.py::TestSeverRecovery``).

A producer job streams records through a ``RemoteSink`` into a consumer
job's ``RemoteSource`` and two-phase-commit sink.  Clean and with the edge
severed, both packages commit the same bytes, the severed sink reconnects
once and resends its burst, and the flush-reason counters still add up.
The wire is the same serde in both packages, so a JAX sink feeds a port
source and a port sink feeds a JAX source.  Each job runs with its own
timeout; no assert depends on timing."""

import importlib
import socket
import threading
import time
import types

import numpy as np
import pytest


def _pkg(name):
    mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
    return types.SimpleNamespace(
        env=mod("core.environment"), files=mod("io.files"), remote=mod("io.remote"),
        serde=mod("tensors.serde"), tv=mod("tensors.value"), io=mod("io"))


PKGS = {"jax": _pkg("flink_tensorflow_tpu"), "torch": _pkg("flink_tensorflow_tpu_torch")}


def _committed(p, out):
    return sorted(bytes(p.serde.encode_record(r)) for r in p.files.read_committed(out))


def run_pipe(producer, consumer, tmp_path, tag, *, n=50, faults=None, sink_kw=None,
             records=None):
    """``producer``'s job maps ``range(n)`` into records and ships them
    through its ``RemoteSink``; ``consumer``'s job reads them with its
    ``RemoteSource`` into a 2PC sink on a thread.  Returns the producer's
    metrics and the consumer's committed bytes."""
    out = str(tmp_path / f"pipe-{tag}")
    source = consumer.remote.RemoteSource(bind="127.0.0.1")
    errors = []

    def consume():
        try:
            cenv = consumer.env.StreamExecutionEnvironment(parallelism=1)
            cenv.from_source(source, name="rsrc").add_sink(
                consumer.files.ExactlyOnceRecordFileSink(out), name="csink")
            cenv.execute(f"consumer-{tag}", timeout=60)
        except BaseException as exc:  # noqa: BLE001 - asserted below
            errors.append(exc)

    t = threading.Thread(target=consume)
    t.start()
    env = producer.env.StreamExecutionEnvironment(parallelism=1)
    if faults:
        env.configure(faults=faults)
    TV = producer.tv.TensorValue
    data = records if records is not None else list(range(n))
    (env.from_collection(data, name="src")
     .map(lambda v: v if isinstance(v, TV) else TV({"v": np.int64(v)}, {"i": int(v)}),
          name="tv")
     .add_sink(producer.remote.RemoteSink("127.0.0.1", source.port,
                                          **(sink_kw or {"flush_bytes": 0})), name="rsink"))
    env.execute(f"producer-{tag}", timeout=60)
    t.join(60)
    assert not t.is_alive() and not errors, errors
    return env.metric_registry.report(), _committed(consumer, out)


def _count(rep, key):
    v = rep.get(key, 0)
    return v["count"] if isinstance(v, dict) else v


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("clean")
    got = {name: run_pipe(p, p, tmp, name)[1] for name, p in PKGS.items()}
    assert got["torch"] == got["jax"] and len(got["jax"]) == 50
    return got["jax"]


def test_records_roundtrip_the_same_bytes_in_both_packages():
    J, T = PKGS["jax"], PKGS["torch"]
    fields = {"image": np.arange(12, dtype=np.float32).reshape(3, 4), "label": np.int32(7),
              "empty": np.zeros((0, 3), np.float32)}
    meta = {"id": 42, "tag": "x", "pair": (1, 2)}
    jb = bytes(J.serde.encode_record(J.tv.TensorValue(fields, meta)))
    tb = bytes(T.serde.encode_record(T.tv.TensorValue(fields, meta)))
    assert jb == tb
    out = T.serde.decode_record(jb)
    assert out.meta == meta and out["empty"].shape == (0, 3)
    assert np.array_equal(out["image"], fields["image"])
    with pytest.raises(ValueError):
        T.serde.decode_record(b"\x00" * 16)


def test_the_io_package_exports_the_pipe():
    T = PKGS["torch"]
    assert T.io.RemoteSink is T.remote.RemoteSink
    assert T.io.RemoteSource is T.remote.RemoteSource
    assert set(PKGS["jax"].io.__all__) <= set(T.io.__all__)


def test_job_to_job_pipe():
    """Twin of ``TestRemoteChannel.test_job_to_job_pipe`` on the port."""
    T = PKGS["torch"]
    source = T.remote.RemoteSource(bind="127.0.0.1")

    def upstream():
        env = T.env.StreamExecutionEnvironment(parallelism=1)
        records = [T.tv.TensorValue({"x": np.full(4, i, np.float32)}, {"i": i}) for i in range(50)]
        (env.from_collection(records)
         .map(lambda r: T.tv.TensorValue({"x": r["x"] * 2}, r.meta))
         .add_sink(T.remote.RemoteSink("127.0.0.1", source.port)))
        env.execute(timeout=60)

    t = threading.Thread(target=upstream)
    t.start()
    env2 = T.env.StreamExecutionEnvironment(parallelism=1)
    out = env2.from_source(source).sink_to_list()
    env2.execute(timeout=60)
    t.join(60)
    assert {r.meta["i"]: float(r["x"][0]) for r in out} == {i: 2.0 * i for i in range(50)}


@pytest.mark.parametrize("name", sorted(PKGS))
def test_severed_pipe_reconnects_loss_free(clean, tmp_path, name):
    """``sever:rsink.0@3``: the sink's backoff reconnect resends its burst,
    the source holds the fan-in slot, and the committed bytes are the clean
    pipe's; one reconnect, one resent burst, and ``wire_flush_total`` still
    equals size + timeout + close (the resend is not a second flush)."""
    p = PKGS[name]
    rep, got = run_pipe(p, p, tmp_path, f"sever-{name}", faults="sever:rsink.0@3")
    assert got == clean
    assert rep["rsink.0.reconnects"] == 1
    assert rep["rsink.0.resent_bursts"] == 1
    assert _count(rep, "faults.sever") == 1
    assert _count(rep, "recovery.edge_reconnects") == 1
    by_reason = (rep["rsink.0.wire_flush_size"] + rep["rsink.0.wire_flush_timeout"]
                 + rep["rsink.0.wire_flush_close"])
    assert rep["rsink.0.wire_flush_total"]["count"] == by_reason
    assert rep["rsink.0.edge.credits_available"] >= 0.0


@pytest.mark.parametrize("producer,consumer", [("jax", "torch"), ("torch", "jax")])
def test_the_wire_crosses_packages(clean, tmp_path, producer, consumer):
    """A JAX sink into a port source and the reverse, clean and severed:
    the credit handshake, the coalesced columnar bursts and the end-of-stream
    marker are the same on both sides."""
    _, got = run_pipe(PKGS[producer], PKGS[consumer], tmp_path, f"{producer}-{consumer}",
                      sink_kw={"flush_bytes": 4096, "flush_ms": 1.0})
    assert got == clean
    rep, got = run_pipe(PKGS[producer], PKGS[consumer], tmp_path, f"{producer}-{consumer}-sv",
                        faults="sever:rsink.0@2")
    assert got == clean and rep["rsink.0.reconnects"] == 1


def test_coalesced_columnar_pipe_and_delays(tmp_path):
    """The bench's leg (``bench.py:run_pipe``): ``flush_bytes=4096,
    flush_ms=1.0`` over 400 records of 64 floats, with five delayed
    bursts: every record arrives once, each burst is one frame, and the
    flush reasons add up."""
    T = PKGS["torch"]
    records = [T.tv.TensorValue({"x": np.full(64, i, np.float32)}, {"i": i}) for i in range(400)]
    rep, got = run_pipe(T, T, tmp_path, "columnar", records=records,
                        faults="delay:rsink.0@2~0.001x5",
                        sink_kw={"flush_bytes": 4096, "flush_ms": 1.0})
    decoded = sorted((int(r.meta["i"]), float(r["x"][0]))
                     for r in map(T.serde.decode_record, got))
    assert decoded == [(i, float(i)) for i in range(400)]
    assert _count(rep, "faults.delay") == 5
    frames = rep["rsink.0.frame_records"]["count"]
    assert rep["rsink.0.wire_flush_total"]["count"] == frames
    assert frames < 400  # coalesced: several records per burst
    assert rep["rsink.0.wire_flush_size"] + rep["rsink.0.wire_flush_timeout"] \
        + rep["rsink.0.wire_flush_close"] == frames


def test_a_remote_source_runs_at_parallelism_one():
    T = PKGS["torch"]
    source = T.remote.RemoteSource(bind="127.0.0.1", accept_timeout_s=1.0)
    env = T.env.StreamExecutionEnvironment(parallelism=1)
    env.from_source(source, name="rsrc", parallelism=2).sink_to_list()
    with pytest.raises(Exception, match="parallelism=1"):
        env.execute("par2", timeout=30)
    source.close()
    with pytest.raises(ValueError):
        T.remote.RemoteSource(bind="127.0.0.1", fan_in=0)


def test_a_sink_takes_non_tensor_values_as_an_error(tmp_path):
    T = PKGS["torch"]
    source = T.remote.RemoteSource(bind="127.0.0.1", accept_timeout_s=5.0)
    sink = T.remote.RemoteSink("127.0.0.1", source.port)
    with pytest.raises(TypeError):
        sink.invoke(3)
    source.close()


@pytest.mark.parametrize("name", sorted(PKGS))
def test_close_waits_for_a_reconnect_in_flight(name):
    """A deadline flush reconnects on the shared timer thread, under the
    sink's lock, with its socket None until the new one lands.  The
    reference's ``close`` reads the socket outside the lock, so a close in
    that window returns at once without the end-of-stream marker and the
    peer waits for it forever; the port's waits for the reconnect, then
    flushes and ends the stream."""
    p = PKGS[name]
    source = p.remote.RemoteSource(bind="127.0.0.1", accept_timeout_s=10.0)
    sink = p.remote.RemoteSink("127.0.0.1", source.port, flush_bytes=0, flow_control=False)
    got = []
    reader = threading.Thread(target=lambda: got.extend(
        r for r in source.run() if isinstance(r, p.tv.TensorValue)))
    reader.start()
    sink.open(types.SimpleNamespace(task_name="rsink", subtask_index=0, metrics=None))
    sink.invoke(p.tv.TensorValue({"v": np.int64(1)}, {"i": 1}))
    closer = threading.Thread(target=sink.close)
    with sink._lock:  # a reconnect in flight on the timer thread
        live, sink._sock = sink._sock, None
        closer.start()
        # The reference's close never takes the lock here, so it ends while
        # the lock is held; the port's cannot end before the lock is free.
        closer.join(10 if name == "jax" else 0.3)
        returned_under_the_lock = not closer.is_alive()
        sink._sock = live
    closer.join(10)
    assert returned_under_the_lock == (name == "jax")
    if name == "jax":
        # No end-of-stream marker went out: end the stream by hand.
        live.sendall(p.remote._LEN.pack(0))
        live.close()
    reader.join(10)
    assert not reader.is_alive() and [int(r.meta["i"]) for r in got] == [1]
    source.close()


@pytest.mark.parametrize("name", sorted(PKGS))
def test_close_reads_late_grants_until_the_peer_closes(name):
    """A credit grant that reaches the sink after its last burst sits
    unread in its socket.  A close with unread bytes makes the kernel reset
    the connection instead of closing it, and a reset drops whatever the
    peer had not read yet: under load, the last bursts and the end-of-stream
    marker, so the source took a finished sink for a dropped one and waited
    out its reconnect grace (the flake of the severed and columnar pipes
    above).  The reference's close resets: the peer's next grant hits a
    broken pipe.  The port's reads and discards until the peer has read the
    marker and closed its side, so it ends with a FIN."""
    p = PKGS[name]
    server = socket.socket()
    server.bind(("127.0.0.1", 0))
    server.listen(1)
    sink = p.remote.RemoteSink("127.0.0.1", server.getsockname()[1], flush_bytes=0,
                               flow_control=False)
    sink.open(types.SimpleNamespace(task_name="rsink", subtask_index=0, metrics=None))
    conn, _ = server.accept()
    try:
        sink.invoke(p.tv.TensorValue({"v": np.int64(1)}, {"i": 1}))
        conn.sendall(p.remote._GRANT.pack(1))   # unread by the sink
        time.sleep(0.1)
        closer = threading.Thread(target=sink.close)
        closer.start()
        time.sleep(0.3)
        closing = closer.is_alive()
        late = None
        try:
            for _ in range(2):   # the first send after a reset may still pass
                conn.sendall(p.remote._GRANT.pack(1))
                time.sleep(0.05)
        except OSError as exc:
            late = exc
        data = b""
        while True:
            chunk = conn.recv(1 << 16)
            if not chunk:
                break
            data += chunk
    finally:
        conn.close()
        server.close()
    closer.join(10)
    assert not closer.is_alive()
    assert data.endswith(p.remote._LEN.pack(0))   # the marker arrived here
    if name == "jax":
        assert not closing and isinstance(late, (BrokenPipeError, ConnectionResetError))
    else:
        assert closing and late is None
