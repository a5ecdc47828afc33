"""The port's record codec, record files and two-phase-commit sink held to
the JAX package (twins of ``tests/test_file_io.py``).

Frames are compared byte for byte: a record encoded by one package
decodes in the other, and a file written by one reads back in the other.
The sink's jobs run through both packages' ``StreamExecutionEnvironment``
with count-based checkpoints; ``read_committed`` must hold every record
exactly once after a crash and a restore, and the committed files of the
two packages must hold the same records.
"""

import os
import time

import numpy as np
import pytest

import flink_tensorflow_tpu as jax_pkg
from flink_tensorflow_tpu import io as jax_io
from flink_tensorflow_tpu.checkpoint import store as jax_store
from flink_tensorflow_tpu.tensors import TensorValue as JaxTensorValue
from flink_tensorflow_tpu.tensors import serde as jax_serde
from flink_tensorflow_tpu_torch.checkpoint import store as torch_store
from flink_tensorflow_tpu_torch.core.environment import StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.core.runtime import JobFailure
from flink_tensorflow_tpu_torch.io import files as torch_io
from flink_tensorflow_tpu_torch.tensors import serde
from flink_tensorflow_tpu_torch.tensors.value import TensorValue
from test_torch_event_time import crash_map, crash_once

PACKAGES = {
    "jax": (jax_pkg.StreamExecutionEnvironment, jax_io, JaxTensorValue, jax_store),
    "torch": (StreamExecutionEnvironment, torch_io, TensorValue, torch_store),
}


def records(value_cls, n):
    return [value_cls({"x": np.float32(i) * np.ones(4, np.float32),
                       "label": np.int32(i % 3), "pixels": np.full((2, 3), i, np.uint8)},
                      {"id": i, "tag": ("t", i)}) for i in range(n)]


def same_record(a, b) -> bool:
    return (dict(a.meta) == dict(b.meta) and list(a.fields) == list(b.fields)
            and all(a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                    and np.array_equal(a[k], b[k]) for k in a.fields))


# -- the codec -------------------------------------------------------------

def test_frames_are_byte_identical_and_cross_decode():
    for want, other in zip(records(TensorValue, 5), records(JaxTensorValue, 5)):
        frame = serde.encode_record(want)
        assert frame == jax_serde.encode_record(other)
        assert same_record(jax_serde.decode_record(frame), other)
        assert same_record(serde.decode_record(jax_serde.encode_record(other)), want)


def test_scalar_fields_and_empty_meta_round_trip():
    value = TensorValue({"s": np.float64(2.5), "e": np.zeros((0, 3), np.float32)})
    back = serde.decode_record(jax_serde.encode_record(
        JaxTensorValue({"s": np.float64(2.5), "e": np.zeros((0, 3), np.float32)})))
    assert same_record(back, value) and back["s"].shape == ()
    assert not back["s"].flags.writeable  # a view of the frame, shared as is


def test_object_fields_and_narrowed_frames_are_refused():
    """Object fields and a bad magic are refused; a narrowed frame, refused
    before wire dtypes were ported, now reads back as the JAX package reads
    it (``tests/test_torch_wire.py`` holds every wire dtype)."""
    with pytest.raises(TypeError, match="object dtype"):
        serde.encode_record(TensorValue({"o": np.array([object()], dtype=object)}))
    x = np.linspace(-2, 2, 4, dtype=np.float32)
    narrowed = jax_serde.encode_record(JaxTensorValue({"x": x}), wire_dtype="bf16")
    back = serde.decode_record(narrowed)
    assert back["x"].dtype == np.float32
    np.testing.assert_array_equal(back["x"], jax_serde.decode_record(narrowed)["x"])
    with pytest.raises(ValueError, match="magic"):
        serde.decode_record(b"\0" * 12)


# -- record files ----------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax"),
                                           ("torch", "torch")])
def test_record_file_written_by_one_package_reads_in_the_other(writer, reader, tmp_path):
    path = str(tmp_path / "data.rec")
    _, wio, wcls, _ = PACKAGES[writer]
    _, rio, rcls, _ = PACKAGES[reader]
    assert wio.write_record_file(path, records(wcls, 17)) == 17
    back = rio.read_record_file(path)
    assert len(back) == 17
    assert all(same_record(b, w) for b, w in zip(back, records(rcls, 17)))


def test_record_file_source_through_a_pipeline(tmp_path):
    path = str(tmp_path / "data.rec")
    jax_io.write_record_file(path, records(JaxTensorValue, 20))
    got = {}
    for name, (env_cls, io, _, _) in PACKAGES.items():
        env = env_cls(parallelism=1)
        out = env.from_source(io.RecordFileSource(path), name="file", parallelism=2) \
            .sink_to_list()
        env.execute(timeout=30)
        got[name] = sorted(r.meta["id"] for r in out)
    assert got["torch"] == got["jax"] == list(range(20))


def test_truncated_file_fails_loudly(tmp_path):
    path = str(tmp_path / "trunc.rec")
    torch_io.write_record_file(path, records(TensorValue, 3))
    data = open(path, "rb").read()
    open(path, "wb").write(data[:-5])
    for io in (torch_io, jax_io):
        with pytest.raises(IOError, match="truncated"):
            io.read_record_file(path)


# -- the two-phase-commit sink ---------------------------------------------

def sink_job(env, io, value_cls, out_dir, n, tap=None):
    stream = env.from_collection(records(value_cls, n))
    if tap is not None:
        stream = stream.map(tap)
    stream.add_sink(io.ExactlyOnceRecordFileSink(out_dir), name="file_sink")


def ids_of(io, out_dir):
    return [r.meta["id"] for r in io.read_committed(out_dir)]


def test_clean_run_commits_everything(tmp_path):
    for name, (env_cls, io, value_cls, _) in PACKAGES.items():
        out_dir = str(tmp_path / name / "out")
        env = env_cls(parallelism=1)
        env.enable_checkpointing(str(tmp_path / name / "chk"), every_n_records=8)
        sink_job(env, io, value_cls, out_dir, 20)
        env.execute(timeout=30)
        assert sorted(ids_of(io, out_dir)) == list(range(20))
        assert not [f for f in os.listdir(out_dir) if f.endswith(".inprogress")]
    # The same transactions, file by file, in both packages.
    names = {name: sorted(os.listdir(tmp_path / name / "out")) for name in PACKAGES}
    assert names["torch"] == names["jax"] == [f"part-000-{t:06d}" for t in range(3)]
    for part in names["torch"]:
        assert open(tmp_path / "torch" / "out" / part, "rb").read() == \
            open(tmp_path / "jax" / "out" / part, "rb").read()


def test_port_output_reads_back_in_the_jax_package(tmp_path):
    out_dir = str(tmp_path / "out")
    env = StreamExecutionEnvironment(parallelism=1)
    env.enable_checkpointing(str(tmp_path / "chk"), every_n_records=8)
    sink_job(env, torch_io, TensorValue, out_dir, 20)
    env.execute(timeout=30)
    back = jax_io.read_committed(out_dir)
    assert all(same_record(b, w) for b, w in zip(back, records(JaxTensorValue, 20)))


@pytest.mark.parametrize("restart", [True, False], ids=["restart_strategy", "restore"])
def test_exactly_once_across_crash_and_restore(restart, tmp_path):
    """Checkpoints every 50 records and a crash at record 180 (once
    checkpoint 3 is durable), then a
    restart (or a fresh job restored from the directory): the committed
    output holds every record once, in both packages."""
    from flink_tensorflow_tpu.core import functions as jax_fn
    from flink_tensorflow_tpu.core.environment import RestartStrategy as JaxRestart
    from flink_tensorflow_tpu.core.runtime import JobFailure as JaxJobFailure
    from flink_tensorflow_tpu_torch.core import functions as torch_fn
    from flink_tensorflow_tpu_torch.core.environment import RestartStrategy

    extra = {"jax": (jax_fn, JaxRestart, JaxJobFailure),
             "torch": (torch_fn, RestartStrategy, JobFailure)}
    for name, (env_cls, io, value_cls, store) in PACKAGES.items():
        fn_module, restart_cls, failure = extra[name]
        out_dir, chk = str(tmp_path / name / "out"), str(tmp_path / name / "chk")
        env = env_cls(parallelism=1)
        env.enable_checkpointing(chk, every_n_records=50)
        crash = crash_map(fn_module, crash_once(180, store, chk, checkpoint=3))
        sink_job(env, io, value_cls, out_dir, 400, crash)
        if restart:
            result = env.execute(timeout=60, restart_strategy=restart_cls(max_restarts=1))
            assert result.restarts == 1
        else:
            with pytest.raises(failure):
                env.execute(timeout=60)
            before = ids_of(io, out_dir)
            assert len(before) == len(set(before)) < 400
            env = env_cls(parallelism=1)
            env.enable_checkpointing(chk, every_n_records=50)
            sink_job(env, io, value_cls, out_dir, 400)
            env.execute(timeout=60, restore_from=chk)
        assert sorted(ids_of(io, out_dir)) == list(range(400)), name


def test_rewind_to_an_earlier_checkpoint_retracts_later_commits(tmp_path):
    for name, (env_cls, io, value_cls, _) in PACKAGES.items():
        out_dir, chk = str(tmp_path / name / "out"), str(tmp_path / name / "chk")
        env = env_cls(parallelism=1)
        env.enable_checkpointing(chk, every_n_records=50)
        sink_job(env, io, value_cls, out_dir, 200)
        env.execute(timeout=30)
        assert sorted(ids_of(io, out_dir)) == list(range(200))
        env = env_cls(parallelism=1)
        env.enable_checkpointing(chk, every_n_records=50)
        sink_job(env, io, value_cls, out_dir, 200)
        env.execute(timeout=30, restore_from=chk, restore_checkpoint_id=1)
        assert sorted(ids_of(io, out_dir)) == list(range(200)), name


def test_a_cancelled_attempt_commits_nothing_uncheckpointed(tmp_path):
    """A job cancelled with no checkpoint taken commits nothing, once its
    threads have ended.  The JAX package's source loop runs ``finish()``
    and end of partition after a cancel (``core/runtime.py:run_source``),
    so the fused sink commits its open transaction: shown here, and held
    in the port, whose loops finish nothing once the attempt is
    cancelled."""
    committed = {}
    for name, (env_cls, io, value_cls, _) in PACKAGES.items():
        out_dir = str(tmp_path / name / "out")
        env = env_cls(parallelism=1)
        env.enable_checkpointing(str(tmp_path / name / "chk"))  # manual checkpoints only
        env.source_throttle_s = 0.005
        sink_job(env, io, value_cls, out_dir, 200)
        handle = env.execute_async()
        time.sleep(0.1)
        handle.cancel()
        deadline = time.monotonic() + 10
        while any(st.thread.is_alive() for st in handle.executor.subtasks):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        committed[name] = io.committed_files(out_dir)
        if name == "torch":
            # What it staged stays staged until a restore deletes it.
            assert os.listdir(out_dir) and all(
                f.endswith(".inprogress") for f in os.listdir(out_dir))
    assert committed["torch"] == []
    assert len(committed["jax"]) == 1
