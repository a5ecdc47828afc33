"""The port's happens-before log (``core/sanitizer_rt.py``) and cohort
stitcher (``core/sanitizer_stitch.py``) held to the JAX package's
(``tests/test_sanitizer_stitch.py``).

The ring's sequence numbers, truncation flag and idempotent dump behave as
the reference's; the reference's synthesized cohort and each of its seeded
protocol mutations (a dropped epoch fence, a frame past the granted credit,
a barrier reordered, a delivery from a blocked channel, a cross-process
deadlock, a truncated ring) give the same report from both stitchers; a
log the port writes (a sanitized job, and a 2-process cohort on threads)
stitches to the same report in both packages, with no violation (the
reference's own cohort logs do not: its gate takes a blocked channel's
remote frames, which its stitcher reports); and the ``python -m`` entry
exits 0, 1 or 2 as the reference's CLI does."""

import copy
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import threading

import numpy as np
import pytest

from flink_tensorflow_tpu.core import sanitizer_stitch as jstitch
from flink_tensorflow_tpu.core.sanitizer_rt import load_hb_log as jload
from flink_tensorflow_tpu_torch import DistributedConfig, StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.core import sanitizer_stitch as pstitch
from flink_tensorflow_tpu_torch.core.sanitizer_rt import (
    HB_LOG_KIND,
    ConcurrencySanitizer,
    load_hb_log,
)

sys.path.insert(0, os.path.dirname(__file__))
from _torch_ports import free_ports  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_tests():
    """The JAX test module: its ``healthy_cohort`` and ``_doc`` build the
    synthesized logs both stitchers read."""
    path = os.path.join(os.path.dirname(__file__), "test_sanitizer_stitch.py")
    spec = importlib.util.spec_from_file_location("_jax_test_sanitizer_stitch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = _reference_tests()
EDGE, CONN = REF.EDGE, REF.CONN


def _rows(doc, kind):
    return [row for row in doc["events"] if row[0] == kind]


def m_dropped_fence(s, r):
    for row in _rows(r, "epoch.handshake"):
        row[5] = {"role": "recv", "epoch": 0, "server_epoch": 1, "stale": True}


def m_unfenced_trailing_epoch(s, r):
    for row in _rows(r, "epoch.handshake"):
        row[5] = {"role": "recv", "epoch": 0, "server_epoch": 2, "stale": False}


def m_frame_past_granted_credit(s, r):
    s["events"] += [["credit.spend", 10.0060, EDGE, CONN, 2, {"gen": 0, "balance": -1, "floor": 0}],
                    ["frame.send", 10.0070, EDGE, CONN, 2, {"fc": "data", "nbytes": 64}]]


def m_spend_total_past_grants(s, r):
    for row in _rows(r, "credit.grant"):
        row[5] = {"n": 1}


def m_barrier_reordered(s, r):
    for row in _rows(r, "frame.recv"):
        row[5] = ({"nbytes": 256, "barriers": [1]} if row[4] == 0 else {"nbytes": 300})


def m_delivery_from_blocked_channel(s, r):
    for row in _rows(r, "frame.deliver"):
        if row[4] == 1:
            row[1] = 10.5065
    r["events"].sort(key=lambda row: row[1])


def m_cross_process_deadlock(s, r):
    s["events"].append(["credit.park", 10.0100, EDGE, CONN, 0, {"gen": 0, "floor": 0}])
    r["events"].append(["gate.full", 10.5110, EDGE, CONN, 1, {}])


def m_truncated_ring(s, r):
    s["truncated"], s["recorded"] = True, len(s["events"]) + 100
    m_spend_total_past_grants(s, r)


def m_truncated_below_floor(s, r):
    s["truncated"], s["recorded"] = True, len(s["events"]) + 100
    s["events"].append(["credit.spend", 10.0060, EDGE, CONN, 2,
                        {"gen": 0, "balance": -2, "floor": 0}])


def m_local_violation(s, r):
    s["violations"] = [{"kind": "lock-order-inversion", "message": "seeded", "thread": "t"}]


def m_none(s, r):
    pass


MUTATIONS = {
    "healthy": (m_none, []),
    "dropped_fence": (m_dropped_fence, ["dist-epoch-fence"]),
    "unfenced_trailing_epoch": (m_unfenced_trailing_epoch, ["dist-epoch-fence"]),
    "frame_past_granted_credit": (m_frame_past_granted_credit, ["dist-credit-overspend"]),
    "spend_total_past_grants": (m_spend_total_past_grants, ["dist-credit-overspend"]),
    # Frames 0 and 1 each carry the other's barriers: two violations.
    "barrier_reordered": (m_barrier_reordered, ["dist-barrier-reorder"] * 2),
    "delivery_from_blocked_channel": (m_delivery_from_blocked_channel,
                                      ["dist-barrier-blocked-channel"]),
    "cross_process_deadlock": (m_cross_process_deadlock, ["dist-deadlock"]),
    "truncated_ring": (m_truncated_ring, []),
    "truncated_below_floor": (m_truncated_below_floor, ["dist-credit-overspend"]),
    "local_violation": (m_local_violation, []),
}


def _cohort(case):
    mutate, _ = MUTATIONS[case]
    sender, receiver = (copy.deepcopy(d) for d in REF.healthy_cohort())
    mutate(sender, receiver)
    return [sender, receiver]


@pytest.mark.parametrize("case", sorted(MUTATIONS))
def test_both_stitchers_give_the_same_report(case):
    docs = _cohort(case)
    report = pstitch.stitch(copy.deepcopy(docs))
    assert report == jstitch.stitch(copy.deepcopy(docs))
    assert [v["kind"] for v in report["violations"]] == MUTATIONS[case][1]
    if case == "healthy":
        assert all(v == "ok" for v in report["checks"].values())
        lat = report["edges"][EDGE]["wire_latency_s"]
        assert lat["count"] == 2 and 0.0005 < lat["mean"] < 0.002
        assert report["edges"][EDGE]["bytes"] == 556
    if case == "truncated_ring":
        assert report["checks"]["credit-overspend"].startswith("skipped")
        assert report["checks"]["barrier-reorder"].startswith("skipped")
    if case == "local_violation":
        assert report["local_violations"][0]["process"] == 0


# -- the ring -------------------------------------------------------------------------

def test_seq_numbers_are_per_kind_edge_conn():
    san = ConcurrencySanitizer(name="t", hb_capacity=64)
    assert [san.hb("frame.send", "e1", "c1"), san.hb("frame.send", "e1", "c1"),
            san.hb("frame.send", "e1", "c2"), san.hb("frame.recv", "e1", "c1")] == [0, 1, 0, 0]
    assert san.hb_events == 4 and san.hb_dropped == 0


def test_ring_bounds_truncation_and_the_reference_loader(tmp_path):
    san = ConcurrencySanitizer(name="t", hb_capacity=16)
    for _ in range(40):
        san.hb("frame.send", "e", "c", nbytes=1)
    assert (san.hb_events, san.hb_recorded, san.hb_dropped) == (16, 40, 24)
    path = str(tmp_path / "hb.json")
    assert san.dump_hb_log(path, "test") == path
    doc = load_hb_log(path)
    assert doc["truncated"] is True and doc["recorded"] == 40 and len(doc["events"]) == 16
    # The port writes the reference's format: the JAX loader reads it.
    assert jload(path) == doc and doc["kind"] == HB_LOG_KIND


def test_dump_is_idempotent_per_reason_and_carries_extra(tmp_path):
    san = ConcurrencySanitizer(name="t", hb_capacity=16)
    san.hb("frame.send", "e", "c")
    path = str(tmp_path / "hb.json")
    san.dump_hb_log(path, "crash", extra={"flight_dump": "f.json"})
    san.hb("frame.send", "e", "c")
    san.dump_hb_log(path, "crash")
    doc = load_hb_log(path)
    assert len(doc["events"]) == 1 and doc["extra"] == {"flight_dump": "f.json"}
    assert san.dump_hb_log(None, "x") is None


def test_load_rejects_a_non_log(tmp_path):
    path = tmp_path / "not_a_log.json"
    path.write_text(json.dumps({"kind": "something-else"}))
    with pytest.raises(ValueError):
        load_hb_log(str(path))
    with pytest.raises(ValueError):
        pstitch.load_report(str(path))


# -- logs the port writes -------------------------------------------------------------

def test_a_sanitized_job_dumps_a_log_both_stitchers_read_the_same():
    with tempfile.TemporaryDirectory() as d:
        hb = os.path.join(d, "job.hb.json")
        env = StreamExecutionEnvironment(parallelism=2)
        env.configure(sanitize=True, sanitize_log_path=hb)
        env.enable_checkpointing(d, every_n_records=8)
        out = (env.from_collection(list(range(32)), parallelism=1)
               .map(lambda v: v + 1, name="inc", parallelism=1)
               .rebalance()
               .map(lambda v: v * 2, name="dbl", parallelism=2)
               .sink_to_list())
        env.execute("hb-dump-job", timeout=120)
        assert sorted(out) == sorted((v + 1) * 2 for v in range(32))
        doc = load_hb_log(hb)
        assert doc["reason"] == "shutdown" and doc["violations"] == []
        kinds = {row[0] for row in doc["events"]}
        assert {"barrier.inject", "align.block", "align.unblock"} <= kinds
        report = pstitch.stitch([doc])
        assert report == jstitch.stitch([jload(hb)])
        assert report["violations"] == []
        snap = env.metric_registry.report()
        assert snap["sanitizer.cohort.hb_recorded"] > 0
        assert snap["sanitizer.cohort.violations"] == 0


def test_an_unsanitized_job_writes_no_log(monkeypatch):
    monkeypatch.delenv("FLINK_TPU_SANITIZE", raising=False)
    with tempfile.TemporaryDirectory() as d:
        hb = os.path.join(d, "job.hb.json")
        env = StreamExecutionEnvironment(parallelism=1)
        env.configure(sanitize_log_path=hb)
        env.from_collection([1, 2, 3]).sink_to_list()
        env.execute("no-sanitizer", timeout=60)
        assert not os.path.exists(hb)


def test_a_cohort_on_threads_logs_both_halves_and_stitches_clean(tmp_path):
    """Two executors over the record plane, a rebalance edge from process 0
    into process 1 (TCP) and back (a shared-memory ring), each dumping ``hb.proc<k>.json``: the frames, credits and
    handshakes of both ends pair up and stitch with no violation, the
    same report from both packages."""
    from flink_tensorflow_tpu_torch.core import functions as fn

    class Tag(fn.MapFunction):
        def map(self, value):
            return value

    hb = str(tmp_path / "hb.json")
    ports = free_ports(2)
    peers = tuple(f"127.0.0.1:{p}" for p in ports)
    errors, sinks = [], {}

    def run(proc):
        try:
            env = StreamExecutionEnvironment(parallelism=1)
            env.set_distributed(DistributedConfig(proc, 2, peers, connect_timeout_s=10.0))
            env.configure(sanitize=True, sanitize_log_path=hb, shm_channels=proc == 0)
            env.enable_checkpointing(str(tmp_path / "chk"), every_n_records=16)
            sinks[proc] = (env.from_collection(list(range(64)), parallelism=1)
                           .rebalance()
                           .map(Tag(), name="tag", parallelism=2)
                           .sink_to_list())
            env.execute("cohort", timeout=60)
        except BaseException as exc:  # noqa: BLE001 - asserted below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(90)
    assert not errors, errors
    docs = [load_hb_log(str(tmp_path / f"hb.proc{i}.json")) for i in range(2)]
    assert [d["cohort"]["process_index"] for d in docs] == [0, 1]
    report = pstitch.stitch(copy.deepcopy(docs))
    assert report == jstitch.stitch(copy.deepcopy(docs))
    assert report["violations"] == [] and report["local_violations"] == []
    kinds = {row[0] for doc in docs for row in doc["events"]}
    assert {"frame.send", "frame.recv", "frame.deliver", "epoch.handshake",
            "credit.grant", "credit.spend"} <= kinds
    paired = [e for e, agg in report["edges"].items() if agg.get("wire_latency_s")]
    assert paired


def test_a_blocked_remote_channel_parks_in_the_port_and_not_in_the_reference():
    """The root of the reference's false ``dist-barrier-blocked-channel``:
    its gate takes a remote route's frames into a channel blocked for
    alignment (and stashes them), so the route logs a delivery the
    stitcher counts as a violation.  The port's gate takes none; the frames
    wait in the route until the alignment ends."""
    from flink_tensorflow_tpu.core import channels as jch
    from flink_tensorflow_tpu.core import elements as jel
    from flink_tensorflow_tpu.core.sanitizer_rt import ConcurrencySanitizer as JSan
    from flink_tensorflow_tpu_torch.core import channels as pch
    from flink_tensorflow_tpu_torch.core import elements as pel

    taken = {}
    for name, ch, elm, san in (("jax", jch, jel, JSan("t")),
                               ("torch", pch, pel, ConcurrencySanitizer("t"))):
        gate = ch.InputGate(2, sanitizer=san, name="g")
        woken = []
        gate.add_space_listener(lambda: woken.append(1))
        gate.block_channel(1)
        taken[name] = gate.try_put_batch(1, [elm.StreamRecord(7, None)])
        gate.unblock_all()
        if name == "torch":
            assert woken, "unblock_all must resume the parked route"
            assert gate.try_put_batch(1, [elm.StreamRecord(7, None)]) == 1
            assert gate.poll(timeout=1.0)[1].value == 7
        assert san.violations == []
    assert taken == {"jax": 1, "torch": 0}


# -- the command line -------------------------------------------------------------------

def _write(tmp_path, docs):
    paths = []
    for i, doc in enumerate(docs):
        p = tmp_path / f"hb.proc{i}.json"
        p.write_text(json.dumps(doc))
        paths.append(str(p))
    return paths


def test_main_exits_zero_one_and_two(tmp_path, capsys):
    clean = _write(tmp_path, _cohort("healthy"))
    out = str(tmp_path / "report.json")
    assert pstitch.main([*clean, "--cohort", "--out", out]) == 0
    assert "conformant" in capsys.readouterr().out
    assert pstitch.load_report(out)["violations"] == []
    bad_dir = tmp_path / "bad"
    bad_dir.mkdir()
    bad = _write(bad_dir, _cohort("dropped_fence"))
    assert pstitch.main([*bad, "--cohort"]) == 1
    printed = capsys.readouterr().out
    assert "dist-epoch-fence" in printed and EDGE in printed
    local_dir = tmp_path / "local"
    local_dir.mkdir()
    assert pstitch.main(_write(local_dir, _cohort("local_violation"))) == 1
    unreadable = tmp_path / "unreadable.json"
    unreadable.write_text("{}")
    assert pstitch.main([str(unreadable)]) == 2


def test_python_dash_m_entry(tmp_path):
    paths = _write(tmp_path, _cohort("healthy"))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    proc = subprocess.run([sys.executable, "-m", "flink_tensorflow_tpu_torch.core.sanitizer_stitch",
                           *paths], env=env, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["violations"] == 0 and last["processes"] == 2
    assert np.isfinite(last["events"])
