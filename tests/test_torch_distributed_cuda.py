"""The record plane with models on the card (``cuda``-marked; they skip
without an NVIDIA GPU).  This file imports neither flax nor the JAX
package, so it collects on a machine that has neither.

- A two-process keyed job whose subtasks train Wide&Deep on ``cuda:0``
  (``functions/train_cell.py --widedeep``, both processes sharing the
  card) commits what the same job in one process commits, bit for bit.
- A tensor on the card written to a remote channel arrives as a CPU
  tensor with the same values (its host bytes cross, as a pickled
  ``jax.Array``'s do); the receiver touches no device.
"""

import os
import subprocess
import sys

import pytest
import torch

from flink_tensorflow_tpu_torch.core import elements as el
from flink_tensorflow_tpu_torch.core.channels import InputGate
from flink_tensorflow_tpu_torch.core.shuffle import RemoteChannelWriter, ShuffleServer
from flink_tensorflow_tpu_torch.functions import train_cell
from flink_tensorflow_tpu_torch.io.files import read_committed

from _torch_ports import free_ports

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _steps(out):
    return sorted((int(r.meta["key"]), int(r["step"]), float(r["loss"]))
                  for r in read_committed(out))


@pytest.mark.cuda
def test_two_process_keyed_training_on_the_card_equals_one_process(tmp_path):
    needs_cuda()
    records, every = 1024, 256
    mdef, schema, values = train_cell.widedeep_cell(records=records)
    base = str(tmp_path / "base")
    train_cell.run_widedeep_cohort(mdef, schema, values, None, out=base,
                                   checkpoint_root=str(tmp_path / "chk1"),
                                   every_n_records=every, parallelism=2,
                                   device_provider=lambda task, index: "cuda:0")
    out, chk = str(tmp_path / "out"), str(tmp_path / "chk")
    ports = free_ports(2)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "flink_tensorflow_tpu_torch.functions.train_cell", "--widedeep",
         "--rank", str(r), "--world", "2", "--plane-ports", ",".join(map(str, ports)),
         "--out", out, "--checkpoint-root", chk, "--par", "2", "--records", str(records),
         "--every", str(every)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    for p in procs:
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, log.decode(errors="replace")
    want = _steps(base)
    assert len(want) == train_cell.expected_steps(values)
    assert _steps(out) == want


@pytest.mark.cuda
def test_a_card_tensor_crosses_as_a_host_tensor():
    needs_cuda()
    gate = InputGate(1, capacity=4)
    server = ShuffleServer("127.0.0.1")
    server.register_gate("t", 0, gate)
    server.start()
    writer = RemoteChannelWriter("127.0.0.1", server.port, "t", 0, 0, flush_bytes=0)
    sent = {"a": torch.randn(5, 3, device="cuda"),
            "b": torch.arange(8, device="cuda", dtype=torch.int64)}
    try:
        writer.write(el.StreamRecord(sent))
        _, got = gate.poll(timeout=30.0)
    finally:
        writer.close()
        server.close()
    for name, t in sent.items():
        assert got.value[name].device.type == "cpu"
        assert torch.equal(got.value[name], t.cpu())
