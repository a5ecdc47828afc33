"""The port stands alone: it runs with ``import jax`` broken and loads no
module of the JAX package, and it never falls back to the CPU silently."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SLICE = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None          # any "import jax" now raises ImportError
    import numpy as np
    from flink_tensorflow_tpu_torch.core.runtime import KeyedSubtask
    from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
    from flink_tensorflow_tpu_torch.serving import (
        ContinuousBatchingOperator, GenerateRequest, ServingConfig)

    mdef = get_model_def("char_transformer", vocab_size=32, embed_dim=32,
                         num_heads=2, num_layers=2, capacity=32)
    model = mdef.to_model(mdef.init_params(0))
    rng = np.random.RandomState(0)
    reqs = [GenerateRequest(session_id=i, prompt=rng.randint(1, 32, (5,)),
                            max_new_tokens=6) for i in range(4)]
    op = ContinuousBatchingOperator("cb", model, ServingConfig(
        max_active_seqs=2, token_budget=64, capacity=32, warmup_compile=True),
        device="cpu")
    events = KeyedSubtask(op).run(reqs)
    assert len([e for e in events if e.finished]) == 4
    leaked = sorted(m for m in sys.modules
                    if m == "flink_tensorflow_tpu" or m.startswith("flink_tensorflow_tpu."))
    print("LEAKED", leaked)
    assert not leaked, leaked
    print("OK")
""")


def test_cpu_slice_runs_without_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _SLICE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "OK" in proc.stdout


def test_no_device_means_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    from flink_tensorflow_tpu_torch.functions.runner import DecodeStepRunner
    from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
    from flink_tensorflow_tpu_torch.serving import ContinuousBatchingOperator

    mdef = get_model_def("char_transformer", vocab_size=16, embed_dim=16,
                         num_heads=1, num_layers=1, capacity=16)
    model = mdef.to_model(mdef.init_params(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecodeStepRunner(model, pool_slots=2, capacity=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousBatchingOperator("cb", model)
