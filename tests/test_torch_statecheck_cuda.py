"""Statecheck's refusal of state held on the card (``cuda``-marked; it skips
without an NVIDIA GPU).  This file imports neither flax nor the JAX
package, so it collects on a machine that has neither.

A keyed process function that accumulates into a ``cuda:0`` tensor held in
a closure keeps state no checkpoint barrier sees: ``execute(validate=
True)`` refuses the plan on ``statecheck-hidden-state`` ERROR, naming the
tensor and its device, before a record is processed.
"""

import pytest
import torch

from flink_tensorflow_tpu_torch import ProcessFunction, StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.analysis import PlanValidationError

pytestmark = pytest.mark.cuda


def test_a_closure_over_a_card_tensor_is_refused_before_any_record():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    totals = torch.zeros(4, device="cuda:0")
    processed = []

    class Accumulate(ProcessFunction):
        def process_element(self, value, ctx, out):
            processed.append(value)
            totals[ctx.current_key] += value
            out.collect(value)

    env = StreamExecutionEnvironment(parallelism=1)
    (env.from_collection(list(range(16))).key_by(lambda x: x % 4)
        .process(Accumulate(), name="accumulate").sink_to_list())
    with pytest.raises(PlanValidationError) as info:
        env.execute("hidden-card-state", validate=True, timeout=60)
    (d,) = [d for d in info.value.diagnostics
            if d.rule == "statecheck-hidden-state" and d.severity.name == "ERROR"]
    assert d.node == "accumulate"
    assert "'totals'" in d.message and "cuda:0" in d.message
    assert processed == [] and float(totals.sum()) == 0.0
