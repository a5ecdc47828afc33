"""The serving bench's open-loop arms (``serving/cell.py:open_loop_arm``)
on the CPU, at a small size: 10 of the serving cell's sessions at 400
requests/s through ``PacedSplitSource -> key_by -> continuous_batching``
and ``PacedSplitSource -> count_window(8, timeout_s=0.3) ->
FixedWindowGenerateFunction``.  Each session's tokens must equal those of
:func:`serving.cell.serve` on the same weights (greedy decoding: the
scheduling policy changes when a token comes, never which).  The fixed
arm's timer-driven window fuses into the split source's chain, and every
token carries its request's scheduled arrival.
"""

import pytest

from flink_tensorflow_tpu_torch.serving.cell import (
    OPEN_LOOP_RATES,
    SERVING_COUNTERS,
    open_loop_arm,
    serve,
    serving_cell,
)

SESSIONS = 10


@pytest.fixture(scope="module")
def cell():
    mdef, tree, cfg, requests = serving_cell(0)
    model = mdef.to_model(tree)
    requests = requests[:SESSIONS]
    events, _, _ = serve(model, cfg, requests, "cpu")
    want = {}
    for ev in events:
        want.setdefault(ev.session_id, []).append(ev.token)
    return model, cfg, requests, want


@pytest.mark.parametrize("arm", ["fixed", "continuous"])
def test_open_loop_arm_serves_every_session_with_serves_tokens(cell, arm):
    model, cfg, requests, want = cell
    run = open_loop_arm(model, cfg, requests, arm, OPEN_LOOP_RATES[0], device="cpu")
    got = {}
    for _, ev in run.events:
        got.setdefault(ev.session_id, []).append(ev.token)
    assert got == want
    row = run.row
    tokens = sum(r.max_new_tokens for r in requests)
    assert (row["arm"], row["offered_rate_rps"]) == (arm, OPEN_LOOP_RATES[0])
    assert (row["sessions"], row["tokens"]) == (SESSIONS, tokens)
    assert row["tokens_per_s"] > 0
    assert 0 < row["ttft_p50_ms"] <= row["ttft_p95_ms"]
    assert 0 < row["token_p50_ms"] <= row["token_p95_ms"]
    # Every token carries its request's scheduled arrival, and comes after it.
    assert all(t_emit >= ev.meta["sched_ts"] - 1e-3 for t_emit, ev in run.events)
    if arm == "continuous":
        assert row["admitted"] == row["evicted"] == SESSIONS
        assert row["rejected"] == 0 and row["serving_steps"] > 0
        assert set(SERVING_COUNTERS) <= set(row)
        assert "sessions -> " not in run.env.describe()
    else:
        assert "admitted" not in row
        assert "sessions -> fixed_window_generate -> sink" in run.env.describe()


def test_open_loop_arm_rejects_an_unknown_arm(cell):
    model, cfg, requests, _ = cell
    with pytest.raises(ValueError):
        open_loop_arm(model, cfg, requests, "static", 400.0, device="cpu")
