"""The port's roofline plane and cost-table data classes held to the JAX
package's (``flink_tensorflow_tpu/metrics/roofline.py``,
``analysis/costmodel.py:95-192``): the same CostTable JSON, the
``cpu-test`` spec and the same ``observe`` sequence on the same clock give
equal gauges, ``rows_from_trace``, ``drift_findings`` and
``roofline_report``, all held exactly.  ``RooflineConfig`` raises on the
same bad inputs.  The port's presets hold ``h100-sxm`` and ``cpu-test``
only, and a traced serving run on the CPU logs one compile event per
distinct prefill and step signature."""

import json

import numpy as np
import pytest

from flink_tensorflow_tpu.analysis import costmodel as jcost
from flink_tensorflow_tpu.metrics import registry as jregistry
from flink_tensorflow_tpu.metrics import roofline as jroof
from flink_tensorflow_tpu.tracing import flight as jflight
from flink_tensorflow_tpu_torch.analysis import costmodel
from flink_tensorflow_tpu_torch.metrics import registry, roofline
from flink_tensorflow_tpu_torch.tracing import flight, tracer


def _table_json():
    rng = np.random.RandomState(8)
    ops = []
    for node, kind in (("serve", "serving"), ("lenet", "model")):
        entries = []
        if kind == "serving":
            for b, t in ((1, 8), (2, 8), (4, 16)):
                entries.append({"unit": "prefill", "signature": f"prefill:{b}x{t}",
                                "flops": int(rng.randint(1e6, 1e9)),
                                "hbm_bytes": int(rng.randint(1e4, 1e7)),
                                "h2d_bytes": b * t * 4 + b * 8, "d2h_bytes": b * 4})
            entries.append({"unit": "decode_step", "signature": "decode:4",
                            "flops": 1000000, "hbm_bytes": 500000, "h2d_bytes": 36,
                            "d2h_bytes": 16})
            entries.append({"unit": "cache_move", "signature": "cache:block",
                            "h2d_bytes": 4096, "d2h_bytes": 4096})
            sigs = ["prefill:1x8", "prefill:2x8", "prefill:4x16", "decode:4"]
        else:
            entries.append({"unit": "serve", "signature": "b32", "flops": 123456789,
                            "hbm_bytes": 9876543, "h2d_bytes": 100352})
            sigs = ["b32"]
        ops.append({"node": node, "kind": kind, "entries": entries,
                    "predicted_signatures": sigs, "notes": ["synthetic"]})
    return {"kind": "flink-tpu-cost-table", "mesh_axes": {"data": 1}, "operators": ops}


def test_cost_tables_round_trip_equal_to_jax():
    doc = _table_json()
    mine, theirs = costmodel.CostTable.from_json(doc), jcost.CostTable.from_json(doc)
    assert mine.to_json() == theirs.to_json() == json.loads(json.dumps(mine.to_json()))
    assert mine.op("serve").entry("prefill", "prefill:2x8").to_json() == \
        theirs.op("serve").entry("prefill", "prefill:2x8").to_json()
    assert mine.op("serve").entry("prefill") is theirs.op("serve").entry("prefill") is None
    assert mine.op("missing") is None
    with pytest.raises(ValueError):
        costmodel.CostTable.from_json({"kind": "other"})
    for kind, b, t in (("prefill", 4, 16), ("decode", 8, 0)):
        assert costmodel.serving_signature(kind, b, t) == jcost.serving_signature(kind, b, t)


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _observe(mod, reg_mod, cost_mod, flight_mod, clock):
    table = cost_mod.CostTable.from_json(_table_json())
    rec = flight_mod.FlightRecorder()
    plane = mod.RooflinePlane(mod.RooflineConfig(device="cpu-test", cost_table=table),
                              flight=rec)
    reg = reg_mod.MetricRegistry(seed=0)
    probe = plane.probe("serve", metrics=reg.group("serve.0"))
    rng = np.random.RandomState(4)
    probe.begin_warmup()
    probe.observe("prefill", 0.5, signature="prefill:1x8", h2d_bytes=40)
    probe.end_warmup()
    sigs = ["prefill:1x8", "prefill:2x8", "prefill:4x16", "prefill:8x32", "decode:4"]
    for i in range(40):
        clock.t += float(rng.rand()) * 0.01
        sig = sigs[rng.randint(len(sigs))]
        unit = "decode_step" if sig.startswith("decode") else "prefill"
        probe.observe(unit, float(rng.rand()) * 1e-3, signature=sig,
                      h2d_bytes=int(rng.randint(30, 300)), d2h_bytes=16)
        if i % 7 == 0:
            probe.observe_transfer("cache_move", 1e-4, signature="cache:block",
                                   d2h_bytes=4096 if i % 2 else 0,
                                   h2d_bytes=0 if i % 2 else 4000)
    clock.t += 0.25
    return probe, reg.snapshot()["serve.0"], rec.events()


def test_observe_sequences_give_jax_gauges(monkeypatch):
    # Both modules read the one ``time`` module: one fake clock, rewound
    # between the two runs.
    clock = _Clock()
    monkeypatch.setattr(roofline.time, "monotonic", clock)
    mine, mine_snap, mine_flight = _observe(roofline, registry, costmodel, flight, clock)
    clock.t = 100.0
    theirs, their_snap, their_flight = _observe(jroof, jregistry, jcost, jflight, clock)
    assert mine_snap == their_snap
    assert mine_snap["roofline.compile_events"] == 5
    assert mine_snap["roofline.unpredicted_compiles"] == 1     # prefill:8x32
    assert mine_snap["roofline.busy_s"] > 0
    assert [ev[5] for ev in mine_flight] == [ev[5] for ev in their_flight]
    assert {ev[5]["trigger"] for ev in mine_flight} == {"warmup", "steady-state"}
    for fn in ("flops_per_s", "mfu_pct", "membw_pct", "bound", "h2d_drift_frac",
               "measured_h2d_per_call", "predicted_h2d_per_call"):
        assert getattr(mine, fn)() == getattr(theirs, fn)()


def test_a_probe_without_a_table_is_the_fail_soft_path(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(roofline.time, "monotonic", clock)
    plane = roofline.RooflinePlane(roofline.RooflineConfig())
    assert plane.spec.name == "h100-sxm"
    reg = registry.MetricRegistry()
    probe = plane.probe("serve", metrics=reg.group("serve.0"))
    for sig in ("prefill:1x8", "prefill:1x8", "decode:4", "decode:4"):
        clock.t += 0.01
        probe.observe("prefill", 0.002, signature=sig, h2d_bytes=40)
    snap = reg.snapshot()["serve.0"]
    assert snap["roofline.mfu_pct"] == 0.0 and snap["roofline.flops_per_s"] == 0.0
    assert snap["roofline.compile_events"] == 2
    assert snap["roofline.unpredicted_compiles"] == 0   # no ladder, no verdict
    assert snap["roofline.busy_s"] == pytest.approx(0.004)
    assert roofline.BOUND_NAMES[snap["roofline.bound"]] in ("host", "wire")


def _trace_events():
    rng = np.random.RandomState(12)
    out = []
    t = 5.0
    for _ in range(50):
        t += float(rng.rand()) * 1e-2
        k = rng.randint(5)
        if k == 0:
            b, tt = [(1, 8), (2, 8), (4, 16)][rng.randint(3)]
            out.append(("serve.0", "decode.prefill", "X", t, 1e-3, {"batch": b, "bucket": [b, tt]}))
        elif k == 1:
            out.append(("serve.0", "decode.step", "X", t, 2e-4, {"active": 3}))
        elif k == 2:
            out.append(("serve.0", "cache.d2h", "X", t, 1e-4, {"bytes": 4096}))
        elif k == 3:
            out.append(("lenet.0", "compute", "X", t, 3e-3, {"batch": 32}))
        else:
            out.append(("lenet.0", "h2d", "X", t, 1e-3, {"bytes": 100352, "batch": 32}))
    return out


def test_trace_rows_findings_and_reports_equal_jax():
    events = _trace_events()
    mtab = costmodel.CostTable.from_json(_table_json())
    jtab = jcost.CostTable.from_json(_table_json())
    mspec, jspec = roofline.DeviceSpec.resolve("cpu-test"), jroof.DeviceSpec.resolve("cpu-test")
    assert mspec.to_json() == jspec.to_json()
    rows = roofline.rows_from_trace(events, mtab, mspec)
    assert rows == jroof.rows_from_trace(events, jtab, jspec)
    assert len(rows) == 2
    for tol in (0.01, 0.25):
        assert roofline.drift_findings(rows, h2d_tolerance=tol, mfu_ceiling_pct=1e-3) == \
            jroof.drift_findings(rows, h2d_tolerance=tol, mfu_ceiling_pct=1e-3)
    rep = roofline.roofline_report(events=events, cost_table=mtab, device="cpu-test", top=1)
    assert rep == jroof.roofline_report(events=events, cost_table=jtab, device="cpu-test",
                                        top=1)
    assert roofline.format_report(rep) == jroof.format_report(rep)
    snap = {"serve.0": {"roofline.busy_s": 1.5, "roofline.flops_per_s": 2e8,
                        "roofline.hbm_bytes_per_s": 5e8, "roofline.bound": 2,
                        "roofline.h2d_drift_frac": 0.5, "roofline.predicted_h2d_per_call": 10.0,
                        "roofline.measured_h2d_per_call": 15.0,
                        "roofline.unpredicted_compiles": 2}, "other": 3}
    assert roofline.roofline_report(snap, device="cpu-test") == \
        jroof.roofline_report(snap, device="cpu-test")


@pytest.mark.parametrize("kwargs", [
    dict(h2d_tolerance=0), dict(mfu_ceiling_pct=-1.0), dict(host_duty_threshold=1.0),
    dict(host_duty_threshold=-0.1), dict(device="no-such-card"),
])
def test_roofline_config_raises_on_the_same_bad_inputs(kwargs):
    with pytest.raises(ValueError):
        roofline.RooflineConfig(**kwargs).validate()
    with pytest.raises(ValueError):
        jroof.RooflineConfig(**kwargs).validate()


def test_presets_are_the_h100_datasheet_and_cpu_test():
    assert sorted(roofline.DEVICE_SPECS) == ["cpu-test", "h100-sxm"]
    h100 = roofline.DEVICE_SPECS["h100-sxm"]
    assert (h100.peak_flops_per_s, h100.peak_hbm_bytes_per_s, h100.peak_h2d_bytes_per_s) == \
        (989.4e12, 3.35e12, 64e9)
    assert roofline.RooflineConfig().validate().resolved_device() is h100
    assert roofline.DEVICE_SPECS["cpu-test"].to_json() == jroof.DEVICE_SPECS["cpu-test"].to_json()


def test_cli_joins_a_trace_and_a_table(tmp_path, capsys):
    tr = tracer.Tracer()
    for ev in _trace_events():
        tr.span(ev[0], ev[1], ev[3], ev[3] + ev[4], args=ev[5])
    trace_path = tr.export(str(tmp_path / "t.json"))
    table_path = tmp_path / "table.json"
    table_path.write_text(json.dumps(_table_json()))
    code = roofline.main(["--trace", trace_path, "--cost-table", str(table_path),
                          "--device", "cpu-test", "--json"])
    out = capsys.readouterr().out
    report = json.loads(out.strip().splitlines()[-1])
    assert code == (1 if report["findings"] else 0)
    assert {r["operator"] for r in report["rows"]} == {"serve", "lenet"}
    assert roofline.main(["--snapshot", str(tmp_path / "missing.json")]) == 2


def test_serving_on_the_cpu_logs_one_compile_event_per_signature():
    """The dense serving job under ``RooflineConfig``: every distinct
    prefill bucket and the step signature is one compile event (its
    warmup first sight), busy time accrues, and the plan priced at
    ``execute_async`` (no table was given) gives the MFU gauge a reading,
    with every signature met inside the predicted ladder."""
    from flink_tensorflow_tpu_torch import StreamExecutionEnvironment
    from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
    from flink_tensorflow_tpu_torch.serving import (
        GenerateRequest,
        ServingConfig,
        continuous_batching,
    )

    cfg = dict(vocab_size=48, embed_dim=32, num_heads=2, num_layers=2, capacity=40)
    mdef = get_model_def("char_transformer", **cfg)
    model = mdef.to_model(mdef.init_params(0))
    rng = np.random.RandomState(4)
    reqs = [GenerateRequest(session_id=f"s{i}", prompt=rng.randint(1, 48, (int(rng.randint(4, 10)),)),
                            max_new_tokens=5) for i in range(7)]
    env = StreamExecutionEnvironment().configure(
        trace=True, roofline=roofline.RooflineConfig(device="h100-sxm"))
    env.set_device_provider(lambda task, index: "cpu")
    scfg = ServingConfig(max_active_seqs=3, token_budget=80, capacity=40)
    continuous_batching(env.from_collection(reqs).key_by(lambda r: r.session_id), model,
                        config=scfg).sink_to_list()
    handle = env.execute_async("serve")
    handle.wait(300)
    snap = env.metric_registry.snapshot()["continuous_batching.0"]
    events = handle.executor.tracer.events()
    prefill_sigs = {f"prefill:{e[5]['bucket'][0]}x{e[5]['bucket'][1]}"
                    for e in events if e[1] == "decode.prefill"}
    compiles = [e for e in events if e[0] == "compile.events"]
    seen = {e[5]["signature"] for e in compiles}
    assert prefill_sigs <= seen
    assert seen - prefill_sigs == {"decode:3"}     # the pool's [S] step
    assert snap["roofline.compile_events"] == len(compiles) == len(seen)
    assert snap["roofline.busy_s"] > 0 and snap["roofline.mfu_pct"] > 0.0
    assert snap["roofline.unpredicted_compiles"] == 0
