"""The port's health plane, autoscale loop and doctor held to the JAX
package's (``flink_tensorflow_tpu/{metrics/health,core/autoscale,
tracing/doctor}.py``) on the same inputs.

Twins of every class of ``tests/test_health.py``: each case feeds the same
seeded synthetic snapshot sequence (or the same evidence) through both
packages and requires equal results: transitions, gauges and ``health()``
views, the default catalogue, the actuator's decisions on a fake clock,
the supervisor's respawns over the same stub commands, and the doctor's
findings and JSON line.  Then the case's own assertions run on the
port's result.  The two-process soak (``-m slow``) drives the port's
``AutoscaleSupervisor`` over ``tests/_torch_autoscale_worker.py``.  The
last cases run the plane inside port jobs through ``JobConfig.health``.
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np
import pytest

from flink_tensorflow_tpu.core import autoscale as jautoscale
from flink_tensorflow_tpu.metrics import health as jhealth
from flink_tensorflow_tpu.metrics.registry import MetricRegistry as JaxRegistry
from flink_tensorflow_tpu.tracing import doctor as jdoctor
from flink_tensorflow_tpu.tracing.flight import FlightRecorder as JaxFlight
from flink_tensorflow_tpu_torch import StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.core import autoscale
from flink_tensorflow_tpu_torch.core.autoscale import (
    RESCALE_EXIT_CODE,
    AutoscaleConfig,
    AutoscaleDecision,
    AutoscaleSupervisor,
    read_decision,
    write_decision,
)
from flink_tensorflow_tpu_torch.metrics import health
from flink_tensorflow_tpu_torch.metrics.health import (
    BREACH,
    OK,
    WARN,
    HealthConfig,
    HealthEvaluator,
    SloRule,
    default_rules,
)
from flink_tensorflow_tpu_torch.metrics.registry import MetricRegistry
from flink_tensorflow_tpu_torch.tracing import doctor
from flink_tensorflow_tpu_torch.tracing.flight import FlightRecorder

sys.path.insert(0, os.path.dirname(__file__))
from _torch_ports import free_ports  # noqa: E402

#: Each package's modules, so a case runs the same body through both.
PKGS = {
    "jax": dict(health=jhealth, autoscale=jautoscale, doctor=jdoctor,
                registry=JaxRegistry, flight=JaxFlight),
    "port": dict(health=health, autoscale=autoscale, doctor=doctor,
                 registry=MetricRegistry, flight=FlightRecorder),
}


def edge_rule(h):
    return h.SloRule("edge-queue", "edge*_queue_depth", warn=4.0, breach=6.0,
                     sustain=2, clear_after=2, action="scale_up")


EDGE_RULE = edge_rule(health)


def snap(depth):
    return {"slow.0": {"edge0_src_queue_depth": float(depth)}}


def feed(evaluator, depths, t0=100.0, dt=1.0):
    fired = []
    for i, d in enumerate(depths):
        fired.extend(evaluator.evaluate_once(snap(d), now=t0 + i * dt))
    return fired


def rows(transitions):
    """Transitions as plain tuples, comparable across packages."""
    return [dataclasses.astuple(t) for t in transitions]


def twin(run):
    """``run(pkg)`` on both packages; the results must be equal.  Returns
    the port's."""
    jax_out, port_out = run(PKGS["jax"]), run(PKGS["port"])
    assert port_out == jax_out
    return port_out


def seeded_depths(seed, n=40):
    """A numpy-seeded depth sequence with runs past warn and breach."""
    rng = np.random.RandomState(seed)
    level = rng.choice([0.0, 5.0, 9.0], size=n // 4)
    return [float(x) for x in np.repeat(level, 4) + rng.rand(n) * 0.5]


# ---------------------------------------------------------------------------
# SloRule selection + validation
# ---------------------------------------------------------------------------


class TestSloRule:
    def test_validation(self):
        def run(pkg):
            Rule = pkg["health"].SloRule
            errors = []
            for kwargs in (dict(metric="", warn=1, breach=2),
                           dict(metric="m", warn=1, breach=2, cmp=">="),
                           dict(metric="m", warn=1, breach=2, sustain=0),
                           dict(metric="m", warn=2, breach=1),
                           dict(metric="m", warn=1, breach=2, field="p97"),
                           dict(metric="m", warn=1, breach=2, mode="sum")):
                with pytest.raises(ValueError) as info:
                    Rule("x", **kwargs).validate()
                errors.append(str(info.value))
            Rule("x", "m", warn=1, breach=2).validate()
            return errors
        errors = twin(run)
        for want, got in zip(("metric or expr", "cmp", "sustain", "breach threshold",
                              "field", "mode"), errors):
            assert want in got

    def test_subtasks_roll_up_to_worst(self):
        tree = {"op.0": {"queue_depth": 2.0}, "op.1": {"queue_depth": 9.0},
                "checkpoint": {"queue_depth": 99.0}}
        got = twin(lambda pkg: pkg["health"].SloRule(
            "bp", "queue_depth", warn=4, breach=6).observe(tree))
        # Job-level scopes stay out of the default "*" selector.
        assert got == {"op": 9.0}

    def test_metric_pattern_yields_per_edge_targets(self):
        tree = {"op.0": {"edge0_a_queue_depth": 3.0, "edge1_b_queue_depth": 7.0}}
        got = twin(lambda pkg: edge_rule(pkg["health"]).observe(tree))
        assert got == {"op/edge0_a_queue_depth": 3.0, "op/edge1_b_queue_depth": 7.0}

    def test_scope_and_field_selection(self):
        tree = {"checkpoint": {"duration_s": {"p95": 12.0}},
                "op.0": {"duration_s": {"p95": 50.0}}}
        got = twin(lambda pkg: pkg["health"].SloRule(
            "ckpt", "duration_s", scope="checkpoint", field="p95", warn=5,
            breach=30).observe(tree))
        assert got == {"checkpoint": 12.0}

    def test_expr_scalar_lands_on_job(self):
        got = twin(lambda pkg: pkg["health"].SloRule(
            "free", "", warn=1, breach=2, expr=lambda s: len(s)).observe(
                {"a.0": {}, "b.0": {}}))
        assert got == {"job": 2.0}

    @pytest.mark.parametrize("capacity", [8, 100, 1024])
    def test_default_catalogue_validates_and_scales(self, capacity):
        def run(pkg):
            rules = pkg["health"].default_rules(channel_capacity=capacity)
            for r in rules:
                r.validate()
            return [tuple((f.name, getattr(r, f.name)) for f in dataclasses.fields(r))
                    for r in rules]
        got = twin(run)
        assert len(got) == 17
        by_id = {r.id: r for r in default_rules(channel_capacity=capacity)}
        assert by_id["edge-queue"].warn == 0.5 * capacity
        assert by_id["edge-queue"].breach == 0.9 * capacity


# ---------------------------------------------------------------------------
# hysteresis: sustained vs flapping
# ---------------------------------------------------------------------------


def _feed_rows(depth_runs):
    """Transitions and job state of one evaluator fed ``depth_runs``
    (``[(depths, t0), ...]``), per package."""
    def run(pkg):
        ev = pkg["health"].HealthEvaluator([edge_rule(pkg["health"])])
        fired = []
        for depths, t0 in depth_runs:
            fired.extend(feed(ev, depths, t0=t0))
        return rows(fired), ev.job_state()
    return twin(run)


class TestHysteresis:
    def test_sustained_breach_escalates_after_sustain(self):
        fired, job = _feed_rows([([9, 9], 100.0)])
        assert [(t[2], t[3]) for t in fired] == [(OK, BREACH)]
        assert job == BREACH

    def test_warn_band_escalates_to_warn_only(self):
        fired, _ = _feed_rows([([5, 5, 5, 5], 100.0)])
        assert [(t[2], t[3]) for t in fired] == [(OK, WARN)]

    def test_flapping_never_transitions(self):
        fired, job = _feed_rows([([9, 0] * 10, 100.0)])
        assert fired == [] and job == OK

    def test_flapping_cannot_deescalate_a_breach_either(self):
        fired, job = _feed_rows([([9, 9], 100.0), ([0, 9] * 10, 200.0)])
        assert [(t[2], t[3]) for t in fired] == [(OK, BREACH)]
        assert job == BREACH

    def test_deescalation_steps_one_level_per_clear_window(self):
        fired, _ = _feed_rows([([9, 9], 100.0), ([0, 0, 0, 0], 200.0)])
        assert [(t[2], t[3]) for t in fired] == [(OK, BREACH), (BREACH, WARN), (WARN, OK)]

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_seeded_sequences_give_the_same_transitions(self, seed):
        fired, _ = _feed_rows([(seeded_depths(seed), 100.0)])
        assert all(t[0] == "edge-queue" for t in fired)

    def test_rate_mode_differentiates_and_skips_first_sight(self):
        def run(pkg):
            rule = pkg["health"].SloRule("bp", "backpressure_s", warn=0.5, breach=0.85,
                                         mode="rate", sustain=2, action="scale_up")
            ev = pkg["health"].HealthEvaluator([rule])
            fired = []
            for i, raw in enumerate([0.0, 0.9, 1.8, 2.7]):
                fired.extend(ev.evaluate_once({"op.0": {"backpressure_s": raw}},
                                              now=100.0 + i))
            return rows(fired)
        fired = twin(run)
        assert [(t[2], t[3]) for t in fired] == [(OK, BREACH)]
        assert fired[0][4] == pytest.approx(0.9)

    def test_transitions_carry_rule_action(self):
        def run(pkg):
            (t,) = feed(pkg["health"].HealthEvaluator([edge_rule(pkg["health"])]), [9, 9])
            return t.action, t.describe()
        action, text = twin(run)
        assert action == "scale_up"
        assert "edge-queue" in text


# ---------------------------------------------------------------------------
# credit-starvation SLO (flow-control plane)
# ---------------------------------------------------------------------------


def _catalogue_rule(pkg, rule_id):
    return {r.id: r for r in pkg["health"].default_rules()}[rule_id]


def _rate_run(rule_ids, scopes, raws):
    """Transitions of the catalogue's ``rule_ids`` over cumulative ``raws``
    published under every scope of ``scopes`` (``{scope: metric}``)."""
    def run(pkg):
        ev = pkg["health"].HealthEvaluator([_catalogue_rule(pkg, r) for r in rule_ids])
        fired = []
        for i, raw in enumerate(raws):
            fired.extend(ev.evaluate_once(
                {scope: {metric: raw} for scope, metric in scopes.items()}, now=100.0 + i))
        return rows(fired)
    return twin(run)


class TestCreditStarvationRule:
    def test_catalogue_carries_both_scope_families(self):
        def run(pkg):
            return [(r.mode, r.action, r.scope) for r in
                    (_catalogue_rule(pkg, "credit-starvation"),
                     _catalogue_rule(pkg, "credit-starvation-shuffle"))]
        assert twin(run) == [("rate", "scale_up", "*"), ("rate", "scale_up", "shuffle.out.*")]

    def test_operator_scope_starved_clock_breaches_on_rate(self):
        fired = _rate_run(["credit-starvation"], {"rsink.0": "edge.credit_starved_s"},
                          [0.0, 0.9, 1.8, 2.7])
        assert [(t[2], t[3]) for t in fired] == [(OK, BREACH)]
        assert fired[0][6] == "scale_up"
        assert fired[0][4] == pytest.approx(0.9)

    def test_shuffle_scope_starved_clock_breaches_on_rate(self):
        fired = _rate_run(["credit-starvation-shuffle"],
                          {"shuffle.out.op.0.ch0": "credit_starved_s"}, [0.0, 0.9, 1.8, 2.7])
        assert [(t[2], t[3]) for t in fired] == [(OK, BREACH)]

    def test_briefly_parked_edge_stays_ok(self):
        fired = _rate_run(["credit-starvation", "credit-starvation-shuffle"],
                          {"rsink.0": "edge.credit_starved_s",
                           "shuffle.out.op.0.ch0": "credit_starved_s"},
                          [0.0, 0.1, 0.2, 0.3, 0.4])
        assert fired == []


# ---------------------------------------------------------------------------
# paged KV economy SLOs: pool pressure + tier thrash
# ---------------------------------------------------------------------------


class TestKvEconomyRules:
    def test_catalogue_carries_both_kv_rules(self):
        got = twin(lambda pkg: (_catalogue_rule(pkg, "kv-pool-pressure").action,
                                _catalogue_rule(pkg, "kv-tier-thrash").mode))
        assert got == ("scale_up", "rate")

    def test_pool_pressure_breaches_on_sustained_occupancy(self):
        def run(pkg):
            ev = pkg["health"].HealthEvaluator([_catalogue_rule(pkg, "kv-pool-pressure")])
            fired = []
            for i, pct in enumerate([96.0, 97.0]):
                fired.extend(ev.evaluate_once({"serve.0": {"kv_page_occupancy_pct": pct}},
                                              now=100.0 + i))
            return rows(fired)
        fired = twin(run)
        assert [(t[2], t[3]) for t in fired] == [(OK, BREACH)]
        assert fired[0][6] == "scale_up"

    def test_pool_pressure_warn_band(self):
        def run(pkg):
            ev = pkg["health"].HealthEvaluator([_catalogue_rule(pkg, "kv-pool-pressure")])
            fired = []
            for i in range(4):
                fired.extend(ev.evaluate_once({"serve.0": {"kv_page_occupancy_pct": 88.0}},
                                              now=100.0 + i))
            return rows(fired)
        assert [(t[2], t[3]) for t in twin(run)] == [(OK, WARN)]

    def test_tier_thrash_rates_the_cumulative_move_counter(self):
        fired = _rate_run(["kv-tier-thrash"], {"serve.0": "kv_tier_moves"},
                          [0.0, 60.0, 120.0, 180.0])
        assert [(t[2], t[3]) for t in fired] == [(OK, BREACH)]
        assert fired[0][4] == pytest.approx(60.0)

    def test_slow_tier_movement_stays_ok(self):
        assert _rate_run(["kv-tier-thrash"], {"serve.0": "kv_tier_moves"},
                         [0.0, 2.0, 4.0, 6.0]) == []

    def test_dense_plan_without_kv_metrics_never_fires(self):
        def run(pkg):
            ev = pkg["health"].HealthEvaluator([_catalogue_rule(pkg, "kv-pool-pressure"),
                                                _catalogue_rule(pkg, "kv-tier-thrash")])
            fired = []
            for i in range(3):
                fired.extend(ev.evaluate_once({"serve.0": {"active_seqs": 4.0}},
                                              now=100.0 + i))
            return rows(fired)
        assert twin(run) == []


# ---------------------------------------------------------------------------
# evaluator publication: gauges, flight, rollups
# ---------------------------------------------------------------------------


def _published(depth_runs, rules=None):
    """The ``health`` scope of each package's registry after feeding."""
    def run(pkg):
        reg = pkg["registry"]()
        ev = pkg["health"].HealthEvaluator(rules(pkg) if rules else [edge_rule(pkg["health"])],
                                           registry=reg)
        for depths, t0 in depth_runs:
            feed(ev, depths, t0=t0)
        return reg.snapshot()["health"]
    return twin(run)


class TestEvaluatorPublication:
    def test_health_gauges_land_in_registry(self):
        got = _published([([9, 9], 100.0)])
        assert got["slow"] == BREACH and got["job"] == BREACH

    def test_gauges_track_deescalation(self):
        assert _published([([9, 9], 100.0), ([0, 0, 0, 0], 200.0)])["slow"] == OK

    @pytest.mark.parametrize("seed", [4, 5])
    def test_catalogue_gauges_over_seeded_snapshots(self, seed):
        """The whole default catalogue over a seeded multi-scope sequence:
        equal gauges, views and transitions in both packages."""
        rng = np.random.RandomState(seed)
        snaps = []
        cum = 0.0
        for i in range(12):
            cum += float(rng.rand())
            snaps.append({
                "op.0": {"backpressure_s": cum, "idle_s": cum * 0.1,
                         "edge0_src_queue_depth": float(rng.randint(0, 1024)),
                         "ttft_s": {"p95": float(rng.rand() * 6)}},
                "op.1": {"kv_page_occupancy_pct": float(rng.uniform(80, 100))},
                "checkpoint": {"duration_s": {"p95": float(rng.rand() * 40)}},
                "recovery": {"restarts_total": float(i // 4)},
            })

        def run(pkg):
            reg = pkg["registry"]()
            flight = pkg["flight"]()
            ev = pkg["health"].HealthEvaluator(pkg["health"].default_rules(), registry=reg,
                                               flight=flight)
            fired = []
            for i, s in enumerate(snaps):
                fired.extend(ev.evaluate_once(s, now=50.0 + 0.5 * i))
            view = ev.health()
            return (rows(fired), reg.snapshot()["health"], view,
                    [e[1:2] + e[5:] for e in flight.events() if e[0] == "health"])
        fired, gauges, view, flights = twin(run)
        assert fired and len(flights) == len(fired)
        assert view["job"] == health.STATE_NAMES[gauges["job"]]

    def test_per_edge_targets_fold_to_operator(self):
        def run(pkg):
            ev = pkg["health"].HealthEvaluator([edge_rule(pkg["health"])])
            feed(ev, [9, 9])
            return ev.target_states(), [(r.id, t) for r, t, _v in ev.active_breaches()]
        states, breaches = twin(run)
        assert states == {"slow": BREACH}
        assert breaches == [("edge-queue", "slow/edge0_src_queue_depth")]

    def test_flight_records_every_transition(self):
        def run(pkg):
            flight = pkg["flight"]()
            feed(pkg["health"].HealthEvaluator([edge_rule(pkg["health"])], flight=flight),
                 [9, 9])
            return [e[:2] + e[5:] for e in flight.events() if e[0] == "health"]
        events = twin(run)
        assert len(events) == 1
        assert events[0][2]["to"] == "BREACH"

    def test_trace_instants_mark_every_transition(self):
        from flink_tensorflow_tpu.tracing.tracer import Tracer as JaxTracer
        from flink_tensorflow_tpu_torch.tracing.tracer import Tracer

        def run(pkg):
            tracer = (JaxTracer if pkg is PKGS["jax"] else Tracer)()
            feed(pkg["health"].HealthEvaluator([edge_rule(pkg["health"])], tracer=tracer),
                 [9, 9, 0, 0, 0, 0])
            return [(e[0], e[1], e[2], e[5]) for e in tracer.events()]
        got = twin(run)
        assert [e[1] for e in got] == ["edge-queue:slow/edge0_src_queue_depth:BREACH",
                                       "edge-queue:slow/edge0_src_queue_depth:WARN",
                                       "edge-queue:slow/edge0_src_queue_depth:OK"]

    def test_health_view_shape(self):
        def run(pkg):
            ev = pkg["health"].HealthEvaluator([edge_rule(pkg["health"])])
            feed(ev, [9, 9])
            return ev.health()
        view = twin(run)
        assert view["job"] == "BREACH"
        assert view["targets"] == {"slow": "BREACH"}
        assert view["transitions"]

    def test_listeners_fire_per_edge_and_per_tick(self):
        def run(pkg):
            ev = pkg["health"].HealthEvaluator([edge_rule(pkg["health"])])
            edges, ticks = [], []
            ev.subscribe(lambda t: edges.append(dataclasses.astuple(t)))
            ev.subscribe(lambda t: 1 / 0)  # a broken listener is contained
            ev.subscribe_ticks(lambda e: ticks.append(e.ticks))
            feed(ev, [9, 9, 9, 0, 0])
            return edges, ticks
        edges, ticks = twin(run)
        assert len(edges) == 2 and ticks == [1, 2, 3, 4, 5]

    def test_config_validation(self):
        def run(pkg):
            h, a = pkg["health"], pkg["autoscale"]
            h.HealthConfig(rules=(edge_rule(h),), autoscale=a.AutoscaleConfig()).validate()
            errors = []
            for cfg in (h.HealthConfig(interval_s=0.0),
                        h.HealthConfig(autoscale=a.AutoscaleConfig(min_workers=3,
                                                                   max_workers=2))):
                with pytest.raises(ValueError) as info:
                    cfg.validate()
                errors.append(str(info.value))
            return errors
        errors = twin(run)
        assert "interval_s" in errors[0] and "max_workers" in errors[1]

    def test_poll_thread_runs_and_stops(self):
        reg = MetricRegistry()
        ev = HealthEvaluator([EDGE_RULE], interval_s=0.02, registry=reg,
                             snapshot_fn=lambda: (time.time(), snap(9)))
        ev.start()
        try:
            deadline = time.monotonic() + 10
            while ev.job_state() != BREACH and time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            ev.stop()
        assert ev.job_state() == BREACH
        ticks = ev.ticks
        time.sleep(0.1)
        assert ev.ticks == ticks
        with pytest.raises(ValueError, match="snapshot_fn"):
            HealthEvaluator([EDGE_RULE]).start()


# ---------------------------------------------------------------------------
# actuator policy
# ---------------------------------------------------------------------------


class _Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _actuator(pkg, tmp_path, clock, *, num_workers=2, max_workers=3, cooldown_s=5.0,
              checkpoint_ready=lambda: 7):
    cfg = pkg["autoscale"].AutoscaleConfig(
        min_workers=1, max_workers=max_workers, cooldown_s=cooldown_s,
        decision_path=str(tmp_path / f"{pkg['health'].__name__}.decision.json"))
    return pkg["autoscale"].AutoscaleActuator(cfg, num_workers, clock=clock,
                                              checkpoint_ready=checkpoint_ready)


def _decision_row(act):
    """An actuator's decision without its wall-clock stamp."""
    if act.decision is None:
        return None
    d = dataclasses.asdict(act.decision)
    d.pop("ts")
    return d


class TestActuator:
    def test_cooldown_defers_then_level_trigger_decides(self, tmp_path):
        def run(pkg):
            clock = _Clock()
            act = _actuator(pkg, tmp_path, clock)
            ev = pkg["health"].HealthEvaluator([edge_rule(pkg["health"])])
            ev.subscribe_ticks(act.on_tick)
            feed(ev, [9, 9])
            first = (act.last_verdict, act.decision)
            clock.t = 6.0
            # No new transition edge: the next tick alone must decide.
            feed(ev, [9], t0=300.0)
            return first, act.last_verdict, _decision_row(act)
        first, verdict, decision = twin(run)
        assert first == ("cooldown", None)
        assert verdict == "decided"
        assert (decision["action"], decision["from_workers"], decision["to_workers"],
                decision["checkpoint_id"]) == ("scale_up", 2, 3, 7)

    def test_checkpoint_gate_blocks_until_a_checkpoint_exists(self, tmp_path):
        def run(pkg):
            cid = {"v": None}
            act = _actuator(pkg, tmp_path, _Clock(10.0), cooldown_s=0.0,
                            checkpoint_ready=lambda: cid["v"])
            ev = pkg["health"].HealthEvaluator([edge_rule(pkg["health"])])
            ev.subscribe_ticks(act.on_tick)
            feed(ev, [9, 9])
            first = act.last_verdict
            cid["v"] = 3
            feed(ev, [9], t0=300.0)
            return first, _decision_row(act)
        first, decision = twin(run)
        assert first == "no-checkpoint"
        assert decision["checkpoint_id"] == 3

    def test_checkpoint_gate_reads_the_store(self, tmp_path):
        from flink_tensorflow_tpu_torch.checkpoint.store import write_checkpoint

        probe = autoscale.checkpoint_gate(str(tmp_path / "chk"))
        assert probe() is None
        assert autoscale.checkpoint_gate(None)() is None
        write_checkpoint(str(tmp_path / "chk"), 4, {"op": {0: {}}})
        assert probe() == 4

    def test_at_bounds_never_decides(self, tmp_path):
        def run(pkg):
            act = _actuator(pkg, tmp_path, _Clock(10.0), num_workers=3, max_workers=3,
                            cooldown_s=0.0)
            ev = pkg["health"].HealthEvaluator([edge_rule(pkg["health"])])
            ev.subscribe_ticks(act.on_tick)
            feed(ev, [9, 9, 9, 9])
            return act.last_verdict, act.decision
        assert twin(run) == ("at-bounds", None)

    def test_one_decision_per_actuator_life(self, tmp_path):
        def run(pkg):
            act = _actuator(pkg, tmp_path, _Clock(10.0), cooldown_s=0.0)
            ev = pkg["health"].HealthEvaluator([edge_rule(pkg["health"])])
            ev.subscribe_ticks(act.on_tick)
            feed(ev, [9] * 10)
            return act.last_verdict, _decision_row(act)["to_workers"]
        assert twin(run) == ("decided", 3)

    def test_flapping_fixture_never_actuates(self, tmp_path):
        def run(pkg):
            act = _actuator(pkg, tmp_path, _Clock(10.0), cooldown_s=0.0)
            ev = pkg["health"].HealthEvaluator([edge_rule(pkg["health"])])
            ev.subscribe_ticks(act.on_tick)
            feed(ev, [9, 0] * 10)
            return act.last_verdict, act.decision
        assert twin(run) == ("no-breach", None)

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_seeded_sequences_give_the_same_verdicts(self, tmp_path, seed):
        depths = seeded_depths(seed)

        def run(pkg):
            clock = _Clock(0.0)
            act = _actuator(pkg, tmp_path, clock, cooldown_s=4.0)
            ev = pkg["health"].HealthEvaluator([edge_rule(pkg["health"])])
            ev.subscribe_ticks(act.on_tick)
            verdicts = []
            for i, d in enumerate(depths):
                clock.t = float(i)
                ev.evaluate_once(snap(d), now=100.0 + i)
                verdicts.append(act.last_verdict)
            return verdicts, _decision_row(act)
        verdicts, _ = twin(run)
        assert set(verdicts) <= {"no-breach", "cooldown", "decided"}

    def test_scale_up_outranks_scale_down(self, tmp_path):
        def run(pkg):
            idle = pkg["health"].SloRule("idle", "idle_s", warn=4, breach=6, sustain=2,
                                         clear_after=2, action="scale_down")
            act = _actuator(pkg, tmp_path, _Clock(10.0), cooldown_s=0.0)
            ev = pkg["health"].HealthEvaluator([edge_rule(pkg["health"]), idle])
            ev.subscribe_ticks(act.on_tick)
            for i in range(2):
                ev.evaluate_once({"slow.0": {"edge0_src_queue_depth": 9.0},
                                  "lazy.0": {"idle_s": 9.0}}, now=100.0 + i)
            return _decision_row(act)
        decision = twin(run)
        assert (decision["action"], decision["rule_id"]) == ("scale_up", "edge-queue")

    def test_decision_file_round_trip(self, tmp_path):
        def run(pkg):
            act = _actuator(pkg, tmp_path, _Clock(10.0), cooldown_s=0.0)
            ev = pkg["health"].HealthEvaluator([edge_rule(pkg["health"])])
            ev.subscribe_ticks(act.on_tick)
            feed(ev, [9, 9])
            doc = pkg["autoscale"].read_decision(act.config.decision_path)
            doc.pop("ts")
            return doc
        doc = twin(run)
        assert doc["to_workers"] == 3
        assert doc["rule_id"] == "edge-queue"
        assert doc["health"]["job"] == "BREACH"
        # Each package reads the other's file.
        path = str(tmp_path / "cross.json")
        write_decision(path, AutoscaleDecision("r", "t", "scale_up", 1.0, 2, 3, 5.0))
        assert jautoscale.read_decision(path) == read_decision(path)

    def test_decision_lands_on_the_flight_ring(self, tmp_path):
        def run(pkg):
            flight = pkg["flight"]()
            cfg = pkg["autoscale"].AutoscaleConfig(cooldown_s=0.0)
            decided = []
            act = pkg["autoscale"].AutoscaleActuator(
                cfg, 2, clock=_Clock(1.0), checkpoint_ready=lambda: 2, flight=flight,
                on_decision=decided.append)
            ev = pkg["health"].HealthEvaluator([edge_rule(pkg["health"])])
            ev.subscribe_ticks(act.on_tick)
            feed(ev, [9, 9])
            return [e[:2] + e[5:] for e in flight.events()], len(decided)
        events, n = twin(run)
        assert events[0][:2] == ("autoscale", "decision") and n == 1

    def test_read_decision_rejects_garbage(self, tmp_path):
        def run(pkg):
            path = str(tmp_path / "d.json")
            got = [pkg["autoscale"].read_decision(path)]
            with open(path, "w") as f:
                f.write("{not json")
            got.append(pkg["autoscale"].read_decision(path))
            with open(path, "w") as f:
                json.dump({"kind": "something-else"}, f)
            got.append(pkg["autoscale"].read_decision(path))
            os.unlink(path)
            return got
        assert twin(run) == [None, None, None]


# ---------------------------------------------------------------------------
# supervisor protocol (no record plane: trivial worker commands)
# ---------------------------------------------------------------------------


def _decision_writer_code(path, to_workers, exit_code=RESCALE_EXIT_CODE):
    doc = AutoscaleDecision(rule_id="edge-queue", target="slow", action="scale_up",
                            value=9.0, from_workers=2, to_workers=to_workers,
                            ts=0.0).to_dict()
    return ("import json, sys, time\n"
            f"doc = {doc!r}\n"
            "doc['ts'] = time.time()\n"
            f"json.dump(doc, open({path!r}, 'w'))\n"
            f"sys.exit({exit_code})\n")


def _supervise(tmp_path, make_command, *, num_workers=2, **kwargs):
    """Both packages' supervisors over the same stub commands: their
    outcomes without the decisions' wall-clock stamps."""
    def run(pkg):
        path = str(tmp_path / f"{pkg['health'].__name__}.decision.json")
        sup = pkg["autoscale"].AutoscaleSupervisor(
            make_command(path), num_workers, decision_path=path, poll_s=0.02, **kwargs)
        outcome = sup.run()
        rescales = [{k: v for k, v in d.items() if k != "ts"} for d in outcome.rescales]
        return outcome.attempts, outcome.returncode, outcome.num_workers, rescales
    return twin(run)


class TestAutoscaleSupervisor:
    def test_rescale_request_respawns_at_decision_target(self, tmp_path):
        def make_command(path):
            def command(w, num_workers, attempt):
                if attempt == 0 and w == 0:
                    return [sys.executable, "-S", "-c", _decision_writer_code(path, 3)]
                if attempt == 0:
                    # The deciding worker's peer: killed by the supervisor.
                    return [sys.executable, "-S", "-c", "import time; time.sleep(60)"]
                return [sys.executable, "-S", "-c",
                        f"import sys; sys.exit(0 if {num_workers} == 3 else 9)"]
            return command
        attempts, rc, workers, rescales = _supervise(tmp_path, make_command, max_workers=3)
        assert (attempts, rc, workers) == (2, 0, 3)
        assert [d["to_workers"] for d in rescales] == [3]

    def test_decision_target_is_reclamped(self, tmp_path):
        def make_command(path):
            def command(w, num_workers, attempt):
                if attempt == 0 and w == 0:
                    # A decision demanding more than the parent allows.
                    return [sys.executable, "-S", "-c", _decision_writer_code(path, 99)]
                if attempt == 0:
                    # The deciding worker's peer: killed by the supervisor.
                    return [sys.executable, "-S", "-c", "import time; time.sleep(60)"]
                return [sys.executable, "-S", "-c",
                        f"import sys; sys.exit(0 if {num_workers} == 3 else 9)"]
            return command
        assert _supervise(tmp_path, make_command, max_workers=3)[2] == 3

    def test_rescale_exit_without_decision_burns_budget(self, tmp_path):
        def make_command(path):
            def command(w, num_workers, attempt):
                rc = RESCALE_EXIT_CODE if attempt == 0 else 0
                return [sys.executable, "-S", "-c", f"import sys; sys.exit({rc})"]
            return command
        attempts, _, workers, rescales = _supervise(tmp_path, make_command, max_workers=3,
                                                    max_restarts=2)
        # Respawned unchanged: a lost decision file must not guess.
        assert (attempts, workers, rescales) == (2, 2, [])

    def test_failures_past_the_budget_raise(self, tmp_path):
        from flink_tensorflow_tpu.parallel.supervisor import CohortFailed as JaxCohortFailed
        from flink_tensorflow_tpu_torch.parallel.supervisor import CohortFailed

        def run(pkg):
            sup = pkg["autoscale"].AutoscaleSupervisor(
                lambda w, n, a: [sys.executable, "-S", "-c", "import sys; sys.exit(3)"], 1,
                decision_path=str(tmp_path / "none.json"), max_restarts=1, poll_s=0.02)
            with pytest.raises((CohortFailed, JaxCohortFailed)) as info:
                sup.run()
            return info.value.attempts, info.value.last_rc
        assert twin(run) == (2, 3)

    def test_stale_decision_is_not_reconsumed(self, tmp_path):
        path = str(tmp_path / "decision.json")
        write_decision(path, AutoscaleDecision(
            rule_id="old", target="x", action="scale_up", value=1.0,
            from_workers=2, to_workers=3, ts=time.time()))

        def run(pkg):
            sup = pkg["autoscale"].AutoscaleSupervisor(lambda w, n, a: [], 2,
                                                       decision_path=path, max_workers=3)
            doc = sup._fresh_decision(0.0)
            return doc, sup._fresh_decision(float(doc["ts"]))
        doc, again = twin(run)
        assert doc is not None and again is None

    def test_max_workers_below_start_rejected(self, tmp_path):
        def run(pkg):
            with pytest.raises(ValueError) as info:
                pkg["autoscale"].AutoscaleSupervisor(lambda w, n, a: [], 3,
                                                     decision_path=str(tmp_path / "d"),
                                                     max_workers=2)
            return str(info.value)
        assert "max_workers" in twin(run)

    def test_port_supervisor_is_a_cohort_supervisor(self):
        from flink_tensorflow_tpu_torch.parallel.supervisor import CohortSupervisor

        assert issubclass(AutoscaleSupervisor, CohortSupervisor)
        assert autoscale.RESCALE_EXIT_CODE == jautoscale.RESCALE_EXIT_CODE == 75


# ---------------------------------------------------------------------------
# doctor: evidence correlation
# ---------------------------------------------------------------------------


class TestDoctor:
    SNAP = {
        "slow.0": {"in_backpressure_s": 4.0, "queue_depth": 7.0,
                   "edge0_src_queue_depth": 8.0, "backpressure_s": 0.2, "idle_s": 0.1},
        "sink.0": {"idle_s": 5.0, "queue_depth": 0.0},
        "health": {"slow": 2.0, "job": 2.0},
    }
    EVENTS = [
        ("slow.0", "compute", "X", 0.00, 0.040, None),
        ("slow.0", "compute", "X", 0.10, 0.050, None),
        ("slow.0", "h2d", "X", 0.05, 0.001, None),
    ]
    CREDIT_SNAP = {
        "up.0": {"in_backpressure_s": 4.0, "backpressure_s": 3.0, "idle_s": 0.0},
        "shuffle.out.up.0.ch2": {"credit_starved_s": 2.5, "credits_available": 0.0},
        "shuffle.out.up.0.ch1": {"credit_starved_s": 0.4},
        "pipe.0": {"edge.credit_starved_s": 1.2, "idle_s": 0.1},
        "down.0": {"idle_s": 5.0},
    }

    def test_health_findings_rank_breach_first(self):
        findings = twin(lambda pkg: pkg["doctor"].health_findings(self.SNAP,
                                                                  channel_capacity=8))
        assert findings[0]["severity"] == 2
        assert findings[0]["target"].startswith("slow")

    def test_bottleneck_ranking_leads_with_blocked_upstream(self):
        ranked = twin(lambda pkg: pkg["doctor"].bottleneck_ranking(self.SNAP))
        assert ranked[0]["operator"] == "slow"
        assert ranked[0]["in_backpressure_s"] == 4.0

    def test_stage_dominance(self):
        stages = twin(lambda pkg: pkg["doctor"].stage_dominance(self.EVENTS))
        assert stages["slow"]["stage"] == "compute"
        assert stages["slow"]["share"] > 0.9

    def test_diagnose_names_operator_stage_and_action(self):
        decision = AutoscaleDecision(rule_id="edge-queue", target="slow", action="scale_up",
                                     value=8.0, from_workers=2, to_workers=3, ts=1.0,
                                     checkpoint_id=4).to_dict()
        report = twin(lambda pkg: pkg["doctor"].diagnose(
            self.SNAP, events=self.EVENTS, decision=decision, channel_capacity=8))
        head = report["findings"][0]
        assert "#1 bottleneck slow" in head
        assert "dominant stage compute" in head
        assert any("scale_up 2 -> 3" in f for f in report["findings"])

    def test_diagnose_notes_missing_actuation_on_breach(self):
        report = twin(lambda pkg: pkg["doctor"].diagnose(self.SNAP, channel_capacity=8))
        assert any("no autoscale decision" in f for f in report["findings"])

    def test_bottleneck_ranking_carries_credit_evidence(self):
        ranked = {r["operator"]: r for r in
                  twin(lambda pkg: pkg["doctor"].bottleneck_ranking(self.CREDIT_SNAP))}
        assert ranked["up"]["credit_starved_s"] == pytest.approx(2.9)
        assert ranked["up"]["credit_edge"] == "shuffle.out.up.0.ch2"
        assert ranked["pipe"]["credit_starved_s"] == pytest.approx(1.2)
        assert ranked["pipe"]["credit_edge"] == "pipe.0"
        assert ranked["down"]["credit_starved_s"] == 0.0
        assert ranked["down"]["credit_edge"] is None

    def test_diagnose_names_credit_starved_edge(self):
        head = twin(lambda pkg: pkg["doctor"].diagnose(
            self.CREDIT_SNAP, channel_capacity=8))["findings"][0]
        assert "#1 bottleneck up" in head
        assert "credit-starved 2.90s on edge shuffle.out.up.0.ch2" in head
        assert "the jam is below this operator" in head

    def test_report_folds_parse_the_same_report_dicts(self):
        sanitizer = {"violations": [{"kind": "credit-overspend", "edge": "a.0[ch0]",
                                     "message": "balance -5"}],
                     "local_violations": [{"process": 1, "kind": "lock-order",
                                           "message": "a then b"}]}
        checker = {"findings": [{"severity": "ERROR", "rule": "hbm", "node": "m",
                                 "message": "over"},
                                {"severity": "INFO", "rule": "x", "message": "skip"}]}
        roofline = {"findings": [{"rule": "roofline-drift", "operator": "m",
                                  "message": "h2d 2x"}],
                    "rows": [{"operator": "m", "headroom_s": 1.5, "bound": "wire",
                              "mfu_pct": 0.0}]}

        def run(pkg):
            d = pkg["doctor"]
            return (d.sanitizer_findings(sanitizer), d.sanitizer_findings({"truncated": True}),
                    d.shardcheck_findings(checker), d.statecheck_findings(checker),
                    d.roofline_findings(roofline),
                    d.diagnose({}, sanitizer_report=sanitizer, shardcheck_report=checker,
                               statecheck_report=checker, roofline_report=roofline))
        got = twin(run)
        assert got[5]["findings"][0].startswith("sanitizer: credit-overspend")
        assert got[2] == ["shardcheck ERROR [hbm] m: over"]

    def test_supervisor_actions_from_flight_docs(self):
        docs = [{"pid": 7, "events": [
            ["health", "edge-queue:slow", "i", 2.0, 0.0, {"to": "BREACH"}],
            ["job", "start", "i", 0.5, 0.0, {}],
            ["autoscale", "decision", "i", 3.0, 0.0, {"rule": "edge-queue"}]]}]
        actions = twin(lambda pkg: pkg["doctor"].supervisor_actions(docs))
        assert [a["event"] for a in actions] == ["edge-queue:slow", "decision"]

    def test_cli_round_trip(self, tmp_path, capsys):
        snap_path = str(tmp_path / "snap.json")
        with open(snap_path, "w") as f:
            json.dump(self.SNAP, f)
        flight = str(tmp_path / "flight.json")
        recorder = FlightRecorder()
        recorder.record("health", "edge-queue:slow", {"to": "BREACH"})
        recorder.dump(flight, "cancel")

        def run(pkg):
            out = str(tmp_path / f"{pkg['health'].__name__}.report.json")
            rc = pkg["doctor"].main(["--snapshot", snap_path, "--flight", flight,
                                     "--out", out, "--channel-capacity", "8"])
            lines = capsys.readouterr().out.splitlines()
            with open(out) as f:
                report = json.load(f)
            for a in report["actions"]:
                a["source"] = a["source"].split(":")[0]
            return rc, report, [x for x in lines if not x.startswith("report ->")][:-1]
        rc, report, printed = twin(run)
        assert rc == 0
        assert report["kind"] == "flink-tpu-doctor-report"
        assert report["bottlenecks"][0]["operator"] == "slow"
        assert printed[0] == "== flink-tpu-doctor =="

    def test_cli_json_line_equals_jax(self, tmp_path, capsys):
        snap_path = str(tmp_path / "snap.json")
        with open(snap_path, "w") as f:
            json.dump({"snapshot": self.CREDIT_SNAP}, f)

        def run(pkg):
            assert pkg["doctor"].main(["--snapshot", snap_path, "--top", "2"]) == 0
            return json.loads(capsys.readouterr().out.splitlines()[-1])
        assert twin(run)["kind"] == "flink-tpu-doctor-report"

    def test_cli_unreadable_evidence_exits_2(self, tmp_path):
        bad = str(tmp_path / "bad.json")
        with open(bad, "w") as f:
            f.write("ceci n'est pas une decision")

        def run(pkg):
            return (pkg["doctor"].main(["--snapshot", str(tmp_path / "absent.json")]),
                    pkg["doctor"].main(["--decision", bad]))
        assert twin(run) == (2, 2)

    def test_module_entry_point(self, tmp_path):
        import subprocess

        snap_path = str(tmp_path / "snap.json")
        with open(snap_path, "w") as f:
            json.dump(self.SNAP, f)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        proc = subprocess.run(
            [sys.executable, "-m", "flink_tensorflow_tpu_torch.tracing.doctor", "--snapshot",
             snap_path, "--channel-capacity", "8"], capture_output=True, text=True,
            timeout=120, cwd=repo, env=dict(os.environ, PYTHONPATH=repo))
        assert proc.returncode == 0, proc.stderr
        report = json.loads(proc.stdout.strip().splitlines()[-1])
        assert report == jdoctor.diagnose(self.SNAP, channel_capacity=8)


# ---------------------------------------------------------------------------
# the plane inside port jobs
# ---------------------------------------------------------------------------


def _slow_job(env, n=120, delay=0.004):
    def slow(x):
        time.sleep(delay)
        return x

    (env.from_collection(list(range(n)))
        .map(slow, name="slow")
        .sink_to_callable(lambda v: None, name="sink"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gate_per_channel_depth_follows_jax(seed):
    """The per-channel buffered counts behind the ``edge*_queue_depth``
    gauges (what ``edge-queue`` reads) through the same seeded puts, polls
    and alignments as the JAX gate's."""
    from flink_tensorflow_tpu.core import elements as jel
    from flink_tensorflow_tpu.core.channels import InputGate as JaxGate
    from flink_tensorflow_tpu_torch.core import elements as el
    from flink_tensorflow_tpu_torch.core.channels import InputGate

    def run(Gate, elements):
        rng = np.random.RandomState(seed)
        gate = Gate(3, capacity=64)
        seen = []
        for step in range(200):
            op = rng.randint(6)
            if op < 3:
                gate.put(int(rng.randint(3)), elements.StreamRecord(step))
            elif op == 3 and not any(gate._blocked):
                gate.block_channel(int(rng.randint(3)))
            elif op == 4:
                gate.unblock_all()
            else:
                got = gate.poll(timeout=0.0)
                seen.append(None if got is None else (got[0], got[1].value))
            seen.append([gate.channel_depth(i) for i in range(3)] + [gate.depth])
        return seen
    assert run(InputGate, el) == run(JaxGate, jel)


def test_edge_queue_gauges_match_jax_names():
    from flink_tensorflow_tpu import StreamExecutionEnvironment as JaxEnv

    def job(env):
        (env.from_collection(list(range(50)), name="src")
            .map(lambda x: x + 1, name="inc", parallelism=2)
            .sink_to_callable(lambda v: None, name="sink"))
        env.execute("t", timeout=60)
        snap = env.metric_registry.snapshot()
        return {scope: {name: value for name, value in metrics.items()
                        if name.startswith("edge")}
                for scope, metrics in snap.items() if scope[-1].isdigit()}

    got = job(StreamExecutionEnvironment().configure(chaining=False))
    want = job(JaxEnv().configure(chaining=False))
    assert got == want
    assert got["sink.0"] == {"edge0_inc_queue_puts": 52, "edge0_inc_queue_depth": 0}


def test_job_config_health_validates_like_jax():
    from flink_tensorflow_tpu.core.config import JobConfig as JaxJobConfig
    from flink_tensorflow_tpu_torch.core.config import JobConfig

    for make in (lambda h: h.HealthConfig(interval_s=-1.0),
                 lambda h: h.HealthConfig(rules=(h.SloRule("x", "", warn=1, breach=2),))):
        with pytest.raises(ValueError) as jax_err:
            JaxJobConfig(health=make(jhealth)).validate()
        with pytest.raises(ValueError) as port_err:
            JobConfig(health=make(health)).validate()
        assert str(port_err.value) == str(jax_err.value)
    assert JobConfig().health is None


def test_a_local_job_publishes_health_gauges_and_flight_events(tmp_path):
    env = StreamExecutionEnvironment()
    rule = SloRule("slow-queue", "queue_depth", warn=0.0, breach=0.0, sustain=1,
                   cmp=">")
    env.configure(channel_capacity=4, chaining=False, flight_path=str(tmp_path / "f.json"),
                  health=HealthConfig(rules=(rule,), interval_s=0.05))
    _slow_job(env)
    handle = env.execute_async("health")
    evaluator = handle.health
    assert evaluator is not None and evaluator.interval_s == 0.05
    handle.wait(60)
    assert evaluator._thread is None  # stopped at wait()
    assert evaluator.ticks >= 2
    gauges = handle.metrics.snapshot()["health"]
    assert "job" in gauges and "slow" in gauges
    flight = [e for e in handle.executor.flight.events() if e[0] == "health"]
    assert len(flight) == len(evaluator.transitions) >= 1


def test_the_default_interval_is_one_second_without_a_cohort():
    env = StreamExecutionEnvironment()
    env.configure(health=HealthConfig())
    _slow_job(env, n=4, delay=0.0)
    handle = env.execute_async("health")
    try:
        assert handle.health.interval_s == 1.0
        assert len(handle.health.rules) == 17
        assert handle.autoscale_decision is None
    finally:
        handle.wait(60)


def test_cancel_stops_the_evaluator():
    env = StreamExecutionEnvironment()
    env.configure(health=HealthConfig(interval_s=0.05), source_throttle_s=0.01)
    _slow_job(env, n=2000, delay=0.0)
    handle = env.execute_async("health")
    time.sleep(0.2)
    handle.cancel()
    assert handle.health._thread is None


def test_an_autoscale_decision_cancels_a_local_job(tmp_path):
    """A sustained breach on a checkpointed job: the actuator decides
    1 -> 2 after the first completed checkpoint and cancels the job, and
    the handle reports the decision."""
    decision_path = str(tmp_path / "decision.json")
    rule = SloRule("edge-queue", "edge*_queue_depth", warn=1.0, breach=2.0, sustain=2,
                   clear_after=2, action="scale_up")
    env = StreamExecutionEnvironment()
    env.configure(channel_capacity=4, chaining=False, health=HealthConfig(
        rules=(rule,), interval_s=0.05,
        autoscale=AutoscaleConfig(min_workers=1, max_workers=2, cooldown_s=0.1,
                                  decision_path=decision_path)))
    env.enable_checkpointing(str(tmp_path / "chk"), every_n_records=20)
    _slow_job(env, n=2000, delay=0.005)
    handle = env.execute_async("autoscale")
    try:
        handle.wait(120)
    except Exception:  # noqa: BLE001 - the decision's cancel may surface here
        pass
    decision = handle.autoscale_decision
    assert decision is not None
    assert (decision.rule_id, decision.from_workers, decision.to_workers) == (
        "edge-queue", 1, 2)
    assert decision.checkpoint_id is not None
    assert read_decision(decision_path)["to_workers"] == 2
    assert any(e[:2] == ("autoscale", "decision") for e in handle.executor.flight.events())


# ---------------------------------------------------------------------------
# the closed-loop soak
# ---------------------------------------------------------------------------


@pytest.mark.slow
class TestAutoscaleSoak:
    def test_sustained_breach_drives_one_rescale_byte_identical(self, tmp_path):
        """The port's cohort under its AutoscaleSupervisor: a sustained
        edge-queue breach drives exactly one 2 -> 3 rescale from a
        completed checkpoint, and the committed output equals the
        analytic running sums."""
        from flink_tensorflow_tpu_torch.io.files import read_committed

        from _torch_autoscale_worker import NUM_KEYS

        worker = os.path.join(os.path.dirname(__file__), "_torch_autoscale_worker.py")
        n, every, par = 1200, 60, 3
        out, chk = str(tmp_path / "out"), str(tmp_path / "chk")
        decision_path = str(tmp_path / "decision.json")
        ports_by_shape = {2: free_ports(2), 3: free_ports(3)}

        def command(w, num_workers, attempt):
            return [sys.executable, worker, "--index", str(w),
                    "--ports", ",".join(map(str, ports_by_shape[num_workers])),
                    "--out", out, "--chk", chk, "--n", str(n), "--every", str(every),
                    "--par", str(par), "--delay", "0.01", "--cap", "8",
                    "--epoch", str(attempt),
                    "--restore-id", "-1" if attempt == 0 else "-2",
                    "--decision", decision_path, "--min-workers", "1",
                    "--max-workers", "3", "--cooldown", "2.0"]

        sup = AutoscaleSupervisor(command, 2, decision_path=decision_path, min_workers=1,
                                  max_workers=3, max_rescales=2, max_restarts=2,
                                  poll_s=0.05, kill_grace_s=8.0, attempt_timeout_s=150.0)
        outcome = sup.run()
        assert (outcome.returncode, outcome.attempts, outcome.num_workers) == (0, 2, 3)
        assert len(outcome.rescales) == 1
        decision = outcome.rescales[0]
        assert (decision["action"], decision["from_workers"], decision["to_workers"]) == (
            "scale_up", 2, 3)
        assert decision["checkpoint_id"] is not None
        assert decision["target"].startswith("slow_sum")
        sums = {k: 0 for k in range(NUM_KEYS)}
        expected = []
        for i in range(n):
            sums[i % NUM_KEYS] += i
            expected.append((i % NUM_KEYS, i, sums[i % NUM_KEYS]))
        got = sorted((int(r.meta["key"]), int(r.meta["i"]), int(r["v"]))
                     for r in read_committed(out))
        assert got == sorted(expected)
        evidence = {"health": {t: {"OK": 0, "WARN": 1, "BREACH": 2}[s]
                               for t, s in decision["health"]["targets"].items()}}
        report = doctor.diagnose(evidence, decision=decision, channel_capacity=8)
        assert report == jdoctor.diagnose(evidence, decision=decision, channel_capacity=8)
        assert any("slow_sum" in f for f in report["findings"])
        assert any("scale_up 2 -> 3" in f for f in report["findings"])
