"""Runtime roofline plane — per-operator MFU/bandwidth attribution.

Port of ``flink_tensorflow_tpu/metrics/roofline.py``.  The plan-time
:class:`~flink_tensorflow_tpu_torch.analysis.costmodel.CostTable` (FLOPs
/ HBM bytes / collective bytes / expected h2d+d2h per call, per unit per
call signature) reaches every runner through ``JobConfig.roofline``, and
the model runners' measured step times join against it to publish
continuous per-operator ``roofline.*`` gauges:

- ``roofline.flops_per_s`` / ``roofline.hbm_bytes_per_s`` — achieved
  rates over wall time.
- ``roofline.mfu_pct`` / ``roofline.membw_pct`` — the same rates
  against a declared :class:`DeviceSpec` peak.
- ``roofline.bound`` — roofline classification code (see
  :data:`BOUND_NAMES`): host (device duty cycle below threshold), wire
  (h2d rate dominates both utilization fractions), else compute vs
  memory by the larger busy-time utilization fraction.
- ``roofline.busy_s`` — device-busy seconds attributed so far (where the
  runner is traced on the card, the union of its batches' intervals
  between their own CUDA events; else each batch's host-stamped compute
  interval).
- ``roofline.measured_h2d_per_call`` / ``roofline.predicted_h2d_per_call``
  / ``roofline.h2d_drift_frac`` — measured against priced transfer bytes.
- ``roofline.compile_events`` / ``roofline.unpredicted_compiles`` — the
  first sight of each call signature (on the card: the first launch of a
  shape, which pays kernel builds, cuDNN plans and allocator growth)
  lands on the flight recorder's ``compile`` track and the tracer's
  ``compile.events`` track, diffed against the CostTable's predicted
  signature ladder.

The port has no pricer yet (the reference prices jaxprs; a walk over the
torch modules is later work), so a ``RooflineConfig`` without a table is
the reference's fail-soft path: busy, duty, bound and compile gauges,
and MFU 0.  Drift findings come from :func:`drift_findings` and the
ranked report from :func:`roofline_report` / ``python -m
flink_tensorflow_tpu_torch.metrics.roofline``.

Zero-cost-when-off, repo-wide convention: runners hold ``None`` and the
hot path pays one ``is None`` test; the per-step ``observe()`` join is
a dict lookup plus a handful of integer adds (priced next to
``span_record_ns``/``flight_record_ns`` by the bench overhead probes).
"""

from __future__ import annotations

import dataclasses
import fnmatch
import json
import time
import typing

if typing.TYPE_CHECKING:
    from flink_tensorflow_tpu_torch.analysis.costmodel import CostTable, OperatorCost

#: ``roofline.bound`` gauge codes.  0 = no evidence yet.
BOUND_NAMES = ("-", "compute", "memory", "host", "wire")
BOUND_NONE, BOUND_COMPUTE, BOUND_MEMORY, BOUND_HOST, BOUND_WIRE = range(5)

#: Span names whose duration counts as device-busy time when a roofline
#: report is built from a trace instead of live gauges.
COMPUTE_SPAN_NAMES = frozenset({"compute", "decode.step", "decode.prefill"})
#: Cache-movement spans (warm-tier extract/insert, paged demote/revive):
#: joined against ``cache_move`` cost entries, never against compiles.
CACHE_SPAN_NAMES = frozenset({"cache.h2d", "cache.d2h"})


# ---------------------------------------------------------------------------
# DeviceSpec — the declared hardware ceiling
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """Peak rates MFU/bandwidth utilization are measured against."""

    name: str
    peak_flops_per_s: float       # bf16 dense tensor-core peak
    peak_hbm_bytes_per_s: float
    #: Host->device interconnect ceiling — only the wire-bound
    #: classification reads it.
    peak_h2d_bytes_per_s: float = 32e9

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def resolve(cls, spec: typing.Union[str, "DeviceSpec"]) -> "DeviceSpec":
        if isinstance(spec, cls):
            return spec
        try:
            return DEVICE_SPECS[spec]
        except KeyError:
            raise ValueError(
                f"unknown device spec {spec!r} — declare one of "
                f"{sorted(DEVICE_SPECS)} or pass a DeviceSpec") from None


#: Presets (bf16 peak / HBM bandwidth / host link, per card).
#: ``h100-sxm`` holds NVIDIA's H100 SXM5 datasheet figures (dense bf16
#: tensor-core peak, HBM3 bandwidth, PCIe Gen5 x16), not measurements.
#: ``cpu-test`` declares tiny deterministic peaks so CPU-only tests
#: exercise real (non-zero, non-degenerate) MFU arithmetic.
DEVICE_SPECS: typing.Dict[str, DeviceSpec] = {
    "h100-sxm": DeviceSpec("h100-sxm", 989.4e12, 3.35e12, 64e9),
    "cpu-test": DeviceSpec("cpu-test", 1e9, 1e9, 1e9),
}


@dataclasses.dataclass(frozen=True)
class RooflineConfig:
    """``JobConfig.roofline`` — declaring one turns the plane on.

    ``cost_table`` left ``None`` is the fail-soft path: busy, duty,
    bound and compile gauges, and no MFU (the port has no pricer yet).
    The tolerances are the drift knobs the README documents.
    """

    device: typing.Union[str, DeviceSpec] = "h100-sxm"
    cost_table: typing.Optional["CostTable"] = None
    #: |measured - predicted| / predicted per-call h2d beyond this
    #: fraction is a `roofline-drift` finding.
    h2d_tolerance: float = 0.25
    #: Measured MFU above this many percent of peak means the static
    #: FLOPs estimate (or the step timing) is wrong — flops drift.
    mfu_ceiling_pct: float = 105.0
    #: Device duty cycle (busy_s / elapsed) below this classifies the
    #: operator host-bound regardless of its busy-time utilization.
    host_duty_threshold: float = 0.33

    def resolved_device(self) -> DeviceSpec:
        return DeviceSpec.resolve(self.device)

    def validate(self) -> "RooflineConfig":
        self.resolved_device()  # raises on an unknown preset
        if self.h2d_tolerance <= 0:
            raise ValueError(
                f"h2d_tolerance must be > 0, got {self.h2d_tolerance}")
        if self.mfu_ceiling_pct <= 0:
            raise ValueError(
                f"mfu_ceiling_pct must be > 0, got {self.mfu_ceiling_pct}")
        if not (0.0 <= self.host_duty_threshold < 1.0):
            raise ValueError(
                "host_duty_threshold must be in [0, 1), got "
                f"{self.host_duty_threshold}")
        return self


# ---------------------------------------------------------------------------
# the live plane: one per executor, one probe per runner
# ---------------------------------------------------------------------------


class RooflinePlane:
    """Executor-owned fan-out point: holds the resolved DeviceSpec, the
    shipped CostTable, and the flight/tracer hooks compile events land
    on.  ``_wire_units`` puts it on ``ctx.roofline``; runners mint one
    :class:`RooflineProbe` per operator at ``open()``."""

    def __init__(self, config: RooflineConfig, *,
                 flight=None, tracer=None):
        self.config = config
        self.spec = config.resolved_device()
        self.table = config.cost_table
        self.flight = flight
        self.tracer = tracer

    def probe(self, node: str, *, metrics=None) -> "RooflineProbe":
        op_cost = self.table.op(node) if self.table is not None else None
        return RooflineProbe(self, node, op_cost=op_cost, metrics=metrics)


class RooflineProbe:
    """Per-operator accumulator joining measured step times against the
    static cost entries; registers the ``roofline.*`` gauges on the
    operator's metric group so they ride cohort telemetry pushes.

    Counters are plain ints (registry convention): racy increments from
    a fetch thread lose at most a step of attribution, never corrupt."""

    def __init__(self, plane: RooflinePlane, node: str, *,
                 op_cost: typing.Optional["OperatorCost"] = None,
                 metrics=None):
        self.plane = plane
        self.node = node
        self.op_cost = op_cost
        self._ladder = frozenset(
            op_cost.predicted_signatures if op_cost is not None else ())
        self._seen: typing.Set[typing.Tuple[str, typing.Optional[str]]] = set()
        self._warmup = 0
        self._t_first: typing.Optional[float] = None
        self.busy_s = 0.0
        self.flops = 0
        self.hbm_bytes = 0
        self.h2d_bytes = 0            # measured, all calls
        self.h2d_calls = 0
        #: Drift pair: measured/predicted restricted to calls the cost
        #: table actually priced — the per-call averages stay comparable.
        self.h2d_measured_paired = 0
        self.h2d_predicted_paired = 0
        self.h2d_paired_calls = 0
        self.compile_events = 0
        self.unpredicted_compiles = 0
        if metrics is not None:
            self._register_gauges(metrics)

    # -- warmup bracketing -------------------------------------------------
    def begin_warmup(self) -> None:
        """Compile-time suppression: warmup observes record their
        compile events (trigger="warmup") but no busy/flops accounting —
        compile time must not masquerade as steady-state throughput."""
        self._warmup += 1

    def end_warmup(self) -> None:
        self._warmup = max(0, self._warmup - 1)

    # -- the per-step join -------------------------------------------------
    def observe(self, unit: str, busy_s: float, *,
                signature: typing.Optional[str] = None,
                h2d_bytes: int = 0, d2h_bytes: int = 0) -> None:
        """Attribute one measured call of ``unit`` at ``signature``.
        ``busy_s`` is the call's device time: from the runner's own CUDA
        events where it has them (traced, on the card), the time its
        interval adds past the end the stream had reached, so overlapping
        batches are not counted twice; else its host-stamped compute
        interval (launch to the fetch thread reaching the batch, which
        overlaps the batches around it)."""
        key = (unit, signature)
        if key not in self._seen:
            self._seen.add(key)
            if signature is not None:
                self._record_compile(unit, signature)
                if not self._warmup:
                    # The first call of a signature pays its one-time
                    # costs (kernel builds, plans) inside its measured time — logged as a compile
                    # event, excluded from throughput attribution (same
                    # rule as the runners' warmup metric suppression).
                    return
        if self._warmup:
            return
        now = time.monotonic()
        if self._t_first is None:
            self._t_first = now - busy_s
        self.busy_s += busy_s
        entry = (self.op_cost.entry(unit, signature)
                 if self.op_cost is not None else None)
        if entry is not None:
            self.flops += entry.flops
            self.hbm_bytes += entry.hbm_bytes
        if h2d_bytes:
            self.h2d_bytes += h2d_bytes
            self.h2d_calls += 1
            if entry is not None and entry.h2d_bytes:
                self.h2d_measured_paired += h2d_bytes
                self.h2d_predicted_paired += entry.h2d_bytes
                self.h2d_paired_calls += 1

    def observe_transfer(self, unit: str, busy_s: float, *,
                         signature: typing.Optional[str] = None,
                         h2d_bytes: int = 0, d2h_bytes: int = 0) -> None:
        """Attribute one measured cache move (warm-tier extraction,
        spilled-session revival, paged block insert).

        Transfers are NOT jit launches: no compile event is minted and
        there is no first-sight suppression — the first spill pays the
        same wire time as the hundredth, so suppressing it would bias
        the duty cycle exactly when tiering churn matters most.  Busy
        time still accrues (a runner drowning in cache moves IS
        wire-bound and :meth:`bound` should say so), and measured bytes
        pair against the plan's ``cache_move`` entries to feed the same
        drift gauges the per-step h2d feeds."""
        if self._warmup:
            return
        now = time.monotonic()
        if self._t_first is None:
            self._t_first = now - busy_s
        self.busy_s += busy_s
        moved = h2d_bytes + d2h_bytes
        if not moved:
            return
        self.h2d_bytes += moved
        self.h2d_calls += 1
        entry = (self.op_cost.entry(unit, signature)
                 if self.op_cost is not None else None)
        if entry is not None:
            # cache_move entries price both directions; pair against
            # whichever side this call actually crossed.
            predicted = (entry.h2d_bytes if h2d_bytes
                         else getattr(entry, "d2h_bytes", 0))
            if predicted:
                self.h2d_measured_paired += moved
                self.h2d_predicted_paired += predicted
                self.h2d_paired_calls += 1

    def _record_compile(self, unit: str, signature: str) -> None:
        """A jit cache miss (first sight of a signature): provenance to
        the flight recorder + trace, diffed against the predicted
        ladder."""
        self.compile_events += 1
        predicted = (signature in self._ladder) if self._ladder else None
        if predicted is False:
            self.unpredicted_compiles += 1
        args = {"node": self.node, "unit": unit, "signature": signature,
                "trigger": "warmup" if self._warmup else "steady-state",
                "predicted": predicted}
        if self.plane.flight is not None:
            self.plane.flight.record("compile", "jit_compile", args)
        if self.plane.tracer is not None:
            self.plane.tracer.instant(
                "compile.events", f"compile {self.node}:{signature}",
                args=args)

    # -- derived readings --------------------------------------------------
    def elapsed_s(self) -> float:
        if self._t_first is None:
            return 0.0
        return max(time.monotonic() - self._t_first, self.busy_s, 1e-9)

    def flops_per_s(self) -> float:
        e = self.elapsed_s()
        return self.flops / e if e else 0.0

    def hbm_bytes_per_s(self) -> float:
        e = self.elapsed_s()
        return self.hbm_bytes / e if e else 0.0

    def mfu_pct(self) -> float:
        return 100.0 * self.flops_per_s() / self.plane.spec.peak_flops_per_s

    def membw_pct(self) -> float:
        return (100.0 * self.hbm_bytes_per_s()
                / self.plane.spec.peak_hbm_bytes_per_s)

    def measured_h2d_per_call(self) -> float:
        return self.h2d_bytes / self.h2d_calls if self.h2d_calls else 0.0

    def predicted_h2d_per_call(self) -> float:
        if not self.h2d_paired_calls:
            return 0.0
        return self.h2d_predicted_paired / self.h2d_paired_calls

    def h2d_drift_frac(self) -> float:
        if not self.h2d_paired_calls or not self.h2d_predicted_paired:
            return 0.0
        measured = self.h2d_measured_paired / self.h2d_paired_calls
        predicted = self.h2d_predicted_paired / self.h2d_paired_calls
        return abs(measured - predicted) / predicted

    def bound(self) -> int:
        e = self.elapsed_s()
        if not e or not self.busy_s:
            return BOUND_NONE
        spec = self.plane.spec
        duty = self.busy_s / e
        if duty < self.plane.config.host_duty_threshold:
            return BOUND_HOST
        mfu_busy = self.flops / self.busy_s / spec.peak_flops_per_s
        membw_busy = (self.hbm_bytes / self.busy_s
                      / spec.peak_hbm_bytes_per_s)
        wire_busy = (self.h2d_bytes / self.busy_s
                     / spec.peak_h2d_bytes_per_s)
        if not self.flops and not self.hbm_bytes:
            # No compute entry joined.  Pure cache traffic (an operator
            # that only ever moved blocks) still ranks as wire-bound.
            return BOUND_WIRE if self.h2d_bytes else BOUND_NONE
        if wire_busy > max(mfu_busy, membw_busy):
            return BOUND_WIRE
        return BOUND_COMPUTE if mfu_busy >= membw_busy else BOUND_MEMORY

    def _register_gauges(self, grp) -> None:
        grp.gauge("roofline.flops_per_s", self.flops_per_s)
        grp.gauge("roofline.hbm_bytes_per_s", self.hbm_bytes_per_s)
        grp.gauge("roofline.busy_s", lambda: self.busy_s)
        grp.gauge("roofline.mfu_pct", self.mfu_pct)
        grp.gauge("roofline.membw_pct", self.membw_pct)
        grp.gauge("roofline.bound", self.bound)
        grp.gauge("roofline.measured_h2d_per_call",
                  self.measured_h2d_per_call)
        grp.gauge("roofline.predicted_h2d_per_call",
                  self.predicted_h2d_per_call)
        grp.gauge("roofline.h2d_drift_frac", self.h2d_drift_frac)
        grp.gauge("roofline.compile_events", lambda: self.compile_events)
        grp.gauge("roofline.unpredicted_compiles",
                  lambda: self.unpredicted_compiles)


# ---------------------------------------------------------------------------
# the offline join: report rows from any evidence subset
# ---------------------------------------------------------------------------


def _row(operator: str, *, busy_s: float, flops_per_s: float,
         hbm_bytes_per_s: float, spec: DeviceSpec,
         bound: typing.Optional[int] = None,
         measured_h2d: float = 0.0, predicted_h2d: float = 0.0,
         drift_frac: float = 0.0, compile_events: int = 0,
         unpredicted: int = 0) -> dict:
    mfu = 100.0 * flops_per_s / spec.peak_flops_per_s
    membw = 100.0 * hbm_bytes_per_s / spec.peak_hbm_bytes_per_s
    binding = min(1.0, max(mfu, membw) / 100.0)
    return {
        "operator": operator,
        "busy_s": round(busy_s, 6),
        "flops_per_s": flops_per_s,
        "hbm_bytes_per_s": hbm_bytes_per_s,
        "mfu_pct": round(mfu, 4),
        "membw_pct": round(membw, 4),
        "bound": BOUND_NAMES[bound if bound is not None
                             else (BOUND_COMPUTE if mfu >= membw and mfu
                                   else BOUND_MEMORY if membw
                                   else BOUND_NONE)],
        #: Seconds of device time recoverable under this operator if it
        #: ran at its binding ceiling — the ranking key.
        "headroom_s": round(busy_s * (1.0 - binding), 6),
        "measured_h2d_per_call": measured_h2d,
        "predicted_h2d_per_call": predicted_h2d,
        "h2d_drift_frac": round(drift_frac, 4),
        "compile_events": compile_events,
        "unpredicted_compiles": unpredicted,
    }


def rows_from_snapshot(snapshot: typing.Mapping[str, typing.Mapping],
                       spec: DeviceSpec) -> typing.List[dict]:
    """One report row per scope publishing ``roofline.*`` gauges."""
    rows = []
    for scope, m in sorted(snapshot.items()):
        if not isinstance(m, dict) or "roofline.busy_s" not in m:
            continue

        def g(name, default=0.0):
            v = m.get(name)
            return default if v is None else v

        rows.append(_row(
            scope,
            busy_s=float(g("roofline.busy_s")),
            flops_per_s=float(g("roofline.flops_per_s")),
            hbm_bytes_per_s=float(g("roofline.hbm_bytes_per_s")),
            spec=spec,
            bound=int(g("roofline.bound", BOUND_NONE)),
            measured_h2d=float(g("roofline.measured_h2d_per_call")),
            predicted_h2d=float(g("roofline.predicted_h2d_per_call")),
            drift_frac=float(g("roofline.h2d_drift_frac")),
            compile_events=int(g("roofline.compile_events", 0)),
            unpredicted=int(g("roofline.unpredicted_compiles", 0)),
        ))
    return rows


def rows_from_trace(events: typing.Sequence[tuple],
                    table: typing.Optional["CostTable"],
                    spec: DeviceSpec) -> typing.List[dict]:
    """Report rows joined from span events (tracer tuple form:
    ``(track, name, ph, ts, dur, args)``) against a CostTable — the
    no-live-metrics evidence path (post-hoc trace + plan artifact)."""
    from flink_tensorflow_tpu_torch.analysis.costmodel import serving_signature

    per_op: typing.Dict[str, dict] = {}
    for ev in events:
        track, name, ph, ts, dur, args = ev[:6]
        if ph != "X" or name not in (COMPUTE_SPAN_NAMES | CACHE_SPAN_NAMES):
            continue
        node = str(track).rsplit(".", 1)[0]
        acc = per_op.setdefault(node, {
            "busy_s": 0.0, "t0": ts, "t1": ts, "flops": 0, "hbm": 0,
            "h2d": 0.0, "pred_h2d": 0.0, "calls": 0})
        acc["busy_s"] += dur
        acc["t0"] = min(acc["t0"], ts)
        acc["t1"] = max(acc["t1"], ts + dur)
        oc = table.op(node) if table is not None else None
        args = args or {}
        if name in CACHE_SPAN_NAMES:
            # Cache moves join measured bytes from the span itself and
            # predicted bytes from the plan's cache_move entries.
            measured = int(args.get("bytes", 0) or 0)
            if measured:
                acc["h2d"] += measured
                acc["calls"] += 1
                if oc is not None:
                    sig = (f"cache:pages:{args['pages']}"
                           if args.get("pages") else "cache:block")
                    entry = oc.entry("cache_move", sig)
                    if entry is not None:
                        acc["pred_h2d"] += (entry.h2d_bytes
                                            or entry.d2h_bytes)
            continue
        if oc is None:
            continue
        entry = None
        if name == "decode.prefill" and args.get("bucket"):
            b, t = args["bucket"]
            entry = oc.entry("prefill", serving_signature("prefill", b, t))
        elif name == "decode.step":
            entry = oc.entry("decode_step")
        elif name == "compute" and args.get("batch") is not None:
            entry = oc.entry(oc.entries[0].unit if oc.entries else "",
                             f"b{args['batch']}")
        if entry is not None:
            acc["flops"] += entry.flops
            acc["hbm"] += entry.hbm_bytes
            acc["h2d"] += entry.h2d_bytes
            acc["pred_h2d"] += entry.h2d_bytes
            acc["calls"] += 1
    rows = []
    for node, acc in sorted(per_op.items()):
        elapsed = max(acc["t1"] - acc["t0"], acc["busy_s"], 1e-9)
        rows.append(_row(
            node,
            busy_s=acc["busy_s"],
            flops_per_s=acc["flops"] / elapsed,
            hbm_bytes_per_s=acc["hbm"] / elapsed,
            spec=spec,
            measured_h2d=(acc["h2d"] / acc["calls"]) if acc["calls"] else 0.0,
            predicted_h2d=(acc["pred_h2d"] / acc["calls"])
            if acc["calls"] else 0.0,
        ))
    return rows


def drift_findings(rows: typing.Sequence[dict], *,
                   h2d_tolerance: float = 0.25,
                   mfu_ceiling_pct: float = 105.0) -> typing.List[dict]:
    """The named findings the acceptance criteria require: each one
    carries the operator and the predicted/measured pair."""
    findings = []
    for r in rows:
        if (r.get("h2d_drift_frac", 0.0) > h2d_tolerance
                and r.get("predicted_h2d_per_call")):
            findings.append({
                "rule": "roofline-drift",
                "operator": r["operator"],
                "measured_h2d_per_call": r["measured_h2d_per_call"],
                "predicted_h2d_per_call": r["predicted_h2d_per_call"],
                "drift_frac": r["h2d_drift_frac"],
                "message": (
                    f"measured h2d {r['measured_h2d_per_call']:.1f} B/call "
                    f"vs predicted {r['predicted_h2d_per_call']:.1f} B/call "
                    f"({r['h2d_drift_frac']:.0%} > "
                    f"{h2d_tolerance:.0%} tolerance) — the plan's static "
                    "transfer accounting no longer matches the runtime"),
            })
        if r.get("unpredicted_compiles"):
            findings.append({
                "rule": "roofline-recompile",
                "operator": r["operator"],
                "unpredicted_compiles": r["unpredicted_compiles"],
                "message": (
                    f"{r['unpredicted_compiles']} jit compile(s) outside "
                    "the predicted signature ladder — an unplanned shape "
                    "reached the device (recompile churn the plan did not "
                    "declare)"),
            })
        if r.get("mfu_pct", 0.0) > mfu_ceiling_pct:
            findings.append({
                "rule": "roofline-flops-drift",
                "operator": r["operator"],
                "mfu_pct": r["mfu_pct"],
                "message": (
                    f"measured MFU {r['mfu_pct']:.1f}% exceeds the "
                    f"physical ceiling ({mfu_ceiling_pct:.0f}%) — the "
                    "static FLOPs estimate or the step timing is wrong"),
            })
    return findings


def roofline_report(
    snapshot: typing.Optional[typing.Mapping] = None,
    *,
    events: typing.Sequence[tuple] = (),
    cost_table: typing.Optional["CostTable"] = None,
    device: typing.Union[str, DeviceSpec] = "h100-sxm",
    top: typing.Optional[int] = None,
    h2d_tolerance: float = 0.25,
    mfu_ceiling_pct: float = 105.0,
) -> dict:
    """The ranked headroom report from any evidence subset: live
    ``roofline.*`` gauges in a metric snapshot when available, else
    compute spans from a trace joined against a CostTable.  Rows rank by
    recoverable headroom — "the top N seconds of recoverable headroom
    live under operator X"."""
    spec = DeviceSpec.resolve(device)
    rows = rows_from_snapshot(snapshot, spec) if snapshot else []
    if not rows and events:
        rows = rows_from_trace(events, cost_table, spec)
    rows.sort(key=lambda r: (-r["headroom_s"], r["operator"]))
    findings = drift_findings(rows, h2d_tolerance=h2d_tolerance,
                              mfu_ceiling_pct=mfu_ceiling_pct)
    if top is not None:
        rows = rows[:top]
    return {
        "kind": "flink-tpu-roofline-report",
        "device": spec.to_json(),
        "rows": rows,
        "findings": findings,
    }


# ---------------------------------------------------------------------------
# CLI — flink-tpu-roofline
# ---------------------------------------------------------------------------


def matches_scope(pattern: str, scope: str) -> bool:
    """``fnmatch`` of a scope against a pattern, as the health rules'
    scope filters match."""
    return fnmatch.fnmatch(scope, pattern)


def _load_snapshot(path: str) -> typing.Mapping:
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: not a metric snapshot")
    if "snapshot" in doc and isinstance(doc["snapshot"], dict):
        return doc["snapshot"]
    return doc


def format_report(report: dict) -> str:
    rows = report["rows"]
    lines = [f"== flink-tpu-roofline (device: {report['device']['name']}, "
             f"peak {report['device']['peak_flops_per_s'] / 1e12:.0f} "
             "TFLOP/s) =="]
    if not rows:
        lines.append("  no roofline evidence in the inputs (run with "
                     "JobConfig.roofline set, or pass --trace + "
                     "--cost-table)")
    header = (f"  {'operator':28s} {'mfu%':>7s} {'membw%':>7s} "
              f"{'bound':>7s} {'busy_s':>9s} {'headroom_s':>11s} "
              f"{'h2d drift':>9s}")
    if rows:
        lines.append(header)
    for r in rows:
        lines.append(
            f"  {r['operator']:28s} {r['mfu_pct']:7.2f} "
            f"{r['membw_pct']:7.2f} {r['bound']:>7s} "
            f"{r['busy_s']:9.3f} {r['headroom_s']:11.3f} "
            f"{r['h2d_drift_frac']:8.1%}")
    for f in report["findings"]:
        lines.append(f"  DRIFT [{f['rule']}] {f['operator']}: "
                     f"{f['message']}")
    if rows and not report["findings"]:
        lines.append("  drift: none — measured matches the plan's "
                     "predictions within tolerance")
    return "\n".join(lines)


def main(argv: typing.Optional[typing.Sequence[str]] = None) -> int:
    import argparse
    import sys

    parser = argparse.ArgumentParser(
        prog="python -m flink_tensorflow_tpu_torch.metrics.roofline",
        description="Ranked per-operator MFU / bandwidth / headroom "
                    "report: joins live roofline.* gauges (metric "
                    "snapshot) or compute spans (Chrome trace) against "
                    "the plan's static CostTable and a declared "
                    "DeviceSpec peak; predicted-vs-measured divergence "
                    "surfaces as named drift findings (exit 1).",
    )
    parser.add_argument("--snapshot", default=None, metavar="SNAP.json",
                        help="metric scope tree (inspector/cohort "
                             "snapshot) carrying roofline.* gauges")
    parser.add_argument("--trace", nargs="*", default=[],
                        metavar="TRACE.json",
                        help="exported Chrome trace(s): compute spans "
                             "join against --cost-table when no "
                             "snapshot is given")
    parser.add_argument("--cost-table", default=None, metavar="TABLE.json",
                        help="static cost table (CostTable.to_json)")
    parser.add_argument("--device", default="h100-sxm",
                        help=f"DeviceSpec preset ({sorted(DEVICE_SPECS)}; "
                             "default h100-sxm)")
    parser.add_argument("--top", type=int, default=None,
                        help="rows to keep after the headroom ranking")
    parser.add_argument("--h2d-tolerance", type=float, default=0.25,
                        help="h2d drift fraction beyond which a finding "
                             "fires (default 0.25)")
    parser.add_argument("--json", action="store_true",
                        help="emit the report as one JSON line")
    parser.add_argument("--out", default=None, metavar="PATH",
                        help="also write the report JSON to PATH")
    args = parser.parse_args(argv)

    snapshot = None
    events: typing.List[tuple] = []
    table = None
    loaded = 0
    try:
        spec = DeviceSpec.resolve(args.device)
        if args.snapshot:
            snapshot = _load_snapshot(args.snapshot)
            loaded += 1
        if args.trace:
            from flink_tensorflow_tpu_torch.tracing.attribution import (
                events_from_chrome,
            )

            for path in args.trace:
                with open(path) as f:
                    events.extend(events_from_chrome(json.load(f)))
                loaded += 1
        if args.cost_table:
            from flink_tensorflow_tpu_torch.analysis.costmodel import CostTable

            with open(args.cost_table) as f:
                table = CostTable.from_json(json.load(f))
            loaded += 1
    except (OSError, ValueError) as ex:
        print(f"flink-tpu-roofline: unreadable evidence: {ex}",
              file=sys.stderr)
        return 2
    if not loaded:
        parser.error("provide at least one of --snapshot / --trace / "
                     "--cost-table")
    report = roofline_report(
        snapshot, events=events, cost_table=table, device=spec,
        top=args.top, h2d_tolerance=args.h2d_tolerance)
    print(format_report(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"report -> {args.out}")
    if args.json:
        print(json.dumps(report))
    return 1 if report["findings"] else 0


def cli() -> None:
    """``python -m flink_tensorflow_tpu_torch.metrics.roofline``."""
    import sys

    sys.exit(main())


if __name__ == "__main__":  # pragma: no cover — python -m parity with cli()
    cli()
