"""The rest of the port's DataStream surface held to the JAX package:
connected streams (CoMap, CoFlatMap, keyed and broadcast CoProcess),
the window and interval joins, union, broadcast, side outputs, flat_map,
unkeyed process, keyed reduce, keyed and sliding count windows, the
chain plans of graphs with several inputs, and a 2 -> 3 rescale of join
buffers and count windows (twins of ``tests/test_connect_join.py``, the
count cases of ``tests/test_windows_extended.py`` and the reduce case of
``tests/test_event_time.py``).

Each job is built through both packages' ``StreamExecutionEnvironment``
on the same inputs and compared exactly: as lists where one subtask fixes
the order, as multisets where the JAX package fixes none.
"""

import threading

import pytest

import flink_tensorflow_tpu as jax_pkg
from flink_tensorflow_tpu.analysis.chaining import compute_chains as jax_chains
from flink_tensorflow_tpu.checkpoint import store as jax_store
from flink_tensorflow_tpu.core import elements as jax_el
from flink_tensorflow_tpu.core import functions as jax_fn
from flink_tensorflow_tpu.core.joins import IntervalJoinOperator as JaxIntervalJoin
from flink_tensorflow_tpu.core.joins import as_join_function as jax_join_fn
from flink_tensorflow_tpu.core.operators import Output as JaxOutput
from flink_tensorflow_tpu.core.runtime import JobFailure as JaxJobFailure
from flink_tensorflow_tpu.core.state import KeyedStateStore as JaxKeyedStateStore
from flink_tensorflow_tpu.core.state import StateDescriptor as JaxStateDescriptor
from flink_tensorflow_tpu.core.windows import SlidingCountTrigger as JaxSlidingCountTrigger
from flink_tensorflow_tpu_torch.analysis.chaining import compute_chains
from flink_tensorflow_tpu_torch.checkpoint import store as torch_store
from flink_tensorflow_tpu_torch.core import elements as torch_el
from flink_tensorflow_tpu_torch.core import functions as torch_fn
from flink_tensorflow_tpu_torch.core.environment import StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.core.joins import IntervalJoinOperator, as_join_function
from flink_tensorflow_tpu_torch.core.operators import Output
from flink_tensorflow_tpu_torch.core.runtime import JobFailure
from flink_tensorflow_tpu_torch.core.state import KeyedStateStore, StateDescriptor
from flink_tensorflow_tpu_torch.core.windows import SlidingCountTrigger
from test_torch_event_time import collect, crash_map, crash_once, multiset


class _P:
    def __init__(self, **kw):
        self.__dict__.update(kw)


JAX = _P(Env=jax_pkg.StreamExecutionEnvironment, fn=jax_fn, el=jax_el, store=jax_store,
         State=JaxStateDescriptor, failure=JaxJobFailure, chains=jax_chains,
         IntervalJoin=JaxIntervalJoin, join_fn=jax_join_fn, Output=JaxOutput,
         KeyedStateStore=JaxKeyedStateStore, Sliding=JaxSlidingCountTrigger)
PORT = _P(Env=StreamExecutionEnvironment, fn=torch_fn, el=torch_el, store=torch_store,
          State=StateDescriptor, failure=JobFailure, chains=compute_chains,
          IntervalJoin=IntervalJoinOperator, join_fn=as_join_function, Output=Output,
          KeyedStateStore=KeyedStateStore, Sliding=SlidingCountTrigger)
PACKAGES = {"jax": JAX, "torch": PORT}


def run_both(build, parallelism=1, throttle=0.0):
    """``build(env, package)`` returns the sink list; each package's job
    runs once.  Returns ``{package: sink}``."""
    out = {}
    for name, p in PACKAGES.items():
        env = p.Env(parallelism=parallelism)
        if throttle:
            env.source_throttle_s = throttle
        sink = build(env, p)
        env.execute(timeout=30)
        out[name] = sink
    return out


# -- connected streams (tests/test_connect_join.py) ------------------------

def tag(p):
    class Tag(p.fn.CoMapFunction):
        def map1(self, value):
            return ("left", value)

        def map2(self, value):
            return ("right", value)

    return Tag()


def test_co_map_routes_by_input():
    out = run_both(lambda env, p: env.from_collection([1, 2, 3]).connect(
        env.from_collection(["a", "b"])).map(tag(p)).sink_to_list())
    assert multiset(out["torch"]) == multiset(out["jax"])
    assert sorted(out["torch"]) == [("left", 1), ("left", 2), ("left", 3),
                                    ("right", "a"), ("right", "b")]


def test_co_flat_map():
    def build(env, p):
        class Dup(p.fn.CoFlatMapFunction):
            def flat_map1(self, value):
                return [value, value]

            def flat_map2(self, value):
                return [value]

        return env.from_collection([1]).connect(env.from_collection([9])).flat_map(Dup()) \
            .sink_to_list()

    out = run_both(build)
    assert sorted(out["torch"]) == sorted(out["jax"]) == [1, 1, 9]


def test_keyed_co_process_shares_state_across_inputs():
    """Input 2 sets a per-key factor that input 1 reads: state one input
    writes is visible to the other (same key space, same subtask)."""
    def build(env, p):
        class Scale(p.fn.CoProcessFunction):
            def open(self, ctx):
                self._factor = p.State("factor")

            def process_element1(self, value, ctx, out):
                out.collect((ctx.current_key, value["v"] * (ctx.state(self._factor).value() or 1)))

            def process_element2(self, value, ctx, out):
                ctx.state(self._factor).update(value["factor"])

        data = env.from_collection([{"k": "a", "v": i} for i in range(1, 4)] + [{"k": "b", "v": 5}])
        control = env.from_collection([{"k": "a", "factor": 10}])
        return (data.key_by(lambda r: r["k"]).connect(control.key_by(lambda r: r["k"]))
                .process(Scale(), parallelism=2).sink_to_list())

    out = run_both(build, throttle=0.01)
    for got in out.values():
        by_key = {}
        for k, v in got:
            by_key.setdefault(k, []).append(v)
        # Two sources fix no order between control and data.
        assert sorted(by_key["b"]) == [5]
        assert sorted(v if v < 10 else v // 10 for v in by_key["a"]) == [1, 2, 3]


def test_broadcast_control_reaches_every_subtask():
    seen = {}

    def build(env, p):
        lock = threading.Lock()
        controls = seen.setdefault(p, [])

        class Gate(p.fn.CoProcessFunction):
            def open(self, ctx):
                self._factor = 1
                self._subtask = ctx.subtask_index

            def process_element1(self, value, ctx, out):
                out.collect(value * self._factor)

            def process_element2(self, value, ctx, out):
                self._factor = value
                with lock:
                    controls.append(self._subtask)

        return (env.from_collection(list(range(1, 9))).rebalance()
                .connect(env.from_collection([100]).broadcast())
                .process(Gate(), parallelism=3).sink_to_list())

    out = run_both(build, throttle=0.01)
    for p, got in ((JAX, out["jax"]), (PORT, out["torch"])):
        assert sorted(seen[p]) == [0, 1, 2]
        assert len(got) == 8 and all(v % 100 == 0 or v < 9 for v in got)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_unkeyed_mixed_with_keyed_rejected(package):
    env = PACKAGES[package].Env(parallelism=1)
    keyed = env.from_collection([1]).key_by(lambda v: v)
    with pytest.raises(TypeError):
        keyed.connect(env.from_collection([2]))
    with pytest.raises(TypeError):
        env.from_collection([2]).connect(keyed)


# -- joins -----------------------------------------------------------------

ORDERS = [{"user": "u1", "t": 1.0, "order": "A"}, {"user": "u1", "t": 7.0, "order": "B"},
          {"user": "u2", "t": 2.0, "order": "C"}]
CLICKS = [{"uid": "u1", "t": 2.0, "page": "x"}, {"uid": "u1", "t": 8.0, "page": "y"},
          {"uid": "u2", "t": 9.0, "page": "z"}]


def test_window_join_within_tumbling_window():
    def build(env, p):
        s1 = env.from_collection(ORDERS).assign_timestamps(lambda r: r["t"], watermark_every=1)
        s2 = env.from_collection(CLICKS).assign_timestamps(lambda r: r["t"], watermark_every=1)
        return (s1.join(s2).where(lambda r: r["user"]).equal_to(lambda r: r["uid"]).window(5.0)
                .apply(lambda left, right: (left["order"], right["page"]), parallelism=2)
                .sink_to_list())

    out = run_both(build)
    assert sorted(out["torch"]) == sorted(out["jax"]) == [("A", "x"), ("B", "y")]


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_join_builder_validation(package):
    env = PACKAGES[package].Env(parallelism=1)
    s1, s2 = env.from_collection([1]), env.from_collection([2])
    with pytest.raises(ValueError, match="where"):
        s1.join(s2).window(5.0).apply(lambda left, right: None)
    with pytest.raises(ValueError, match="window"):
        s1.join(s2).where(lambda v: v).equal_to(lambda v: v).apply(lambda left, right: None)


def test_interval_join_pairs_within_interval():
    lefts = [{"k": "a", "t": 10.0, "v": "L10"}, {"k": "a", "t": 20.0, "v": "L20"}]
    rights = [{"k": "a", "t": 11.0, "v": "R11"}, {"k": "a", "t": 19.0, "v": "R19"},
              {"k": "a", "t": 30.0, "v": "R30"}]

    def build(env, p):
        s1 = env.from_collection(lefts).assign_timestamps(lambda r: r["t"], watermark_every=1)
        s2 = env.from_collection(rights).assign_timestamps(lambda r: r["t"], watermark_every=1)
        return (s1.key_by(lambda r: r["k"]).interval_join(s2.key_by(lambda r: r["k"]),
                                                          lower_s=-2.0, upper_s=2.0)
                .apply(lambda left, right: (left["v"], right["v"])).sink_to_list())

    out = run_both(build)
    assert sorted(out["torch"]) == sorted(out["jax"]) == [("L10", "R11"), ("L20", "R19")]


@pytest.mark.parametrize("lower,upper,arrivals,want", [
    (-2.0, 2.0, [(1, "R7.5", 7.5), ("wm", 10.0), (0, "L8.5", 8.5)], [("L8.5", "R7.5")]),
    # An interval that excludes zero: a left at 5 still pairs a right at 8
    # after the watermark reached 7.
    (2.0, 4.0, [(0, "L5", 5.0), ("wm", 7.0), (1, "R8", 8.0)], [("L5", "R8")]),
    (-2.0, 2.0, [(1, "R1", 1.0), ("wm", 10.0), (0, "L9", 9.0)], []),
], ids=["accepted_left_finds_right", "interval_without_zero", "evicted"])
def test_interval_join_eviction_mirrors_acceptance_bound(lower, upper, arrivals, want):
    """Driven at the operator (two sources fix no watermark interleaving):
    a buffered element lives as long as an arrival the operator still
    accepts could match it."""
    got = {}
    for name, p in PACKAGES.items():
        op = p.IntervalJoin("ij", p.join_fn(lambda left, right: (left, right)), lower, upper,
                            lambda v: "k", lambda v: "k")
        op.setup(None, p.Output([]), p.KeyedStateStore())
        emitted, marks = [], []
        op.output.emit = lambda v, ts=None: emitted.append((v, ts))
        op.output.broadcast_element = marks.append
        for a in arrivals:
            if a[0] == "wm":
                op.process_watermark(p.el.Watermark(a[1]))
            else:
                op.process_record_from(a[0], p.el.StreamRecord(a[1], a[2]))
        assert [v for v, _ in emitted] == want
        got[name] = (emitted, [m.timestamp for m in marks])
    assert got["torch"] == got["jax"]


def join_job(kind):
    lefts = [{"k": i % 4, "t": float(i), "v": f"L{i}"} for i in range(40)]
    rights = [{"k": i % 4, "t": float(i) + 0.5, "v": f"R{i}"} for i in range(40)]

    def build(env, p, tap, parallelism=2):
        s1 = env.from_collection(lefts, name="lefts").assign_timestamps(
            lambda r: r["t"], watermark_every=4)
        s2 = env.from_collection(rights, name="rights").assign_timestamps(
            lambda r: r["t"], watermark_every=4)
        if tap is not None:
            s1 = s1.map(tap)
        if kind == "interval":
            joined = s1.key_by(lambda r: r["k"]).interval_join(
                s2.key_by(lambda r: r["k"]), lower_s=0.0, upper_s=1.0)
        else:
            joined = s1.join(s2).where(lambda r: r["k"]).equal_to(lambda r: r["k"]).window(8.0)
        return joined.apply(lambda left, right: (left["v"], right["v"]), name="join",
                            parallelism=parallelism).sink_to_list()

    return build


@pytest.mark.parametrize("kind", ["interval", "window"])
def test_join_buffers_rescale_two_to_three(kind, tmp_path):
    """Crash at parallelism 2 after checkpoint 1, restore it at 3: the
    restored run emits only pairs of an uninterrupted run, and both runs
    together emit them all."""
    build = join_job(kind)
    got = {}
    for name, p in PACKAGES.items():
        env = p.Env(parallelism=1)
        clean = build(env, p, None)
        env.execute(timeout=30)
        assert clean
        d = str(tmp_path / name)
        env = p.Env(parallelism=1)
        env.enable_checkpointing(d, every_n_records=8)
        before = build(env, p, crash_map(p.fn, crash_once(24, p.store, d)))
        with pytest.raises(p.failure):
            env.execute(timeout=60)
        env = p.Env(parallelism=1)
        env.enable_checkpointing(d, every_n_records=8)
        after = build(env, p, None, parallelism=3)
        env.execute(timeout=60, restore_from=d, restore_checkpoint_id=1)
        assert set(after) <= set(clean) and set(before) | set(after) == set(clean), name
        got[name] = sorted(clean)
    assert got["torch"] == got["jax"]


# -- union, broadcast, side outputs, flat_map, process ---------------------

def test_union_of_three_streams():
    out = run_both(lambda env, p: env.from_collection([1, 2]).union(
        env.from_collection([10, 20]), env.from_collection([100]))
        .map(lambda v: v + 1).sink_to_list(), parallelism=2)
    assert sorted(out["torch"]) == sorted(out["jax"]) == [2, 3, 11, 21, 101]


def test_broadcast_reaches_every_subtask():
    def build(env, p):
        class WhoAmI(p.fn.MapFunction):
            def open(self, ctx):
                self.i = ctx.subtask_index

            def map(self, value):
                return (self.i, value)

        return env.from_collection([1, 2]).broadcast().map(WhoAmI(), parallelism=3) \
            .sink_to_list()

    out = run_both(build)
    assert sorted(out["torch"]) == sorted(out["jax"]) == \
        sorted((i, v) for i in range(3) for v in (1, 2))


def test_flat_map_keeps_timestamps():
    def build(env, p):
        class Stamps(p.fn.ProcessFunction):
            def process_element(self, value, ctx, out):
                out.collect((value, ctx.timestamp))

        return (env.from_collection([1.0, 2.0]).assign_timestamps(lambda t: t)
                .flat_map(lambda v: [v] * int(v)).process(Stamps()).sink_to_list())

    out = run_both(build)
    assert out["torch"] == out["jax"] == [(1.0, 1.0), (2.0, 2.0), (2.0, 2.0)]


def test_unkeyed_process_and_side_output_of_a_process():
    def build(env, p):
        class Split(p.fn.ProcessFunction):
            def process_element(self, value, ctx, out):
                out.collect(value if value % 2 else p.el.SideOutput("even", value))

        raw = env.from_collection(list(range(6))).process(Split())
        return raw.sink_to_list(), raw.side_output("even").sink_to_list()

    out = run_both(build)
    main, evens = out["torch"]
    jmain, jevens = out["jax"]
    assert evens == jevens == [0, 2, 4]
    assert [v for v in main if not isinstance(v, torch_el.SideOutput)] == \
        [v for v in jmain if not isinstance(v, jax_el.SideOutput)] == [1, 3, 5]


def test_keyed_running_reduce():
    records = [("a", 1), ("b", 10), ("a", 2), ("b", 20), ("a", 3)]
    out = run_both(lambda env, p: env.from_collection(records).key_by(lambda e: e[0])
                   .reduce(lambda acc, v: (acc[0], acc[1] + v[1])).sink_to_list(),
                   parallelism=2)
    assert multiset(out["torch"]) == multiset(out["jax"])
    assert sorted(out["torch"]) == [("a", 1), ("a", 3), ("a", 6), ("b", 10), ("b", 30)]


# -- count windows (tests/test_windows_extended.py) ------------------------

def counted(f):
    """Each fired count window as ``(key, index, size, elements)``."""
    class Counted(f.WindowFunction):
        def process_window(self, key, window, elements, out):
            out.collect((key, window.index, len(elements), list(elements)))

    return Counted()


@pytest.mark.parametrize("n,size,slide,want", [
    (10, 4, 2, [[0, 1], [0, 1, 2, 3], [2, 3, 4, 5], [4, 5, 6, 7], [6, 7, 8, 9]]),
    (7, 4, 2, [[0, 1], [0, 1, 2, 3], [2, 3, 4, 5], [4, 5, 6]]),   # the tail fires once
    (9, 2, 3, [[1, 2], [4, 5], [7, 8]]),                           # slide > size trims
], ids=["slide", "trailing_partial", "slide_larger_than_size"])
def test_sliding_count_windows(n, size, slide, want):
    out = run_both(lambda env, p: env.from_collection(list(range(n)))
                   .count_window(size, slide=slide).apply(counted(p.fn)).sink_to_list())
    assert out["torch"] == out["jax"]
    assert [w[3] for w in out["torch"]] == want


def test_keyed_sliding_count_windows():
    records = [{"k": i % 2, "v": i} for i in range(8)]
    out = run_both(lambda env, p: env.from_collection(records).key_by(lambda r: r["k"])
                   .count_window(2, slide=1).apply(counted(p.fn), parallelism=2).sink_to_list())
    assert multiset(out["torch"]) == multiset(out["jax"])
    by_key = {}
    for key, _, _, w in out["torch"]:
        by_key.setdefault(key, []).append([r["v"] for r in w])
    assert by_key == {0: [[0], [0, 2], [2, 4], [4, 6]], 1: [[1], [1, 3], [3, 5], [5, 7]]}


def test_keyed_tumbling_count_windows():
    out = run_both(lambda env, p: env.from_collection(list(range(11))).key_by(lambda v: v % 3)
                   .count_window(2).apply(counted(p.fn), parallelism=2).sink_to_list())
    assert multiset(out["torch"]) == multiset(out["jax"])
    assert sorted((k, w) for k, _, _, w in out["torch"]) == [
        (0, [0, 3]), (0, [6, 9]), (1, [1, 4]), (1, [7, 10]), (2, [2, 5]), (2, [8])]


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_count_window_validation(package):
    p = PACKAGES[package]
    with pytest.raises(ValueError):
        p.Sliding(0, 1)
    with pytest.raises(ValueError, match="timeout_s"):
        p.Env(parallelism=1).from_collection([1]).count_window(4, slide=2, timeout_s=1.0)


def test_adaptive_latency_trigger_is_refused_until_ported():
    """Ported now: the budget builds the adaptive latency trigger, one per
    subtask (``tests/test_torch_open_loop.py`` holds it to the JAX one)."""
    from flink_tensorflow_tpu_torch.core.windows import AdaptiveLatencyTrigger

    env = StreamExecutionEnvironment(parallelism=1)
    windowed = env.from_collection([1]).count_window(4, latency_budget_s=0.1)
    assert isinstance(windowed.trigger, AdaptiveLatencyTrigger)
    assert windowed.trigger.latency_budget_s == 0.1


def test_keyed_count_windows_rescale_two_to_three(tmp_path):
    def build(env, p, tap, parallelism=2):
        stream = env.from_collection(list(range(60)))
        if tap is not None:
            stream = stream.map(tap)
        return (stream.key_by(lambda v: v % 7).count_window(3).apply(
            counted(p.fn), name="counted", parallelism=parallelism).sink_to_list())

    got = {}
    for name, p in PACKAGES.items():
        env = p.Env(parallelism=1)
        clean = build(env, p, None)
        env.execute(timeout=30)
        d = str(tmp_path / name)
        env = p.Env(parallelism=1)
        env.enable_checkpointing(d, every_n_records=8)
        before = build(env, p, crash_map(p.fn, crash_once(30, p.store, d, checkpoint=3)))
        with pytest.raises(p.failure):
            env.execute(timeout=60)
        env = p.Env(parallelism=1)
        env.enable_checkpointing(d, every_n_records=8)
        after = build(env, p, None, parallelism=3)
        env.execute(timeout=60, restore_from=d, restore_checkpoint_id=1)
        # Window sequence numbers are per key, so the restored run's
        # windows are an uninterrupted run's windows.
        assert set(multiset(after)) <= set(multiset(clean)), name
        assert set(multiset(before + after)) == set(multiset(clean)), name
        got[name] = multiset(clean)
    assert got["torch"] == got["jax"]


# -- chain plans of graphs with several inputs -----------------------------

def _union_graph(env, p):
    a = env.from_collection([1], name="a").map(lambda v: v, name="ma")
    b = env.from_collection([2], name="b")
    a.union(b).map(lambda v: v, name="after").sink_to_list()


def _broadcast_graph(env, p):
    data = env.from_collection([1], name="data").map(lambda v: v, name="pre")
    ctrl = env.from_collection([2], name="ctrl")
    data.connect(ctrl.broadcast()).map(tag(p), name="co").map(lambda v: v, name="post") \
        .sink_to_list()


def _side_output_graph(env, p):
    result = (env.from_collection([1.0], name="src").assign_timestamps(lambda t: t)
              .time_window_all(1.0).apply(collect(p.fn), name="w", late_tag="late"))
    result.map(lambda v: v, name="main_post").sink_to_list()
    result.side_output("late").sink_to_list()


def _join_graph(env, p):
    s1 = env.from_collection([1.0], name="l").assign_timestamps(lambda t: t, name="lt")
    s2 = env.from_collection([1.0], name="r").assign_timestamps(lambda t: t, name="rt")
    s1.join(s2).where(lambda v: 0).equal_to(lambda v: 0).window(1.0) \
        .apply(lambda left, right: 0, name="join").map(lambda v: v, name="post").sink_to_list()


@pytest.mark.parametrize("graph", [_union_graph, _broadcast_graph, _side_output_graph,
                                   _join_graph], ids=["union", "broadcast", "side_output",
                                                      "join"])
def test_chain_plans_with_several_inputs_equal_jax(graph):
    plans = {}
    for name, p in PACKAGES.items():
        env = p.Env(parallelism=1)
        graph(env, p)
        plan = p.chains(env.graph)
        by_id = {t.id: t.name for t in env.graph.transformations}
        plans[name] = (plan.names(), {(by_id[u], by_id[d]): r
                                      for (u, d), r in plan.unchained_reasons.items()})
    assert plans["torch"] == plans["jax"]
