"""The port's paged KV economy held to the JAX package's on the CPU: the
layout ops (``ops/paged_attention.py``), the policy objects
(``serving/paged.py``, ``serving/tiering.py``), the paged runner and the
paged pipeline on the same weights, plus the ports of every case of
``tests/test_serving_paged.py`` (the narrow model: vocab 48, embed 32, 2
heads, 2 layers, capacity 40).

Tolerances: the layout ops move bytes, so they are held bit for bit; the
paged decode attention and the runner's pages sum f32 products in another
order than XLA, held to 1e-5 (absolute and relative); tokens (greedy
argmax) are held equal.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flink_tensorflow_tpu import StreamExecutionEnvironment as JaxEnv
from flink_tensorflow_tpu import serving as jax_serving
from flink_tensorflow_tpu.functions import runner as jax_runner
from flink_tensorflow_tpu.models import get_model_def as jax_model_def
from flink_tensorflow_tpu.ops import paged_attention as jax_ops
from flink_tensorflow_tpu_torch import RestartStrategy, StreamExecutionEnvironment
from flink_tensorflow_tpu_torch.checkpoint.store import latest_checkpoint_id
from flink_tensorflow_tpu_torch.core import functions as fn
from flink_tensorflow_tpu_torch.core.runtime import JobFailure
from flink_tensorflow_tpu_torch.functions.runner import PagedDecodeStepRunner
from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
from flink_tensorflow_tpu_torch.ops import (
    dense_to_pages,
    gather_pages,
    paged_attention_decode,
    pages_per_session,
    pages_to_dense,
    scatter_pages,
)
from flink_tensorflow_tpu_torch.serving import (
    FixedWindowGenerateFunction,
    GenerateRequest,
    KVBlock,
    PagedKVHandle,
    PagedKVPool,
    RadixPrefixIndex,
    ServingConfig,
    SessionTierManager,
    SpilledKVBlock,
    continuous_batching,
)

CAPACITY = 40
CFG = dict(vocab_size=48, embed_dim=32, num_heads=2, num_layers=2, capacity=CAPACITY)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def weights():
    return get_model_def("char_transformer", **CFG).init_params(0)


@pytest.fixture(scope="module")
def model(weights):
    return get_model_def("char_transformer", **CFG).to_model(weights)


@pytest.fixture(scope="module")
def jmodel(weights):
    return jax_model_def("char_transformer", **CFG).to_model(jax.tree.map(jnp.asarray, weights))


def make_requests(n, max_new=8, seed=3, vocab=48, lo=4, hi=10, prompt=None, cls=GenerateRequest):
    rng = np.random.RandomState(seed)
    return [cls(session_id=f"s{i}",
                prompt=(np.asarray(prompt) if prompt is not None
                        else rng.randint(1, vocab, (int(rng.randint(lo, hi)),))),
                max_new_tokens=max_new)
            for i in range(n)]


def tokens_by_session(events):
    out = {}
    for ev in events:
        if ev.index < 0:
            continue
        prev = out.setdefault(ev.session_id, {}).get(ev.index)
        assert prev is None or prev == ev.token, (ev.session_id, ev.index)
        out[ev.session_id][ev.index] = ev.token
    return {sid: [toks[i] for i in sorted(toks)] for sid, toks in out.items()}


def run_pipeline(env, model, requests, config, parallelism=1, tap=None):
    env.set_device_provider(lambda task, index: "cpu")
    stream = continuous_batching(
        env.from_collection(requests, parallelism=1).key_by(lambda r: r.session_id),
        model, config=config, parallelism=parallelism)
    if tap is not None:
        stream = stream.map(tap, name="tap")
    return stream.sink_to_list()


def run_once(model, requests, config, name="job"):
    env = StreamExecutionEnvironment(parallelism=1)
    out = run_pipeline(env, model, requests, config)
    env.execute(name, timeout=300)
    return tokens_by_session(out), env.metric_registry.report()


def jax_run(jmodel, requests, config):
    env = JaxEnv(parallelism=1)
    out = jax_serving.continuous_batching(
        env.from_collection(requests, parallelism=1).key_by(lambda r: r.session_id),
        jmodel, config=config).sink_to_list()
    env.execute("jax", timeout=300)
    return tokens_by_session(out), env.metric_registry.report()


class CrashOnce(fn.MapFunction):
    """Passes TokenEvents through and raises once, at the ``at``-th."""

    def __init__(self, at):
        self.at, self.seen, self.crashed = at, 0, False

    def clone(self):
        return self  # one counter across subtasks and restarts

    def map(self, value):
        self.seen += 1
        if not self.crashed and self.seen >= self.at:
            self.crashed = True
            raise RuntimeError("injected mid-generation crash")
        return value


# -- layout ops against the JAX ops ------------------------------------------

def pools_and_tables(seed):
    """A pool of 7 pages, tables with sentinel rows, sentinel tails and
    duplicate ids (rows sharing a page carry identical bytes there, as
    prefix-shared pages do), and a dense payload."""
    rng = np.random.RandomState(seed)
    p, layers, pt, heads, hd, n = 7, 2, 4, 2, 3, 3
    pool = rng.randn(p, layers, pt, heads, hd).astype(np.float32)
    tables = np.array([[0, 3, p], [p, p, p], [0, 5, 6], [2, p, p]], np.int32)
    dense = rng.randn(len(tables), layers, n * pt, heads, hd).astype(np.float32)
    dense[2, :, :pt] = dense[0, :, :pt]      # page 0 shared by rows 0 and 2
    return pool, tables, dense


def with_scratch(pool):
    """``pool`` with one zero scratch page appended at the sentinel id."""
    return np.concatenate([pool, np.zeros_like(pool[:1])])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("op", ["gather", "scatter", "dense_pages_roundtrip"])
def test_layout_ops_equal_jax_bit_for_bit(op, seed):
    pool, tables, dense = pools_and_tables(seed)
    if op == "gather":
        want = np.asarray(jax_ops.gather_pages(jnp.asarray(pool), jnp.asarray(tables)))
        got = gather_pages(torch.from_numpy(pool), torch.from_numpy(tables)).numpy()
    elif op == "scatter":
        want = np.asarray(jax_ops.scatter_pages(jnp.asarray(pool), jnp.asarray(tables),
                                                jnp.asarray(dense), 4))
        # The port's pool carries a scratch page at the sentinel id; the
        # real pages must equal JAX's dropping scatter.
        got = scatter_pages(torch.from_numpy(with_scratch(pool)), torch.from_numpy(tables),
                            torch.from_numpy(dense), 4).numpy()[:len(pool)]
    else:
        want = np.asarray(jax_ops.pages_to_dense(jax_ops.dense_to_pages(jnp.asarray(dense), 4)))
        paged = dense_to_pages(torch.from_numpy(dense), 4)
        np.testing.assert_array_equal(paged.numpy(), np.asarray(
            jax_ops.dense_to_pages(jnp.asarray(dense), 4)))
        got = pages_to_dense(paged).numpy()
    np.testing.assert_array_equal(got, want)


def test_scatter_into_a_scratch_page_equals_the_dropping_scatter():
    """An all-sentinel row writes only the scratch page: scattering it
    alone leaves every real page as it was, and a sentinel tail of a
    real row lands in the scratch page, not in a real one."""
    pool, tables, dense = pools_and_tables(2)
    got = scatter_pages(torch.from_numpy(with_scratch(pool)), torch.from_numpy(tables[1:2]),
                        torch.from_numpy(dense[1:2]), 4).numpy()
    np.testing.assert_array_equal(got[:len(pool)], pool)
    want = np.asarray(jax_ops.scatter_pages(jnp.asarray(pool), jnp.asarray(tables[:1]),
                                            jnp.asarray(dense[:1]), 4))
    got = scatter_pages(torch.from_numpy(with_scratch(pool)), torch.from_numpy(tables[:1]),
                        torch.from_numpy(dense[:1]), 4).numpy()
    np.testing.assert_array_equal(got[:len(pool)], want)
    np.testing.assert_array_equal(got[len(pool)], dense_to_pages(dense[:1], 4)[0, 2])


def test_gather_is_a_copy_not_a_view():
    pool, tables, _ = pools_and_tables(0)
    t = torch.from_numpy(pool.copy())
    out = gather_pages(t, torch.from_numpy(tables))
    assert out.is_contiguous() and out.data_ptr() != t.data_ptr()
    t.add_(1.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(
        jax_ops.gather_pages(jnp.asarray(pool), jnp.asarray(tables))))


def test_paged_attention_decode_equals_jax():
    rng = np.random.RandomState(4)
    p, pt, heads, hd = 9, 4, 2, 8
    k_pool = rng.randn(p, pt, heads, hd).astype(np.float32)
    v_pool = rng.randn(p, pt, heads, hd).astype(np.float32)
    tables = np.array([[1, 4, p], [0, 2, 3], [p, p, p], [5, 5, 8]], np.int32)
    lengths = np.array([6, 12, 0, 9], np.int32)
    q = rng.randn(4, heads, hd).astype(np.float32)
    want = np.asarray(jax_ops.paged_attention_decode(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool), jnp.asarray(tables),
        jnp.asarray(lengths)))
    got = paged_attention_decode(*(torch.from_numpy(a) for a in
                                   (q, k_pool, v_pool, tables, lengths))).numpy()
    np.testing.assert_allclose(got, want, **TOL)


# -- policy objects against the JAX objects -----------------------------------

def pool_state(pool):
    return (list(pool.free), list(pool.refs), pool.pages_shared, pool.cow_splits)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_and_radix_index_follow_jax(seed):
    """The same seeded sequence of allocations, references, publications,
    matches and evictions leaves equal free lists, refcounts, counters and
    match results."""
    rng = np.random.RandomState(seed)
    ours, theirs = PagedKVPool(16, 4), jax_serving.PagedKVPool(16, 4)
    idx, jidx = RadixPrefixIndex(ours), jax_serving.RadixPrefixIndex(theirs)
    held = []   # page lists a "session" holds (the same ids in both)
    for _ in range(200):
        op = rng.randint(6)
        if op == 0:
            n = int(rng.randint(0, 5))
            got = ours.alloc(n)
            assert got == theirs.alloc(n)
            if got:
                held.append(got)
        elif op == 1 and held:
            pages = held.pop(int(rng.randint(len(held))))
            assert ours.release(pages) == theirs.release(pages)
        elif op == 2 and held:
            pages = held[int(rng.randint(len(held)))]
            tokens = list(rng.randint(0, 3, len(pages) * 4 + int(rng.randint(0, 4))))
            assert idx.publish(tokens, pages) == jidx.publish(tokens, pages)
        elif op == 3:
            prompt = list(rng.randint(0, 3, int(rng.randint(1, 14))))
            full, partial = idx.match(prompt)
            assert (full, partial) == jidx.match(prompt)
            adopted = full + ([partial] if partial is not None else [])
            if adopted:
                held.append(adopted)
        elif op == 4:
            target = int(rng.randint(0, 17))
            assert idx.evict_until(target) == jidx.evict_until(target)
        elif op == 5 and held:
            pid = held[int(rng.randint(len(held)))][0]
            ours.incref(pid)
            theirs.incref(pid)
            held.append([pid])
        assert pool_state(ours) == pool_state(theirs)
        assert idx.indexed_pages == jidx.indexed_pages
        assert ours.free_pages == theirs.free_pages
        assert ours.occupancy_frac() == theirs.occupancy_frac()


@pytest.mark.parametrize("seed", [0, 1])
def test_tier_manager_follows_jax(seed, tmp_path):
    """The same seeded sequence of rung moves, watermark sweeps and
    overflow spills leaves equal rungs (in LRU order), churn counters and
    spill payloads (the file names differ: the port's carries the length)."""
    kw = dict(host_cache_sessions=2, high_watermark=0.6, low_watermark=0.3)
    managers = (SessionTierManager(spill_dir=str(tmp_path / "port"), **kw),
                jax_serving.SessionTierManager(spill_dir=str(tmp_path / "jax"), **kw))
    blocks = (KVBlock, jax_serving.KVBlock)
    rng = np.random.RandomState(seed)
    spilled = []
    for _ in range(150):
        key, op = f"k{rng.randint(8)}", rng.randint(6)
        if op < 4:
            tier = [None, "warm", "cold"][rng.randint(3)]
            for mgr in managers:
                if op == 0:
                    mgr.note_parked(key)
                elif op == 1:
                    mgr.note_warm(key)
                elif op == 2:
                    mgr.note_admitted(key, tier=tier)
                else:
                    mgr.note_gone(key)
        elif op == 4:
            start, outs = float(rng.rand()), []
            for mgr in managers:
                occ, out = [start], []
                for k in mgr.demotions(lambda: occ[0]):
                    out.append(k)
                    mgr.demoted += 1
                    mgr.note_warm(k)
                    occ[0] -= 0.15
                outs.append(out)
            assert outs[0] == outs[1]
        else:
            keys = [mgr.overflow_spills() for mgr in managers]
            assert keys[0] == keys[1]
            for k in keys[0]:
                k_arr = rng.randn(2, 8, 2, 4).astype(np.float32)
                length = int(rng.randint(1, 8))
                stubs = [mgr.spill(k, cls(k_arr, -k_arr, length))
                         for mgr, cls in zip(managers, blocks)]
                # Revived at once: the reference's next spill of the same
                # key overwrites its file (test_respill_keeps_...).
                back = [mgr.revive(stub) for mgr, stub in zip(managers, stubs)]
                np.testing.assert_array_equal(back[0].k, back[1].k)
                np.testing.assert_array_equal(back[0].v, back[1].v)
                assert back[0].length == back[1].length == length
                spilled.append(stubs)
        ours, theirs = managers
        assert (list(ours.parked), list(ours.warm)) == (list(theirs.parked), list(theirs.warm))
        assert (ours.demoted, ours.spilled, ours.revived_warm, ours.revived_cold,
                ours.tier_moves, ours.spill_bytes) == (
            theirs.demoted, theirs.spilled, theirs.revived_warm, theirs.revived_cold,
            theirs.tier_moves, theirs.spill_bytes)
    assert spilled


def test_demotions_follow_jax_through_a_drain(tmp_path):
    """The watermark sweep and forced demotions yield the same keys in the
    same order as the JAX generator while the caller frees pages."""
    kw = dict(spill_dir=None, host_cache_sessions=4, high_watermark=0.6, low_watermark=0.3)
    for force in (0, 3):
        runs = []
        for cls in (SessionTierManager, jax_serving.SessionTierManager):
            mgr = cls(**kw)
            for k in "abcdef":
                mgr.note_parked(k)
            used = [9]
            out = []
            for k in mgr.demotions(lambda: used[0] / 10, force_pages=force,
                                   free_pages=lambda: 10 - used[0]):
                out.append(k)
                mgr.note_warm(k)
                used[0] -= 1
            runs.append((out, list(mgr.parked), list(mgr.warm)))
        assert runs[0] == runs[1]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_spill_files_cross_packages(writer, tmp_path):
    rng = np.random.RandomState(5)
    k = rng.randn(2, 16, 2, 4).astype(np.float32)
    v = rng.randn(2, 16, 2, 4).astype(np.float32)
    kw = dict(spill_dir=str(tmp_path), host_cache_sessions=0, high_watermark=0.9,
              low_watermark=0.7)
    port_mgr, jax_mgr = SessionTierManager(**kw), jax_serving.SessionTierManager(**kw)
    if writer == "jax":
        stub = jax_mgr.spill("a", jax_serving.KVBlock(k, v, 11))
        block = port_mgr.revive(SpilledKVBlock(stub.path, stub.length, stub.nbytes_disk))
    else:
        stub = port_mgr.spill("a", KVBlock(k, v, 11))
        block = jax_mgr.revive(jax_serving.SpilledKVBlock(stub.path, stub.length))
    np.testing.assert_array_equal(block.k, k)
    np.testing.assert_array_equal(block.v, v)
    assert block.length == 11


def test_respill_keeps_an_older_checkpoints_file(tmp_path):
    """A session spilled at length 5 (the stub a checkpoint keeps), revived
    and spilled again at length 9: the older stub still revives.  The
    reference names the file by the key alone, so its second spill
    overwrites the first and the older stub fails its length check."""
    mgr = SessionTierManager(spill_dir=str(tmp_path), host_cache_sessions=0,
                             high_watermark=0.9, low_watermark=0.7)
    k = np.ones((2, 16, 2, 4), np.float32)
    old = mgr.spill("a", KVBlock(k, k, 5))
    new = mgr.spill("a", KVBlock(2 * k, 2 * k, 9))
    assert mgr.revive(old).length == 5 and mgr.revive(new).length == 9
    np.testing.assert_array_equal(mgr.revive(old).k, k)
    jmgr = jax_serving.SessionTierManager(spill_dir=str(tmp_path / "jax"), host_cache_sessions=0,
                                          high_watermark=0.9, low_watermark=0.7)
    jold = jmgr.spill("a", jax_serving.KVBlock(k, k, 5))
    jmgr.spill("a", jax_serving.KVBlock(k, k, 9))
    with pytest.raises(RuntimeError, match="carries length"):
        jmgr.revive(jold)


# -- the paged runner against the JAX runner ----------------------------------

def test_paged_runner_follows_jax_runner(model, jmodel):
    """Prefill, decode, a finished session's publication, an adoption with
    a copy-on-write split, park, attach and a snapshot: equal tokens,
    tables and refcounts; pages within 1e-5."""
    kw = dict(pool_slots=3, capacity=CAPACITY, page_tokens=8, num_pages=12,
              prompt_buckets=(8, 16, 32, 40))
    ours = PagedDecodeStepRunner(model, device="cpu", **kw)
    theirs = jax_runner.PagedDecodeStepRunner(jmodel, **kw)
    ours.open()
    theirs.open()
    shared = np.arange(1, 13)
    other = np.array([7, 3, 9, 1, 22, 5], np.int32)

    def both(method, *args, **kwargs):
        a = getattr(ours, method)(*args, **kwargs)
        b = getattr(theirs, method)(*args, **kwargs)
        return a, b

    def check():
        np.testing.assert_allclose(ours._kc[:12].numpy(), np.asarray(theirs._kc), **TOL)
        np.testing.assert_allclose(ours._vc[:12].numpy(), np.asarray(theirs._vc), **TOL)
        assert ours._tables == theirs._tables
        assert pool_state(ours.pool) == pool_state(theirs.pool)

    lengths = {0: 12, 1: 6}
    last = {}
    a, b = both("prefill", [shared, other], [12, 6], [0, 1], batch_bucket=2)
    np.testing.assert_array_equal(a, b)
    last = {0: int(a[0]), 1: int(a[1])}
    check()

    def step(slots):
        for s in slots:
            wa, wb = both("ensure_writable", s, lengths[s])
            assert wa == wb
        toks = [last.get(s, 0) if s in slots else 0 for s in range(3)]
        lens = [lengths.get(s, 0) if s in slots else 0 for s in range(3)]
        a, b = both("decode_step", toks, lens, list(slots))
        for s in slots:
            assert a[s] == b[s]
            last[s] = int(a[s])
            lengths[s] += 1
        check()

    for _ in range(5):
        step([0, 1])
    # Slot 0 finishes: 17 cached tokens publish 2 full pages of 8.
    cached = list(shared) + [5] * 5
    both("release_finished", 0, cached, lengths.pop(0))
    assert ours.index.indexed_pages == theirs.index.indexed_pages == 2
    check()
    # A new session with the first 12 tokens adopts page 0 and page 1
    # partially; its first write at position 12 splits page 1.
    a, b = both("prefill", [shared], [12], [2], batch_bucket=1)
    np.testing.assert_array_equal(a, b)
    last[2], lengths[2] = int(a[0]), 12
    step([1, 2])
    assert ours.pool.cow_splits == theirs.pool.cow_splits == 1
    handle, jhandle = both("park", 1, lengths[1])
    assert handle.pages == jhandle.pages and handle.length == jhandle.length
    step([2])
    both("attach", 0, handle)
    lengths[0], last[0] = lengths.pop(1), last.pop(1)
    step([0, 2])
    (k, v), (jk, jv) = both("snapshot_block", 2, lengths[2])
    np.testing.assert_allclose(k, np.asarray(jk), **TOL)
    np.testing.assert_allclose(v, np.asarray(jv), **TOL)
    ours.close()
    theirs.close()


@pytest.mark.parametrize("method", ["snapshot_block", "extract_host", "demote_handle"])
def test_host_blocks_are_not_views_of_a_cpu_pool(model, method):
    runner = PagedDecodeStepRunner(model, pool_slots=2, capacity=CAPACITY, page_tokens=8,
                                   device="cpu")
    runner.open()
    runner.prefill([np.arange(1, 20)], [19], [0], batch_bucket=1)
    if method == "demote_handle":
        k, v = runner.demote_handle(runner.park(0, 19)).k, None
    else:
        k, v = getattr(runner, method)(0, 19)
    for pool in (runner._kc, runner._vc):
        assert not np.shares_memory(k, pool.numpy())
    before = k.copy()
    runner._kc.add_(1.0)
    np.testing.assert_array_equal(k, before)
    runner.close()


def test_park_handle_refuses_to_pickle():
    with pytest.raises(TypeError, match="pickle boundary"):
        pickle.dumps(PagedKVHandle([1, 2], 9))


def test_paged_runner_refuses_exact_shapes_and_a_pool_too_small(model):
    with pytest.raises(ValueError, match="padding_buckets"):
        PagedDecodeStepRunner(model, pool_slots=2, capacity=CAPACITY, padding_buckets=False,
                              device="cpu")
    with pytest.raises(ValueError, match="cannot seat"):
        PagedDecodeStepRunner(model, pool_slots=2, capacity=CAPACITY, page_tokens=8,
                              num_pages=4, device="cpu")


# -- ports of tests/test_serving_paged.py -------------------------------------

class TestPageLayout:
    def test_dense_pages_roundtrip(self):
        rng = np.random.RandomState(0)
        x = torch.from_numpy(rng.randn(3, 2, 32, 2, 4).astype(np.float32))
        paged = dense_to_pages(x, 8)
        assert tuple(paged.shape) == (3, 4, 2, 8, 2, 4)
        np.testing.assert_array_equal(pages_to_dense(paged).numpy(), x.numpy())

    def test_capacity_must_divide(self):
        with pytest.raises(ValueError):
            pages_per_session(40, 16)
        assert pages_per_session(40, 8) == 5


class TestPagedKVPool:
    def test_alloc_refcount_free(self):
        pool = PagedKVPool(4, 8)
        a = pool.alloc(3)
        assert a == [0, 1, 2] and pool.free_pages == 1
        assert pool.alloc(2) is None  # never partial
        pool.incref(1)
        assert pool.is_shared(1)
        assert pool.release(a) == 2  # page 1 still referenced
        assert pool.decref(1)
        assert pool.free_pages == 4

    def test_decref_underflow_is_loud(self):
        pool = PagedKVPool(2, 8)
        (pid,) = pool.alloc(1)
        pool.decref(pid)
        with pytest.raises(AssertionError):
            pool.decref(pid)

    def test_pages_for(self):
        pool = PagedKVPool(8, 8)
        assert [pool.pages_for(n) for n in (0, 1, 8, 9, 16)] == [0, 1, 1, 2, 2]


class TestRadixPrefixIndex:
    def test_publish_then_match_full_and_partial(self):
        pool = PagedKVPool(8, 4)
        idx = RadixPrefixIndex(pool)
        pages = pool.alloc(3)
        assert idx.publish(list(range(10)), pages) == 2
        assert idx.indexed_pages == 2
        full, partial = idx.match(list(range(9)))
        assert full == pages[:2] and partial is None
        full, partial = idx.match(list(range(6)))
        assert full == [pages[0]] and partial == pages[1]
        assert pool.pages_shared == 2 + 2

    def test_publish_existing_span_keeps_existing_page(self):
        pool = PagedKVPool(8, 4)
        idx = RadixPrefixIndex(pool)
        a = pool.alloc(1)
        b = pool.alloc(1)
        assert idx.publish(list(range(4)), a) == 1
        assert idx.publish(list(range(4)), b) == 0
        assert idx.indexed_pages == 1

    def test_evict_until_frees_leaves_lru_first(self):
        pool = PagedKVPool(2, 2)
        idx = RadixPrefixIndex(pool)
        p1 = pool.alloc(2)
        idx.publish([1, 2, 3, 4], p1)
        pool.release(p1)
        assert pool.free_pages == 0
        idx.evict_until(1)
        assert pool.free_pages == 1 and idx.indexed_pages == 1
        idx.clear()
        assert pool.free_pages == 2 and idx.indexed_pages == 0


class TestTiering:
    def test_spilled_block_pickles(self):
        s = SpilledKVBlock("/spill/x.blk", 17, 1234)
        t = pickle.loads(pickle.dumps(s))
        assert (t.path, t.length, t.nbytes_disk) == ("/spill/x.blk", 17, 1234)

    def test_spill_revive_roundtrip_byte_identical(self, tmp_path):
        mgr = SessionTierManager(spill_dir=str(tmp_path), host_cache_sessions=1,
                                 high_watermark=0.9, low_watermark=0.7)
        rng = np.random.RandomState(1)
        k = rng.randn(2, 16, 2, 4).astype(np.float32)
        v = rng.randn(2, 16, 2, 4).astype(np.float32)
        mgr.note_warm("a")
        spilled = mgr.spill("a", KVBlock(k, v, 9))
        assert os.path.exists(spilled.path) and mgr.spilled == 1
        block = mgr.revive(spilled)
        np.testing.assert_array_equal(block.k, k)
        np.testing.assert_array_equal(block.v, v)
        assert block.length == 9

    def test_revive_missing_file_is_loud_not_recompute(self, tmp_path):
        mgr = SessionTierManager(spill_dir=str(tmp_path), host_cache_sessions=1,
                                 high_watermark=0.9, low_watermark=0.7)
        with pytest.raises(RuntimeError, match="vanished"):
            mgr.revive(SpilledKVBlock(str(tmp_path / "gone.blk"), 5))

    def test_overflow_spills_oldest_warm_first(self, tmp_path):
        mgr = SessionTierManager(spill_dir=str(tmp_path), host_cache_sessions=2,
                                 high_watermark=0.9, low_watermark=0.7)
        for key in ("a", "b", "c", "d"):
            mgr.note_warm(key)
        assert mgr.overflow_spills() == ["a", "b"]
        mgr2 = SessionTierManager(spill_dir=None, host_cache_sessions=0,
                                  high_watermark=0.9, low_watermark=0.7)
        mgr2.note_warm("x")
        assert mgr2.overflow_spills() == []


class TestPagedEqualsDense:
    def test_paged_byte_identical_to_dense(self, model):
        reqs = make_requests(8, max_new=10, seed=5)
        dense, _ = run_once(model, reqs, ServingConfig(
            max_active_seqs=4, token_budget=256, capacity=CAPACITY))
        paged, rep = run_once(model, reqs, ServingConfig(
            max_active_seqs=4, token_budget=256, capacity=CAPACITY,
            paged_kv=True, page_tokens=8))
        assert dense == paged
        assert rep["continuous_batching.0.kv_pages_total"] == 4 * 5

    def test_prefix_sharing_byte_identical_and_counts(self, model):
        reqs = make_requests(8, max_new=8, prompt=np.arange(1, 13))
        cfg = dict(max_active_seqs=2, token_budget=256, capacity=CAPACITY,
                   paged_kv=True, page_tokens=8)
        shared, rep = run_once(model, reqs, ServingConfig(**cfg))
        unshared, _ = run_once(model, reqs, ServingConfig(**cfg, prefix_sharing=False))
        assert shared == unshared
        assert len({tuple(v) for v in shared.values()}) == 1
        assert rep["continuous_batching.0.kv_pages_shared"] >= 2
        assert rep["continuous_batching.0.kv_cow_splits"] >= 1
        assert rep["continuous_batching.0.kv_indexed_pages"] >= 1

    def test_8x_oversubscription_zero_loss_byte_identical(self, model, tmp_path):
        reqs = make_requests(24, max_new=8, seed=7)
        dense, _ = run_once(model, reqs, ServingConfig(
            max_active_seqs=4, token_budget=2048, capacity=CAPACITY))
        paged, rep = run_once(model, reqs, ServingConfig(
            max_active_seqs=4, token_budget=40, capacity=CAPACITY,
            paged_kv=True, page_tokens=8, hbm_pages=9, prefix_sharing=False,
            tier_high_watermark=0.6, tier_low_watermark=0.3,
            host_cache_sessions=0, spill_dir=str(tmp_path)))
        assert dense.keys() == paged.keys()
        assert dense == paged
        pre = "continuous_batching.0."
        assert rep[pre + "kv_demoted_sessions"] >= 1
        assert rep[pre + "kv_spilled_sessions"] >= 1
        assert rep[pre + "kv_revived_cold"] >= 1
        assert rep[pre + "kv_tier_moves"] >= 4


FAILOVER = dict(max_active_seqs=3, token_budget=60, capacity=CAPACITY, paged_kv=True,
                page_tokens=8, hbm_pages=12, prefix_sharing=False, tier_high_watermark=0.6,
                tier_low_watermark=0.3, host_cache_sessions=0)


class TestPagedFailover:
    def test_spilled_sessions_revive_byte_identical_across_failover(self, model, tmp_path):
        reqs = make_requests(10, max_new=24, seed=2)
        cfg = ServingConfig(**FAILOVER, spill_dir=str(tmp_path / "spill"))
        ref, _ = run_once(model, reqs, cfg, "ref")
        assert all(len(v) == 24 for v in ref.values())
        tap = CrashOnce(at=120)
        env = StreamExecutionEnvironment(parallelism=1)
        env.enable_checkpointing(str(tmp_path / "chk"), every_n_records=4)
        env.source_throttle_s = 0.01
        out = run_pipeline(env, model, reqs, cfg, tap=tap)
        result = env.execute("crash", timeout=300,
                             restart_strategy=RestartStrategy(max_restarts=2))
        assert result.restarts == 1 and tap.crashed
        got = tokens_by_session(out)
        assert got == ref
        rep = env.metric_registry.report()
        assert rep["continuous_batching.0.kv_spilled_sessions"] >= 1
        assert rep["continuous_batching.0.kv_revived_cold"] >= 1


# -- the paged pipeline against the JAX one, rescale, baseline -----------------

@pytest.mark.parametrize("arm", ["roomy", "8x_tiered", "prefix"])
def test_paged_pipeline_equals_jax_paged_pipeline(model, jmodel, arm, tmp_path):
    if arm == "prefix":
        prompt = np.arange(1, 13)
        kw = dict(max_active_seqs=2, token_budget=256, capacity=CAPACITY, paged_kv=True,
                  page_tokens=8)
        reqs, jreqs = (make_requests(8, prompt=prompt, cls=c)
                       for c in (GenerateRequest, jax_serving.GenerateRequest))
    else:
        kw = dict(max_active_seqs=4, token_budget=256, capacity=CAPACITY, paged_kv=True,
                  page_tokens=8)
        if arm == "8x_tiered":
            kw.update(token_budget=40, hbm_pages=9, prefix_sharing=False,
                      tier_high_watermark=0.6, tier_low_watermark=0.3, host_cache_sessions=0)
        reqs, jreqs = (make_requests(16, seed=7, cls=c)
                       for c in (GenerateRequest, jax_serving.GenerateRequest))
    ours, rep = run_once(model, reqs, ServingConfig(**kw, spill_dir=str(tmp_path / "port")))
    theirs, jrep = jax_run(jmodel, jreqs, jax_serving.ServingConfig(
        **kw, spill_dir=str(tmp_path / "jax")))
    assert ours == theirs and len(ours) == len(reqs)
    for key in ("kv_pages_total", "kv_pages_shared", "kv_cow_splits", "kv_spilled_sessions",
                "kv_revived_cold", "kv_tier_moves"):
        assert rep[f"continuous_batching.0.{key}"] == jrep[f"continuous_batching.0.{key}"], key


def test_paged_rescale_2_to_3(model, tmp_path):
    """Crash at parallelism 2 with the paged, tiered pool, restore at 3:
    sessions cross subtasks as host or spilled blocks (pages never do),
    and the union of both runs equals an uninterrupted run."""
    cfg = ServingConfig(**{**FAILOVER, "hbm_pages": 15}, spill_dir=str(tmp_path / "spill"))
    reqs = make_requests(12, max_new=24, seed=4)
    env = StreamExecutionEnvironment(parallelism=1)
    want_out = run_pipeline(env, model, reqs, cfg, parallelism=2)
    env.execute("ref", timeout=300)
    want = tokens_by_session(want_out)
    d = str(tmp_path / "chk")
    env1 = StreamExecutionEnvironment(parallelism=1)
    env1.enable_checkpointing(d, every_n_records=4)
    out1 = run_pipeline(env1, model, reqs, cfg, parallelism=2, tap=CrashOnce(at=150))
    with pytest.raises(JobFailure):
        env1.execute("phase1", timeout=300)
    cid = latest_checkpoint_id(d)
    assert cid is not None
    env2 = StreamExecutionEnvironment(parallelism=1)
    out2 = run_pipeline(env2, model, reqs, cfg, parallelism=3)
    env2.execute("rescaled", restore_from=d, restore_checkpoint_id=cid, timeout=300)
    assert tokens_by_session(list(out1) + list(out2)) == want
    assert tokens_by_session(list(out2))
    rep = env2.metric_registry.report()
    assert sum(v for k, v in rep.items() if k.endswith(".kv_revived_warm")) \
        + sum(v for k, v in rep.items() if k.endswith(".kv_revived_cold")) >= 1


def test_fixed_window_baseline_generates_the_same_tokens(model, jmodel):
    """The port's baseline emits the JAX baseline's tokens under the same
    ``count_window(3)`` on the same requests and weights, and the tokens
    the continuous path emits."""
    kw = dict(max_active_seqs=4, token_budget=500, capacity=CAPACITY)
    reqs, jreqs = (make_requests(6, max_new=6, seed=8, cls=c)
                   for c in (GenerateRequest, jax_serving.GenerateRequest))
    env = StreamExecutionEnvironment(parallelism=1)
    env.set_device_provider(lambda task, index: "cpu")
    out = (env.from_collection(reqs, parallelism=1).count_window(3)
           .apply(FixedWindowGenerateFunction(model, ServingConfig(**kw)), name="fixed")
           .sink_to_list())
    env.execute("fixed", timeout=300)
    fixed = tokens_by_session(out)
    jenv = JaxEnv(parallelism=1)
    jout = (jenv.from_collection(jreqs, parallelism=1).count_window(3)
            .apply(jax_serving.FixedWindowGenerateFunction(
                jmodel, jax_serving.ServingConfig(**kw)), name="fixed")
            .sink_to_list())
    jenv.execute("jax-fixed", timeout=300)
    assert fixed == tokens_by_session(jout) and len(fixed) == 6
    ref, _ = run_once(model, reqs, ServingConfig(**kw))
    assert fixed == ref


def test_exact_shapes_equal_padded_buckets(model, jmodel):
    """``padding_buckets=False`` runs every step at its own shape (active
    rows only, exact prompt lengths) and emits the JAX package's tokens
    under the same setting, and the padded run's."""
    kw = dict(max_active_seqs=3, token_budget=40, capacity=CAPACITY)
    reqs, jreqs = (make_requests(7, max_new=9, seed=6, cls=c)
                   for c in (GenerateRequest, jax_serving.GenerateRequest))
    exact, _ = run_once(model, reqs, ServingConfig(**kw, padding_buckets=False))
    theirs, _ = jax_run(jmodel, jreqs, jax_serving.ServingConfig(**kw, padding_buckets=False))
    assert exact == theirs and len(exact) == 7
    padded, _ = run_once(model, reqs, ServingConfig(**kw))
    assert exact == padded


def test_runner_module_loads_no_serving_module():
    """The generic runner, which every model job imports, leaves the
    serving package (pool, tiering, operator) unloaded until a paged
    runner is built."""
    import subprocess
    import sys

    code = ("import sys, flink_tensorflow_tpu_torch.functions.runner; "
            "print(sorted(m for m in sys.modules if '.serving' in m))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    assert out.strip() == "[]", out


def test_paged_requires_padding_buckets(model):
    env = StreamExecutionEnvironment(parallelism=1)
    run_pipeline(env, model, make_requests(2), ServingConfig(
        capacity=CAPACITY, paged_kv=True, page_tokens=8, padding_buckets=False))
    with pytest.raises(JobFailure) as info:
        env.execute("exact-paged", timeout=60)
    assert "padding_buckets" in str(info.value.__cause__)
