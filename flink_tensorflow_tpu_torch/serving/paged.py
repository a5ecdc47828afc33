"""Paged KV pool bookkeeping + radix prefix index (host-side policy).

Copy of ``flink_tensorflow_tpu/serving/paged.py``.  Pure host code, no
tensors, so the policy tests in microseconds (the same discipline as
:class:`~flink_tensorflow_tpu_torch.serving.scheduler.TokenBudgetScheduler`):

- :class:`PagedKVPool` — the free list and per-page refcounts over a
  fixed population of ``num_pages`` device pages of ``page_tokens``
  positions each.  Admission needs FREE PAGES, not a contiguous slot.  A
  page is freed when its refcount drops to zero — sessions and the prefix
  index hold refs, nobody else.
- :class:`RadixPrefixIndex` — a radix tree over full-page token spans.
  A finished session publishes its full pages keyed by the token sequence
  that produced them; a new session's admission walks its prompt down the
  tree and ADOPTS matching pages (refcount bump, no compute) instead of
  writing its own copies.  Causal K/V locality makes this sound: position
  ``p``'s K/V depends only on tokens ``0..p``.  The last adopted page may
  be matched PARTIALLY — content beyond the match is the writer's, masked
  by the adopter's lengths, and the adopter's first decode write into that
  page triggers the copy-on-write split (``cow_splits``).
- :class:`PagedKVHandle` — a preempted-but-HOT session's parked pages:
  the block table leaves the runner, the pages keep their refcounts and
  stay on the device, and re-admission re-attaches them with no traffic.
  It refuses to pickle — the barrier snapshot hook demotes it to a host
  :class:`~flink_tensorflow_tpu_torch.serving.kv_cache.KVBlock` first.

Everything here is DERIVED state: block tables, refcounts and the radix
tree rebuild empty after failover or rescale (the checkpointed truth is
the per-session host block in keyed state), which keeps key-group
redistribution working with no paged-specific restore code.
"""

from __future__ import annotations

import typing


class PagedKVHandle:
    """Parked device pages of one preempted session (hot tier).

    ``pages`` are pool page ids still refcounted by this session;
    ``length`` the valid cache positions they cover."""

    __slots__ = ("pages", "length")
    kind = "paged"

    def __init__(self, pages: typing.List[int], length: int):
        self.pages = list(pages)
        self.length = int(length)

    def __reduce__(self):
        raise TypeError(
            "PagedKVHandle references live device pages and never crosses a "
            "pickle boundary — the serving operator's snapshot hook "
            "demotes it to a host KVBlock first"
        )

    def __repr__(self) -> str:
        return f"PagedKVHandle(pages={len(self.pages)}, length={self.length})"


class PagedKVPool:
    """Free list + refcounts over the fixed page population."""

    def __init__(self, num_pages: int, page_tokens: int):
        if num_pages < 1:
            raise ValueError("num_pages must be >= 1")
        self.num_pages = num_pages
        self.page_tokens = page_tokens
        #: Stack of free page ids (low ids allocated first — determinism
        #: of page placement is what makes paged runs reproducible).
        self.free: typing.List[int] = list(range(num_pages - 1, -1, -1))
        self.refs: typing.List[int] = [0] * num_pages
        #: Adoption events: pages a session reused from the prefix index
        #: instead of writing its own copy.
        self.pages_shared = 0
        #: Copy-on-write splits: writes into a shared page that forced a
        #: private copy first.
        self.cow_splits = 0

    # -- queries ---------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self.free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self.free)

    def occupancy_frac(self) -> float:
        return self.used_pages / self.num_pages

    def pages_for(self, tokens: int) -> int:
        """Pages covering ``tokens`` cache positions."""
        return -(-max(0, tokens) // self.page_tokens)

    def is_shared(self, pid: int) -> bool:
        return self.refs[pid] > 1

    # -- transitions -----------------------------------------------------
    def alloc(self, n: int) -> typing.Optional[typing.List[int]]:
        """Allocate ``n`` pages at refcount 1, or None (caller frees
        pressure — index eviction, tier demotion — and retries)."""
        if n > len(self.free):
            return None
        out = []
        for _ in range(n):
            pid = self.free.pop()
            self.refs[pid] = 1
            out.append(pid)
        return out

    def incref(self, pid: int) -> None:
        self.refs[pid] += 1

    def decref(self, pid: int) -> bool:
        """Drop one reference; True when the page was freed."""
        self.refs[pid] -= 1
        if self.refs[pid] < 0:
            raise AssertionError(f"page {pid} refcount underflow")
        if self.refs[pid] == 0:
            self.free.append(pid)
            return True
        return False

    def release(self, pages: typing.Iterable[int]) -> int:
        """Decref a table's pages; returns how many actually freed."""
        return sum(1 for p in pages if self.decref(p))


class _RadixNode:
    __slots__ = ("tokens", "page", "children", "last_used")

    def __init__(self, tokens: typing.Tuple[int, ...], page: int,
                 clock: int):
        self.tokens = tokens          # the page's full token span
        self.page = page              # pool page id (index holds one ref)
        self.children: typing.Dict[typing.Tuple[int, ...], "_RadixNode"] = {}
        self.last_used = clock


class RadixPrefixIndex:
    """Radix tree over full-page token spans; one pool page per node.

    Match/publish are both O(prompt / page_tokens) dict walks.  The
    index holds ONE refcount per indexed page; ``evict_lru`` drops the
    least-recently-matched leaf (leaves only — an inner node's children
    would leak their refs) and is the pool's pressure valve: allocation
    failure evicts until the free list covers the request or the tree
    is bare."""

    def __init__(self, pool: PagedKVPool):
        self.pool = pool
        self._root: typing.Dict[typing.Tuple[int, ...], _RadixNode] = {}
        self._clock = 0
        #: Indexed page count (gauge fodder).
        self.indexed_pages = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # -- adoption --------------------------------------------------------
    def match(self, prompt) -> typing.Tuple[typing.List[int],
                                            typing.Optional[int]]:
        """Walk ``prompt`` down the tree: returns ``(full, partial)`` —
        page ids fully covered by the prompt plus at most one final page
        matched on a partial span.  Adopted pages are increfed here and
        counted into ``pool.pages_shared``; the caller owns releasing
        them like any allocated page."""
        pt = self.pool.page_tokens
        prompt = [int(t) for t in prompt]
        full: typing.List[int] = []
        partial: typing.Optional[int] = None
        children = self._root
        pos = 0
        clock = self._tick()
        while pos + pt <= len(prompt):
            node = children.get(tuple(prompt[pos:pos + pt]))
            if node is None:
                break
            node.last_used = clock
            full.append(node.page)
            children = node.children
            pos += pt
        rem = len(prompt) - pos
        if 0 < rem < pt:
            span = tuple(prompt[pos:])
            for tokens, node in children.items():
                if tokens[:rem] == span:
                    node.last_used = clock
                    partial = node.page
                    break
        for pid in full + ([partial] if partial is not None else []):
            self.pool.incref(pid)
            self.pool.pages_shared += 1
        return full, partial

    # -- publication -----------------------------------------------------
    def publish(self, tokens, pages: typing.Sequence[int]) -> int:
        """Index a finished session's full pages under their token
        spans.  ``tokens``: the cache-valid token sequence (prompt +
        generated-and-cached); ``pages``: the session's block table.
        Pages whose span is already indexed keep the EXISTING page (two
        identical prefixes produce identical bytes — no churn); newly
        indexed pages gain the index's refcount.  Returns the count
        newly indexed."""
        pt = self.pool.page_tokens
        tokens = [int(t) for t in tokens]
        children = self._root
        clock = self._tick()
        added = 0
        for i in range(min(len(tokens) // pt, len(pages))):
            span = tuple(tokens[i * pt:(i + 1) * pt])
            node = children.get(span)
            if node is None:
                node = _RadixNode(span, pages[i], clock)
                children[span] = node
                self.pool.incref(pages[i])
                self.indexed_pages += 1
                added += 1
            else:
                node.last_used = clock
            children = node.children
        return added

    # -- eviction --------------------------------------------------------
    def _leaves(self):
        stack = [(self._root, None, None)]
        while stack:
            children, parent, key = stack.pop()
            for k, node in children.items():
                if node.children:
                    stack.append((node.children, children, k))
                else:
                    yield children, k, node

    def evict_lru(self) -> bool:
        """Drop the least-recently-matched leaf; True if one was
        dropped (its page frees iff no live session still shares it)."""
        best = None
        for children, key, node in self._leaves():
            if best is None or node.last_used < best[2].last_used:
                best = (children, key, node)
        if best is None:
            return False
        children, key, node = best
        del children[key]
        self.indexed_pages -= 1
        self.pool.decref(node.page)
        return True

    def evict_until(self, pool_free_target: int) -> int:
        """Evict leaves until the pool's free list reaches the target or
        the tree is bare; returns evictions performed."""
        n = 0
        while self.pool.free_pages < pool_free_target and self.evict_lru():
            n += 1
        return n

    def clear(self) -> None:
        while self.evict_lru():
            pass
