"""Radix prefix index over token-id page blocks.

Maps prompt prefixes onto already-resident KV pages, at page granularity: a
node keys one ``page_size``-token block and names the physical page holding
that block's K/V. A path from the root spells a prompt prefix, so walking a
new prompt down the tree yields every resident page it can share — the
SGLang/vLLM radix-cache design on this repo's allocator.

This is the reference package's index (``src/repro/cache/prefix.py``),
kept as the port's own copy (pure Python, on the port's allocator).

Why this is sound: under greedy decoding with causal attention and absolute
rotary positions, K/V at position i is a pure function of tokens 0..i.
Requests agreeing on their first m tokens therefore compute bit-identical
K/V for positions < m — the exact invariant the differential harness
asserts — so serving one request's pages to another changes nothing about
its output, only about what must be recomputed.

Ownership: the index holds one allocator *pin* per node (one extra
refcount), keeping cached prefixes resident after their writers retire.
Eviction unpins LRU leaves whose page nobody else references — recency
order via the allocator's per-page ``last_use`` clock, leaves-first so an
interior page is never dropped while a descendant still chains through it.

Only *fully written, full* pages are indexed (a prompt's partial tail page
never is — its unwritten rows would leak another request's stale K/V), so
an indexed page is immutable: its holder never writes it again (decode
appends past the prompt) and sharers fork before writing (copy-on-write,
``PageAllocator.fork_page``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.cache.paged import PageAllocator


@dataclasses.dataclass
class _Node:
    key: tuple                   # this block's page_size token ids
    page: int                    # physical page holding the block's K/V
    parent: Optional["_Node"]
    children: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class PrefixHit:
    """One prompt's prefix-cache lookup result.

    ``pages`` cover the first ``len(pages) * page_size`` prompt tokens
    outright. ``fork_src``/``fork_len`` extend the hit sub-page: the next
    block diverges from a resident page after ``fork_len`` tokens, so a
    copy-on-write fork of ``fork_src`` inherits those rows and only the
    divergent tail recomputes. ``matched`` counts every reusable token.
    """

    pages: list
    matched: int
    fork_src: Optional[int] = None
    fork_len: int = 0


class PrefixIndex:
    """Radix tree mapping token-block paths to resident physical pages."""

    def __init__(self, allocator: PageAllocator):
        self.allocator = allocator
        self.page_size = allocator.page_size
        # one radix root per KV precision: a block cached on
        # an int8 page holds *rounded* K/V, so it must never satisfy a
        # native-precision request (and vice versa) — precision-keyed trees
        # make cross-precision hits structurally impossible rather than
        # filtered.
        self._roots: dict[str, _Node] = {}
        self._by_page: dict[int, _Node] = {}
        self._clock = 0
        self.hit_tokens = 0          # prompt tokens served from cache
        self.inserted_pages = 0
        self.evicted_pages = 0

    def __len__(self) -> int:
        return len(self._by_page)

    def _root_for(self, precision: str) -> _Node:
        if precision not in self._roots:
            self._roots[precision] = _Node(key=(), page=-1, parent=None)
        return self._roots[precision]

    # ------------------------------------------------------------- lookup
    def _walk(self, tokens: np.ndarray, touch: bool,
              precision: str) -> PrefixHit:
        ps = self.page_size
        toks = [int(t) for t in tokens]
        node, pages = self._root_for(precision), []
        i = 0
        while i + ps <= len(toks):
            child = node.children.get(tuple(toks[i:i + ps]))
            if child is None:
                break
            pages.append(child.page)
            if touch:
                self._clock += 1
                self.allocator.touch(child.page, self._clock)
            node, i = child, i + ps
        # partial tail: the longest common sub-block prefix among the
        # children of the deepest matched node (ties break on insertion
        # order — the choice affects only which page is forked, never the
        # tokens produced, so any deterministic rule preserves equivalence)
        tail = toks[i:i + ps]
        best, best_len = None, 0
        for key, child in node.children.items():
            m = 0
            for a, b in zip(tail, key, strict=False):
                if a != b:
                    break
                m += 1
            if m > best_len:
                best, best_len = child, m
        hit = PrefixHit(pages=pages, matched=len(pages) * ps)
        if best is not None:
            if touch:
                self._clock += 1
                self.allocator.touch(best.page, self._clock)
            hit.fork_src, hit.fork_len = best.page, best_len
            hit.matched += best_len
        return hit

    def lookup(self, tokens: np.ndarray,
               precision: str = "native") -> PrefixHit:
        """Resident same-precision prefix of ``tokens`` (touches LRU)."""
        return self._walk(tokens, touch=True, precision=precision)

    def peek_tokens(self, tokens: np.ndarray,
                    precision: str = "native") -> int:
        """Matched-token count without touching LRU state — the router's
        prefix-affinity probe (a rejected route must not refresh pages)."""
        return self._walk(tokens, touch=False, precision=precision).matched

    # ------------------------------------------------------------- insert
    def insert(self, tokens: np.ndarray, pages: list,
               precision: str = "native") -> int:
        """Index a prompt's fully-written full pages under its precision;
        returns pages newly pinned. ``pages`` is the holder's block-table
        prefix — one physical page per full ``page_size`` block of
        ``tokens``. Blocks already indexed keep their incumbent page (first
        writer wins; the duplicate copy stays exclusive to its holder and
        dies with it)."""
        ps = self.page_size
        toks = [int(t) for t in tokens]
        node, added = self._root_for(precision), 0
        for j in range(min(len(toks) // ps, len(pages))):
            key = tuple(toks[j * ps:(j + 1) * ps])
            child = node.children.get(key)
            if child is None:
                page = pages[j]
                if page in self._by_page:   # already indexed under another
                    break                   # path; never double-pin a page
                self.allocator.pin(page, key)
                self._clock += 1
                self.allocator.touch(page, self._clock)
                child = _Node(key=key, page=page, parent=node)
                node.children[key] = child
                self._by_page[page] = child
                added += 1
            node = child
        self.inserted_pages += added
        return added

    # ------------------------------------------------------------ eviction
    def _evictable_leaves(self) -> list:
        return [n for n in self._by_page.values()
                if not n.children and self.allocator.refcount(n.page) == 1]

    def _drop_node(self, node: _Node) -> None:
        del node.parent.children[node.key]
        del self._by_page[node.page]
        self.allocator.unpin(node.page)
        self.evicted_pages += 1

    def evict(self, n_pages: int) -> int:
        """Unpin up to ``n_pages`` LRU pin-only leaves (freeing their
        pages); dropping a leaf may expose its parent, so eviction walks
        up chains until satisfied or nothing is reclaimable."""
        freed = 0
        while freed < n_pages:
            leaves = self._evictable_leaves()
            if not leaves:
                break
            leaves.sort(key=lambda n: self.allocator.pages[n.page].last_use)
            for node in leaves:
                self._drop_node(node)
                freed += 1
                if freed >= n_pages:
                    break
        return freed

    def drop(self) -> int:
        """Unpin everything (engine teardown / tests); counts pages freed."""
        freed = 0
        for node in list(self._by_page.values()):
            freed += self.allocator.unpin(node.page)
        self._roots.clear()
        self._by_page.clear()
        return freed
