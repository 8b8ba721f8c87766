"""Block-table page allocator for the paged KV cache.

The serving engine's truly finite resource is KV-cache memory. The dense
engine reserves ``batch_slots x cache_len`` rows up front, so a request that
uses 48 tokens still strands a full 128-row slot. This module carves one
shared pool of ``num_pages`` fixed-size pages (``page_size`` KV rows each)
and hands them out on demand (the TensorRT-LLM / vLLM design): a request
holds ``ceil(tokens / page_size)`` pages, listed in its *block table* — the
logical-page -> physical-page map the paged attention kernel gathers through.

Prefix sharing (DESIGN.md §10) generalizes ownership from exclusive to
refcounted: a page may appear in many block tables at once when it holds a
prompt prefix several requests have in common. Per-page metadata lives in
ONE ``PageEntry`` struct (refcount, prefix key, pin, LRU clock, precision
tag) instead of parallel arrays, so every owner of a page id indexes a
single source of truth. The copy-on-write protocol: shared pages are
read-only; a holder that must write rows into one *forks* it first
(``fork_page`` swaps a private copy into its table, the device copies the
contents), so sharers never observe each other's writes.

Host-side and O(1) per operation: a LIFO free list plus per-request page
lists. A page id is either on the free list (refcount 0) or accounted for
by exactly ``refcount`` references — block-table occurrences plus an
optional prefix-index pin (the invariant ``check()`` asserts). Page
*contents* live on device (``repro_torch.models.attention.PagedKVPool``);
recycled pages are never zeroed because the attention mask (logical index
<= pos) hides stale rows.

This is the reference package's allocator, kept as the port's own copy
(pure Python). The port's paged engine runs it with one or two regions
(native, quantized) and without prefix sharing so far; the pinning and
fork paths are here for the slice that ports them (ROADMAP.md queue 1
item 8).

Occupancy (used_pages / num_pages) is the signal the ``MemoryAware`` policy
(repro_torch.control.policy) prices with a virtual queue, extending Algorithm 1's
queue-overflow argument to the page pool. With prefix sharing the honest
price is ``committed_occupancy()`` — pool fill minus pages held only by the
prefix index, which eviction can reclaim on demand.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to hold ``tokens`` KV rows (ceil division; >= 0)."""
    return -(-max(tokens, 0) // page_size)


class _Exhausted(Exception):
    """Internal: free list cannot cover a multi-page alloc (triggers the
    rollback path; reported to the caller as None, never raised out)."""


@dataclasses.dataclass
class PageEntry:
    """One physical page's metadata — the single page-table struct.

    Consolidates what would otherwise be parallel arrays (refcount map,
    prefix-hash map, precision map) into one record per page id:

    * ``refcount`` — block-table occurrences plus the prefix-index pin.
      0 <=> the page is on the free list.
    * ``prefix_key`` / ``pinned`` — set while the prefix index holds the
      page (the pin contributes 1 to ``refcount``); ``prefix_key`` is the
      page's token block, kept here so eviction and debugging never need a
      reverse lookup.
    * ``last_use`` — LRU clock tick of the last prefix hit (eviction order).
    * ``precision`` — per-page KV precision tag (the planned page-granular
      quantization rides in this struct instead of another parallel array).
    """

    refcount: int = 0
    prefix_key: Optional[tuple] = None
    pinned: bool = False
    last_use: int = 0
    precision: str = "native"


@dataclasses.dataclass
class AllocStats:
    num_pages: int
    used_pages: int
    free_pages: int
    num_requests: int
    occupancy: float            # used_pages / num_pages
    frag_tokens: int            # allocated-but-unwritten KV rows (internal frag)
    peak_used_pages: int
    shared_pages: int = 0       # pages referenced more than once
    pinned_pages: int = 0       # pages held by the prefix index
    evictable_pages: int = 0    # pin-only pages (reclaimable on demand)
    quant_pages: int = 0        # size of the quantized region
    quant_used_pages: int = 0   # in-use pages of the quantized region
    quant_occupancy: float = 0.0


class PageAllocator:
    """Free-list page allocator with refcounted per-request block tables.

    Physical ids are split into two fixed regions (DESIGN.md §14): ids
    [0, native_pages) store K/V at the native dtype; ids
    [native_pages, num_pages) store them quantized (``quant_precision``).
    Every page's region is permanent — ``PageEntry.precision`` is stamped
    at construction and asserted by ``check()`` — so a block table mixes
    precisions only page-by-page, never within a page, and forks/extends
    stay inside the holder's region. Either region may be empty; the
    default (``quant_pages=0``) is the pre-quantization single-region
    allocator, bit-for-bit.
    """

    def __init__(self, num_pages: int, page_size: int,
                 quant_pages: int = 0, quant_precision: str = "int8"):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError((num_pages, page_size))
        if not 0 <= quant_pages <= num_pages:
            raise ValueError(f"quant_pages {quant_pages} not in [0, {num_pages}]")
        self.num_pages = num_pages
        self.page_size = page_size
        self.native_pages = num_pages - quant_pages
        self.quant_pages = quant_pages
        self.quant_precision = quant_precision
        # LIFO free lists (one per region): recently-freed pages are re-used
        # first (their contents are already junk; keeps the hot set small).
        self._free: dict[str, list[int]] = {
            "native": list(range(self.native_pages - 1, -1, -1)),
        }
        if quant_pages:
            self._free[quant_precision] = list(
                range(num_pages - 1, self.native_pages - 1, -1))
        self._tables: dict[int, list[int]] = {}   # rid -> physical page ids
        self._tokens: dict[int, int] = {}         # rid -> written KV rows
        self._prec: dict[int, str] = {}           # rid -> precision of new pages
        self.pages: list[PageEntry] = [
            PageEntry(precision=self.region_of(p)) for p in range(num_pages)]
        self.peak_used_pages = 0

    # ------------------------------------------------------------ queries
    def region_of(self, page: int) -> str:
        """The permanent precision tag of a physical page id."""
        return "native" if page < self.native_pages else self.quant_precision

    def _free_list(self, precision: str) -> list[int]:
        try:
            return self._free[precision]
        except KeyError:
            raise ValueError(
                f"no {precision!r} page region (have {sorted(self._free)})"
            ) from None

    @property
    def free_pages(self) -> int:
        return sum(len(f) for f in self._free.values())

    def free_pages_for(self, precision: str) -> int:
        return len(self._free_list(precision))

    @property
    def used_pages(self) -> int:
        return self.num_pages - self.free_pages

    def occupancy(self) -> float:
        return self.used_pages / self.num_pages

    def refcount(self, page: int) -> int:
        return self.pages[page].refcount

    def evictable_pages(self) -> int:
        """Pages held by the prefix index alone — freeable on demand."""
        return sum(1 for e in self.pages if e.pinned and e.refcount == 1)

    def committed_occupancy(self) -> float:
        """Pool fill net of evictable cache pages — the *marginal* price of
        memory the MemoryAware virtual queue should observe: a pin-only
        prefix page is reclaimed the moment a real allocation needs it."""
        return (self.used_pages - self.evictable_pages()) / self.num_pages

    def quant_occupancy(self) -> float:
        """In-use fraction of the quantized region — the signal the
        ``PrecisionAware`` policy prices (0.0 when there is no region)."""
        if not self.quant_pages:
            return 0.0
        used = self.quant_pages - self.free_pages_for(self.quant_precision)
        return used / self.quant_pages

    def can_alloc(self, tokens: int, precision: str = "native") -> bool:
        return (pages_for(tokens, self.page_size)
                <= self.free_pages_for(precision))

    def block_table(self, rid: int) -> list[int]:
        return list(self._tables[rid])

    def holders(self) -> list[int]:
        return list(self._tables)

    def stats(self) -> AllocStats:
        frag = sum(
            len(pages) * self.page_size - self._tokens[rid]
            for rid, pages in self._tables.items()
        )
        return AllocStats(
            num_pages=self.num_pages,
            used_pages=self.used_pages,
            free_pages=self.free_pages,
            num_requests=len(self._tables),
            occupancy=self.occupancy(),
            frag_tokens=frag,
            peak_used_pages=self.peak_used_pages,
            shared_pages=sum(1 for e in self.pages if e.refcount > 1),
            pinned_pages=sum(1 for e in self.pages if e.pinned),
            evictable_pages=self.evictable_pages(),
            quant_pages=self.quant_pages,
            quant_used_pages=(self.quant_pages
                              - self.free_pages_for(self.quant_precision)
                              if self.quant_pages else 0),
            quant_occupancy=self.quant_occupancy(),
        )

    # ------------------------------------------------------------ refcounts
    def _incref(self, page: int) -> None:
        e = self.pages[page]
        if e.refcount <= 0:
            raise ValueError(f"page {page} is not resident (refcount 0)")
        e.refcount += 1

    def _decref(self, page: int) -> bool:
        """Drop one reference; True when the page returned to the free list."""
        e = self.pages[page]
        assert e.refcount > 0, f"page {page} double-freed"
        e.refcount -= 1
        if e.refcount == 0:
            assert not e.pinned, f"page {page} freed while pinned"
            e.prefix_key = None
            self._free[self.region_of(page)].append(page)
            return True
        return False

    def _claim_free(self, precision: str = "native") -> int:
        page = self._free_list(precision).pop()
        e = self.pages[page]
        assert e.refcount == 0 and not e.pinned
        e.refcount = 1
        e.prefix_key = None
        return page

    # ------------------------------------------------------------ mutation
    def alloc(self, rid: int, tokens: int, shared: Sequence[int] = (),
              precision: str = "native") -> list[int] | None:
        """Claim pages for a new request holding ``tokens`` KV rows.

        ``shared`` names already-resident pages covering the request's first
        ``len(shared)`` logical pages (a prefix-cache hit): each gains a
        reference instead of costing a free page, and only the novel tail is
        drawn from the free list. ``precision`` selects the region novel
        pages come from and is remembered for later ``extend``s; shared
        pages must already live in that region (the precision-keyed prefix
        index guarantees it — a quantized page never satisfies a native
        request). Returns the block table (physical page ids in logical
        order), or None — *atomically*, claiming nothing and leaving every
        refcount untouched — if the free list cannot cover the novel pages.
        The shared references taken before the shortfall is discovered are
        rolled back, so a failed multi-page alloc never leaks a reference or
        leaves pages partially owned.
        """
        if rid in self._tables:
            raise KeyError(f"rid {rid} already holds pages")
        n = pages_for(tokens, self.page_size)
        shared = list(shared)
        if len(shared) > n:
            raise ValueError(
                f"{len(shared)} shared pages exceed the {n}-page table "
                f"({tokens} tokens)")
        taken: list[int] = []
        novel: list[int] = []
        try:
            for p in shared:
                if not 0 <= p < self.num_pages:
                    raise ValueError(f"shared page {p} out of range")
                if self.region_of(p) != precision:
                    raise ValueError(
                        f"shared page {p} is {self.region_of(p)}, request "
                        f"wants {precision}")
                self._incref(p)       # raises on a non-resident page
                taken.append(p)
            if n - len(shared) > self.free_pages_for(precision):
                raise _Exhausted
            for _ in range(n - len(shared)):
                novel.append(self._claim_free(precision))
        except (_Exhausted, ValueError) as err:
            for p in reversed(novel):
                self._decref(p)
            for p in reversed(taken):
                self._decref(p)
            if isinstance(err, ValueError):
                raise
            return None
        pages = shared + novel
        self._tables[rid] = list(pages)
        self._tokens[rid] = tokens
        self._prec[rid] = precision
        self.peak_used_pages = max(self.peak_used_pages, self.used_pages)
        return list(pages)

    def precision_of(self, rid: int) -> str:
        """The region ``rid``'s novel/appended pages come from."""
        return self._prec[rid]

    def extend(self, rid: int, tokens: int) -> list[int] | None:
        """Grow ``rid`` to cover ``tokens`` total rows, appending pages
        from the request's own precision region.

        Returns the (possibly longer) block table, or None — without
        claiming anything — if the free list cannot cover the growth. This
        is how a request exceeds the dense engine's ``cache_len``: its block
        table just keeps growing. Appended pages are always exclusive
        (refcount 1); only ``alloc``'s shared prefix ever multi-references.
        """
        pages = self._tables[rid]
        prec = self._prec[rid]
        need = pages_for(tokens, self.page_size) - len(pages)
        if need > self.free_pages_for(prec):
            return None
        for _ in range(max(need, 0)):
            pages.append(self._claim_free(prec))
        self._tokens[rid] = max(self._tokens[rid], tokens)
        self.peak_used_pages = max(self.peak_used_pages, self.used_pages)
        return list(pages)

    def fork_page(self, rid: int, idx: int) -> tuple[int, int] | None:
        """Copy-on-write: privatize logical page ``idx`` of ``rid``'s table.

        Swaps a fresh exclusive page in place of the shared one (the shared
        page keeps its other holders) and returns ``(src, dst)`` so the
        caller can copy the device contents. The replacement comes from the
        *source page's* region — a fork never crosses the precision
        boundary, so the device copy moves quantized bytes + scales or
        native bytes, never converts. Returns None — changing nothing —
        when that region's free list is empty. Forking an
        already-exclusive page is legal (it just copies), so callers need
        no refcount probe.
        """
        pages = self._tables[rid]
        src = pages[idx]
        if not self._free_list(self.region_of(src)):
            return None
        dst = self._claim_free(self.region_of(src))
        pages[idx] = dst
        self._decref(src)
        self.peak_used_pages = max(self.peak_used_pages, self.used_pages)
        return src, dst

    def free(self, rid: int) -> int:
        """Drop ``rid``'s reference on every page it holds; pages reaching
        refcount 0 return to the free list. Counts pages actually freed (a
        shared prefix page outlives any single holder)."""
        pages = self._tables.pop(rid)
        self._tokens.pop(rid)
        self._prec.pop(rid, None)
        return sum(self._decref(p) for p in reversed(pages))

    # ------------------------------------------------------------ pinning
    def pin(self, page: int, key: tuple) -> None:
        """Prefix-index hold: one extra reference keeping a cached prefix
        page resident after its writers retire. At most one pin per page
        (the index has one node per page)."""
        e = self.pages[page]
        if e.pinned:
            raise ValueError(f"page {page} already pinned")
        self._incref(page)
        e.pinned = True
        e.prefix_key = key

    def unpin(self, page: int) -> bool:
        """Release the prefix-index hold; True when the page was freed."""
        e = self.pages[page]
        if not e.pinned:
            raise ValueError(f"page {page} is not pinned")
        e.pinned = False
        e.prefix_key = None
        return self._decref(page)

    def touch(self, page: int, clock: int) -> None:
        """Stamp the LRU clock (a prefix lookup hit this page)."""
        self.pages[page].last_use = clock

    # ------------------------------------------------------------ invariant
    def check(self) -> None:
        """Assert the ownership invariant (used by the property tests):
        every page's refcount equals its block-table occurrences plus its
        pin, free-listed pages have refcount 0, the pool neither leaks nor
        double-counts a page, and every page's ``precision`` tag matches
        its permanent region (free-list membership included) — the
        scale/precision consistency the fork/evict/requeue property sweeps
        interleave against."""
        refs = [0] * self.num_pages
        for pages in self._tables.values():
            for p in pages:
                assert 0 <= p < self.num_pages, p
                refs[p] += 1
        for p, e in enumerate(self.pages):
            if e.pinned:
                refs[p] += 1
            assert e.refcount == refs[p], (
                f"page {p}: refcount {e.refcount} != {refs[p]} references")
            assert e.precision == self.region_of(p), (
                f"page {p}: precision {e.precision!r} != region "
                f"{self.region_of(p)!r}")
        all_free = [p for f in self._free.values() for p in f]
        free = set(all_free)
        assert len(free) == len(all_free), "free list duplicates"
        for prec, flist in self._free.items():
            for p in flist:
                assert self.region_of(p) == prec, (
                    f"page {p} on the {prec!r} free list, region "
                    f"{self.region_of(p)!r}")
        for p in free:
            assert self.pages[p].refcount == 0, f"free page {p} referenced"
            assert not self.pages[p].pinned, f"free page {p} pinned"
        used = {p for p, e in enumerate(self.pages) if e.refcount > 0}
        assert used.isdisjoint(free)
        assert len(used) + len(free) == self.num_pages, "page leaked"
        for rid in self._tables:
            assert rid in self._prec, f"rid {rid} missing a precision record"
