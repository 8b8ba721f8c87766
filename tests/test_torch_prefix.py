"""The port's prefix sharing against the reference's: ``PrefixIndex`` over
one seeded sequence of allocations, inserts, lookups, probes, evictions
and frees on the two allocators; the paged engines with prefix sharing on
the fused, sync-free and chunked loops (page-granular sharing, token-
granular hits with copy-on-write forks) over the shared-prefix workloads
of tests/test_differential.py, native and int8, also under pool pressure;
and the launcher's ``prefix:`` lines."""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from repro.cache import PageAllocator as RefAllocator
from repro.cache.prefix import PrefixIndex as RefPrefixIndex
from repro.runtime import PagedEngine as RefPagedEngine
from repro.runtime import PagedEngineConfig as RefPagedEngineConfig
from repro_torch.cache import PageAllocator, PrefixIndex
from repro_torch.runtime import PagedEngine, PagedEngineConfig
from test_differential import drive, make_shared_workload
from test_torch_chunked import _launch_late, late_consume
from test_torch_engine import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    MARGIN, MarginComparator, _launch, _weights, one_torch_thread)
from test_torch_paged_chunked import _counters


# ------------------------------------------------------------- the index
def _index_ops(seed, n_ops, ps, vocab=4):
    """A seeded op sequence over a few prompt families (a tiny vocabulary,
    so prefixes collide at full and partial blocks): ("alloc", row, tokens)
    allocates a row sharing its lookup's pages and indexes its full pages,
    ("peek", tokens), ("evict", n) and ("free", row)."""
    rng = np.random.default_rng(seed)
    heads = [rng.integers(0, vocab, 3 * ps).astype(np.int32) for _ in range(3)]
    ops, live = [], set()
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.45:
            row = int(rng.integers(0, 8))
            head = heads[int(rng.integers(0, 3))][: int(rng.integers(0, 3 * ps + 1))]
            tail = rng.integers(0, vocab, int(rng.integers(1, 2 * ps))).astype(np.int32)
            ops.append(("alloc", row, np.concatenate([head, tail])))
        elif r < 0.6:
            head = heads[int(rng.integers(0, 3))][: int(rng.integers(1, 3 * ps + 1))]
            ops.append(("peek", head))
        elif r < 0.75:
            ops.append(("evict", int(rng.integers(1, 4))))
        else:
            ops.append(("free", int(rng.integers(0, 8))))
    return ops


def _apply(alloc, index, op, live, ps, precision):
    """One op on one (allocator, index) pair; returns what it observed."""
    kind = op[0]
    if kind == "alloc":
        _, row, toks = op
        if row in live:
            return ("busy",)
        hit = index.lookup(toks, precision=precision)
        shared = hit.pages[: (len(toks) - 1) // ps]
        pages = alloc.alloc(row, len(toks), shared=shared, precision=precision)
        if pages is None:
            freed = index.evict(len(toks) // ps + 1)
            return ("full", hit.pages, hit.matched, hit.fork_src, hit.fork_len, freed)
        live.add(row)
        added = index.insert(toks, pages[: len(toks) // ps], precision=precision)
        return ("alloc", pages, hit.pages, hit.matched, hit.fork_src, hit.fork_len, added)
    if kind == "peek":
        return ("peek", index.peek_tokens(op[1], precision=precision))
    if kind == "evict":
        return ("evict", index.evict(op[1]))
    if op[1] in live:
        live.discard(op[1])
        return ("free", alloc.free(op[1]))
    return ("idle",)


@pytest.mark.parametrize("seed,ps,quant", [(0, 4, 0), (1, 2, 0), (2, 4, 6), (3, 3, 12)])
def test_prefix_index_matches_reference(seed, ps, quant):
    """Every op observes the same thing on both sides (hit pages, matched
    tokens, fork source and length, pages pinned, evicted and freed), and
    the allocators end in the same state, on a native pool and on pools
    whose quantized region the requests use (hits never cross regions)."""
    n_pages = 12
    prec = "int8" if quant == n_pages else "native"
    ours = PageAllocator(n_pages, ps, quant_pages=quant)
    ref = RefAllocator(n_pages, ps, quant_pages=quant)
    ours_idx, ref_idx = PrefixIndex(ours), RefPrefixIndex(ref)
    live_o, live_r = set(), set()
    seen = set()
    for op in _index_ops(seed, 160, ps):
        got = _apply(ours, ours_idx, op, live_o, ps, prec)
        want = _apply(ref, ref_idx, op, live_r, ps, prec)
        assert got == want, op
        seen.add(got[0])
        if got[0] == "alloc" and got[5]:
            seen.add("fork")
        ours.check()
    assert {"alloc", "full", "fork", "evict", "free"} <= seen
    assert len(ours_idx) == len(ref_idx) and ours_idx.evicted_pages == ref_idx.evicted_pages
    assert ours_idx.inserted_pages == ref_idx.inserted_pages > 0
    assert dataclasses.asdict(ours.stats()) == dataclasses.asdict(ref.stats())
    assert [dataclasses.astuple(e) for e in ours.pages] == \
        [dataclasses.astuple(e) for e in ref.pages]
    assert ours_idx.drop() == ref_idx.drop()


# ---------------------------------------------------------------- engines
def _shared(w, **kw):
    base = dict(prompt_len=16, cache_len=64, page_size=8, num_pages=32, max_active=6,
                prefix_sharing=True)
    base.update(kw)
    return (PagedEngine(w["port"], PagedEngineConfig(**base)),
            late_consume(RefPagedEngine(w["cfg"], w["params"], RefPagedEngineConfig(**base))))


def _check(w, ours, ref, mode, reqs, schedule, exact=False):
    got = drive(ours, mode, reqs, schedule)
    want = drive(ref, mode, reqs, schedule)
    streams, retired, (served, finished) = got
    assert served == finished == len(reqs)
    assert retired == want[1]
    assert ours.served_history == ref.served_history
    assert _counters(ours) == _counters(ref)
    if exact:
        assert streams == want[0]
    else:
        MarginComparator(w["params"], w["cfg"], 64, MARGIN).check(
            {k: list(v) for k, v in streams.items()}, {k: list(v) for k, v in want[0].items()},
            {r.rid: r.tokens for r in reqs})
    ours.allocator.check()
    assert len(ours._prefix) == len(ref._prefix)
    return ours.counters()


@pytest.mark.parametrize("mode", ["fused", "sync", "chunked"])
def test_shared_engine_matches_reference(mode):
    """The shared-prefix workload (a common 8-token system prompt on 60% of
    the requests): hits, forks, indexed and evicted pages, every other
    counter, the schedule and the streams equal the reference's."""
    w = _weights()
    reqs, schedule = make_shared_workload(seed=23)
    ours, ref = _shared(w, chunk_size=4 if mode == "chunked" else 0)
    c = _check(w, ours, ref, mode, reqs, schedule)
    assert c["prefix_hit_tokens"] > 0
    if mode == "chunked":
        assert c["prefix_forks"] > 0 and c["fork_dispatches"] > 0


@pytest.mark.parametrize("mode,kw", [("sync", {}), ("chunked", {"chunk_size": 8})])
def test_sharing_under_pool_pressure_matches_reference(mode, kw):
    """Sharing and a pool too small for the load (10 pages): preemption,
    prefix eviction and forks interleave; the reference's schedule, and the
    pool drains to the index's pins (tests/test_differential.py's
    ``test_differential_sharing_under_pool_pressure``)."""
    w = _weights()
    reqs, schedule = make_shared_workload(seed=29, n_reqs=8, max_new_lo=4, max_new_hi=10)
    ours, ref = _shared(w, num_pages=10, **kw)
    c = _check(w, ours, ref, mode, reqs, schedule)
    assert c["preemptions"] > 0
    assert c["prefix_hit_tokens"] + c["prefix_evicted_pages"] > 0   # hits, or evictions
    assert ours.allocator.used_pages == len(ours._prefix)


def test_quantized_shared_chunked_matches_reference():
    """The reference's ``test_differential_quantized_shared_chunked_bounded``
    cell: prefix hits on int8 pages read through the pool/staging split of
    the chunked prompt phase. Against the reference's same cell the streams
    are equal token for token (both quantize the same values); against the
    int8 pool's fused loop retirement and conservation hold exactly."""
    w = _weights()
    reqs, schedule = make_shared_workload(seed=23)
    ours, ref = _shared(w, kv_precision="int8", chunk_size=4)
    c = _check(w, ours, ref, "chunked", reqs, schedule, exact=True)
    assert c["prefix_hit_tokens"] > 0
    fused = PagedEngine(w["port"], PagedEngineConfig(prompt_len=16, cache_len=64, page_size=8,
                                                     num_pages=32, max_active=6,
                                                     kv_precision="int8"))
    _, retired, (served, finished) = drive(fused, "fused", reqs, schedule)
    assert retired == frozenset(r.rid for r in ours.finished)
    assert served == finished == len(reqs)


def test_prefix_hit_probe_matches_reference():
    """The router's affinity probe after a shared-prefix run: the same
    resident-token counts, LRU state untouched."""
    w = _weights()
    reqs, schedule = make_shared_workload(seed=23)
    ours, ref = _shared(w)
    drive(ours, "fused", reqs, schedule)
    drive(ref, "fused", reqs, schedule)
    before = [e.last_use for e in ours.allocator.pages]
    probes = [ours.prefix_hit_tokens(r.tokens) for r in reqs]
    assert probes == [ref.prefix_hit_tokens(r.tokens) for r in reqs]
    assert max(probes) > 0
    assert [e.last_use for e in ours.allocator.pages] == before


# ---------------------------------------------------------------- launcher
@pytest.mark.parametrize("args", [
    ("--paged", "--prefix-sharing"),
    ("--paged", "--chunked", "--prefix-sharing", "--kv-precision", "int8"),
])
def test_launcher_prefix_lines_match_reference(args):
    """The summary, paged, quant, ``prefix:`` and latency lines equal the
    reference's (its early consume off on the chunked loop, ROADMAP R5)."""
    with ThreadPoolExecutor(2) as pool:   # the two launchers side by side
        ours = pool.submit(_launch, "repro_torch.launch.serve", "--device", "cpu", *args)
        ref = pool.submit(_launch_late, "repro.launch.serve", *args)
        ours, ref = ours.result(), ref.result()
    assert ours == ref
    assert any(line.startswith("prefix: hit_tokens=") for line in ours)
