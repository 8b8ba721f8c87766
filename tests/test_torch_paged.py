"""The port's paged KV engine against the reference's: the page allocator,
the plain paged decode attention (against the reference's Pallas kernel in
interpret mode and its oracle), the paged decode step with the reference's
weights carried across, paged == dense inside the port, the engine
scenarios of tests/test_paged.py, MemoryAware's decisions against the
reference scheduler's dispatch, and the launcher's paged summary lines."""
import copy
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax  # noqa: F401  (JAX stays on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import PageAllocator as RefAllocator
from repro.kernels import ref as ref_oracles
from repro.kernels.paged_attention import paged_decode_attention as ref_paged_pallas
from repro.models import model as RM
from repro.models import transformer as RT
from repro.runtime import MemoryAwareScheduler as RefMemoryAwareScheduler
from repro.runtime import PagedEngine as RefPagedEngine
from repro.runtime import PagedEngineConfig as RefPagedEngineConfig
from repro.runtime import RequestSource as RefSource
from repro.runtime import scheduler as ref_sched
from repro.runtime import serve as ref_serve
from repro_torch.cache import PageAllocator, pages_for
from repro_torch.control import MemoryAware
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.runtime import (Engine, EngineConfig, MemoryAwareScheduler,
                                 PagedEngine, PagedEngineConfig, RequestSource,
                                 serve)
from test_torch_engine import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    MARGIN, MarginComparator, _launch, _streams, _weights, one_torch_thread)

# float32 on both sides; the softmaxes differ only in summation order
ATOL = 2e-5
# the model tolerance of tests/test_torch_model.py: summation order and the
# transcendental functions leave ~1e-5 on the logits after two layers
TOL = dict(atol=1e-4, rtol=1e-4)
COLUMNS = ("rate", "backlog", "served", "active", "dropped", "dispatches",
           "occupancy", "syncs")


# ---------------------------------------------------------------- allocator
def _alloc_ops(rng, n_ops, page_size):
    """A seeded op sequence: (op, rid, tokens)."""
    out = []
    for _ in range(n_ops):
        op = ("alloc", "extend", "free")[rng.integers(0, 3)]
        out.append((op, int(rng.integers(0, 6)), int(rng.integers(0, 4 * page_size + 1))))
    return out


def _apply(alloc, live, op, rid, tokens):
    if op == "alloc" and rid not in live:
        table = alloc.alloc(rid, tokens)
        if table is not None:
            live[rid] = tokens
        return table
    if op == "extend" and rid in live:
        table = alloc.extend(rid, tokens)
        if table is not None:
            live[rid] = max(live[rid], tokens)
        return table
    if op == "free" and rid in live:
        del live[rid]
        return alloc.free(rid)
    return "skip"


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("num_pages,page_size", [(12, 4), (40, 16), (3, 1)])
def test_allocator_matches_reference(num_pages, page_size, seed):
    """The same op sequence gives the same block tables, return values and
    AllocStats in the port and the reference; both keep their invariant."""
    ours, ref = PageAllocator(num_pages, page_size), RefAllocator(num_pages, page_size)
    live_o, live_r = {}, {}
    for op, rid, tokens in _alloc_ops(np.random.default_rng(seed), 80, page_size):
        assert _apply(ours, live_o, op, rid, tokens) == _apply(ref, live_r, op, rid, tokens)
        ours.check()
        ref.check()
        assert dataclasses.asdict(ours.stats()) == dataclasses.asdict(ref.stats())
        for r in live_o:
            assert ours.block_table(r) == ref.block_table(r)
        # every page is either free or in exactly one table
        owned = [p for r in live_o for p in ours.block_table(r)]
        assert len(owned) == len(set(owned)) == ours.used_pages
        assert ours.used_pages == sum(pages_for(t, page_size) for t in live_o.values())
    for r in list(live_o):
        ours.free(r)
    assert ours.used_pages == 0 and ours.occupancy() == 0.0
    ours.check()


def _shared_ops(rng, alloc, live, n_ops):
    """Seeded ops over the refcounted paths (shared prefixes, pins, forks)
    of a two-region pool, as (name, args); args are drawn from ``alloc``'s
    state, so both allocators must be in the same state to agree."""
    out = []
    for _ in range(n_ops):
        op = ("alloc", "extend", "free", "pin", "unpin", "fork")[rng.integers(0, 6)]
        rid = int(rng.integers(0, 6))
        resident = [p for p in range(alloc.num_pages) if alloc.refcount(p) > 0]
        if op == "alloc" and rid not in live:
            prec = ("native", "int8")[rng.integers(0, 2)]
            own = [p for p in resident if alloc.region_of(p) == prec]
            shared = list(rng.choice(own, min(len(own), int(rng.integers(0, 3))),
                                     replace=False)) if own else []
            out.append(("alloc", (rid, int(rng.integers(len(shared) * alloc.page_size,
                                                         5 * alloc.page_size + 1)),
                                  [int(x) for x in shared], prec)))
        elif op == "extend" and rid in live:
            out.append(("extend", (rid, int(rng.integers(0, 6 * alloc.page_size + 1)))))
        elif op == "free" and rid in live:
            out.append(("free", (rid,)))
        elif op == "pin" and resident:
            page = int(rng.choice(resident))
            if not alloc.pages[page].pinned:
                out.append(("pin", (page, (page,))))
        elif op == "unpin":
            pinned = [p for p in resident if alloc.pages[p].pinned]
            if pinned:
                out.append(("unpin", (int(rng.choice(pinned)),)))
        elif op == "fork" and rid in live and alloc.block_table(rid):
            out.append(("fork_page", (rid, int(rng.integers(0, len(alloc.block_table(rid)))))))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_allocator_shared_paths_match_reference(seed):
    """The refcounted paths the port's copy carries for later slices (shared
    prefixes, pins, copy-on-write forks, the quantized region) give the
    reference's results and keep its invariant."""
    ours = PageAllocator(20, 4, quant_pages=6, quant_precision="int8")
    ref = RefAllocator(20, 4, quant_pages=6, quant_precision="int8")
    rng, live = np.random.default_rng(seed), set()
    for _ in range(60):
        for name, args in _shared_ops(rng, ours, live, 1):
            got, want = (getattr(a, name)(*args) for a in (ours, ref))
            assert got == want, (name, args)
            if name == "alloc" and got is not None:
                live.add(args[0])
            elif name == "free":
                live.discard(args[0])
        ours.check()
        ref.check()
        assert dataclasses.asdict(ours.stats()) == dataclasses.asdict(ref.stats())
        assert ours.committed_occupancy() == ref.committed_occupancy()


def test_allocator_failed_alloc_claims_nothing():
    ours, ref = PageAllocator(4, 8), RefAllocator(4, 8)
    for a in (ours, ref):
        assert a.alloc(0, 20) is not None        # 3 pages
        assert a.alloc(1, 17) is None            # needs 3, 1 free
        assert a.extend(0, 33) is None           # needs a 5th page
        assert a.used_pages == 3 and a.block_table(0) == [0, 1, 2]
        a.check()
    assert dataclasses.asdict(ours.stats()) == dataclasses.asdict(ref.stats())


# ------------------------------------------------------------ paged kernel
def paged_inputs(rng, B, MP, ps, KVH, hd, pos, holes=False):
    """A pool of B * MP pages and block tables over a random permutation of
    it: row b holds the pages covering positions 0..pos[b], then -1; pos -1
    makes an inactive row (all -1). ``holes`` unallocates a middle page of
    row 1. Every pool row no table reaches at or below its pos (free pages,
    rows past pos, the hole) holds +-1e30 garbage, as recycled pages would."""
    N = B * MP
    perm = rng.permutation(N).astype(np.int32)
    bt = np.full((B, MP), -1, np.int32)
    live = np.zeros((N, ps), bool)
    for b in range(B):
        n = pos[b] // ps + 1 if pos[b] >= 0 else 0
        bt[b, :n] = perm[b * MP: b * MP + n]
        if holes and b == 1 and n > 2:
            bt[b, n // 2] = -1
        for j in range(pos[b] + 1):
            if bt[b, j // ps] >= 0:
                live[bt[b, j // ps], j % ps] = True
    k = rng.standard_normal((N, ps, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((N, ps, KVH, hd)).astype(np.float32)
    junk = np.where(rng.random((N, ps, KVH, hd)) < 0.5, -1e30, 1e30).astype(np.float32)
    return (np.where(live[..., None, None], k, junk), np.where(live[..., None, None], v, -junk),
            bt, np.maximum(pos, 0).astype(np.int32))


PAGED = [  # (B, MP, ps, H, KVH, hd)
    (4, 4, 8, 4, 2, 32),
    (4, 6, 4, 8, 2, 32),
    (3, 3, 16, 4, 1, 64),
]


@pytest.mark.parametrize("B,MP,ps,H,KVH,hd", PAGED)
def test_plain_paged_matches_pallas_and_oracle(B, MP, ps, H, KVH, hd):
    rng = np.random.default_rng(B * MP * ps)
    pos = rng.integers(ps, MP * ps, B).astype(np.int32)
    pos[0] = -1                                   # an inactive row
    k, v, bt, pos = paged_inputs(rng, B, MP, ps, KVH, hd, pos, holes=True)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    got = ops.paged_decode_attention(*(torch.from_numpy(a) for a in (q, k, v, bt, pos))).numpy()
    pal = np.asarray(ref_paged_pallas(q, k, v, bt, pos, interpret=True))
    ora = np.asarray(ref_oracles.paged_decode_attention_ref(q, k, v, bt, pos))
    # a row with no valid slot averages garbage page 0 in every version;
    # the engine discards it, so only rows with a valid slot are compared
    has_slot = (bt >= 0).any(axis=1)
    assert not has_slot[0] and has_slot[1:].all()
    np.testing.assert_allclose(got[has_slot], pal[has_slot], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[has_slot], ora[has_slot], atol=ATOL, rtol=0)
    assert np.abs(got[has_slot]).max() < 10     # no garbage reached a valid row


def test_paged_write_selects_only_allocated_rows():
    """An inactive row, a position past the block table and a position in
    an unallocated page write nowhere in the pool's pages (their write lands
    on the scratch page past the last id, where the reference drops it);
    every other row writes exactly its (page, offset)."""
    port = _weights()["port"]
    cfg = port.cfg
    N, ps, MP = 6, 4, 2
    pool = A.paged_pool_init(N, ps, cfg, "cpu")
    assert pool.k.shape[0] == N + 1 and pool.native_pages == N
    pool.k.fill_(7.0)
    pool.v.fill_(-7.0)
    before_k, before_v = pool.k.clone(), pool.v.clone()
    bt = torch.tensor([[-1, -1], [3, 0], [5, 2], [1, -1]], dtype=torch.int32)
    pos = torch.tensor([0, 5, 8, 6], dtype=torch.int32)   # row 2 past the table, row 3 in a -1 page
    w = A.paged_write_targets(bt, pos, N, 0, ps)
    assert w.pages.tolist() == [N, 0, N, N] and w.offs.tolist() == [0, 1, 0, 2]
    x = torch.randn(4, cfg.d_model)
    A.attn_decode_paged(port.stack[0][0].attn, x, pool, bt, pos, cfg)
    changed = (pool.k != before_k).any(dim=(2, 3)) | (pool.v != before_v).any(dim=(2, 3))
    assert changed[:N].nonzero().tolist() == [[0, 1]]


def test_paged_splice_writes_only_listed_pages():
    port = _weights()["port"]
    cfg = port.cfg
    N, ps = 8, 4
    pool = A.paged_pool_init(N, ps, cfg, "cpu")
    pool.k.fill_(3.0)
    before = pool.k.clone()
    cache = A.kv_cache_init(3, 8, cfg, "cpu")
    cache.k.normal_()
    cache.v.normal_()
    page_idx = np.asarray([[6, 2], [N, N], [1, N]], np.int32)   # row 1 is a pad row
    A.paged_splice_prompt(pool, cache, page_idx)
    # the dropped blocks land on the scratch page N, past the pool's ids
    changed = sorted(set((pool.k != before).any(dim=(1, 2, 3)).nonzero()[:, 0].tolist()))
    assert changed == [1, 2, 6, N]
    kn = pool.regions()[0]
    assert sorted(set((kn != before[:N]).any(dim=(1, 2, 3)).nonzero()[:, 0].tolist())) == [1, 2, 6]
    assert torch.equal(pool.k[6], cache.k[0, :4]) and torch.equal(pool.k[2], cache.k[0, 4:])
    assert torch.equal(pool.v[1], cache.v[2, :4])


# ------------------------------------------------------------- model step
def _paged_setup(lens, ps, P, MP, N, seed):
    """Prompts, block tables covering len + 4 decode writes, and the splice
    index (pad entries = N) for rows of ``lens`` (0 = an inactive row)."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    toks = rng.integers(0, 512, (B, P)).astype(np.int32)
    perm = rng.permutation(N).astype(np.int32)
    bt = np.full((B, MP), -1, np.int32)
    page_idx = np.full((B, P // ps), N, np.int32)
    used = 0
    for b, n in enumerate(lens):
        if n == 0:
            continue
        k = pages_for(n + 4, ps)
        bt[b, :k] = perm[used: used + k]
        used += k
        page_idx[b, : min(k, P // ps)] = bt[b, : min(k, P // ps)]
    return toks, bt, page_idx


@pytest.mark.parametrize("lens,ps", [([0, 5, 16, 9], 8), ([3, 0, 13, 16], 4)])
def test_decode_step_paged_matches_reference(lens, ps):
    w = _weights()
    cfg, params, port = w["cfg"], w["params"], w["port"]
    P, MP, N = 16, 6, 24
    toks, bt, page_idx = _paged_setup(lens, ps, P, MP, N, seed=ps)
    plens = np.maximum(np.asarray(lens, np.int32), 1)
    ref_logits, ref_dense = RM.prefill(params, {"tokens": jnp.asarray(toks)}, cfg, P,
                                       prompt_lens=jnp.asarray(plens))
    ref_pools = RM.paged_splice_prompt(RT.paged_pools_init(cfg, N, ps), ref_dense.caches,
                                       jnp.asarray(page_idx))
    logits, dense = M.prefill(port, torch.from_numpy(toks), P,
                              prompt_lens=torch.from_numpy(plens))
    pools = M.paged_splice_prompt(T.paged_pools_init(port.cfg, N, ps, "cpu"), dense.caches,
                                  page_idx)
    pos = np.where(np.asarray(lens) > 0, plens, 0).astype(np.int32)
    ref_state = RM.PagedDecodeState(ref_pools, jnp.asarray(bt), jnp.asarray(pos),
                                    jnp.asarray(toks[:, 0]))
    state = M.PagedDecodeState(pools, torch.from_numpy(bt), torch.from_numpy(pos),
                               torch.from_numpy(toks[:, 0]))
    nxt = np.asarray(jnp.argmax(ref_logits, -1)).astype(np.int32)
    for _ in range(4):   # crosses a page boundary in every active row
        ref_logits, ref_state = RM.decode_step_paged(params, ref_state, jnp.asarray(nxt), cfg)
        logits, state = M.decode_step_paged(port, state, torch.from_numpy(nxt))
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
        nxt = np.asarray(jnp.argmax(ref_logits, -1)).astype(np.int32)
    for pool, ref_pool in zip(state.pools, ref_state.pools, strict=True):
        kn, vn = pool.regions()[:2]   # the pages without the scratch page
        np.testing.assert_allclose(kn.numpy(), np.asarray(ref_pool.k), **TOL)
        np.testing.assert_allclose(vn.numpy(), np.asarray(ref_pool.v), **TOL)
    np.testing.assert_array_equal(state.pos.numpy(), np.asarray(ref_state.pos))
    np.testing.assert_array_equal(state.last_tok.numpy(), np.asarray(ref_state.last_tok))


@pytest.mark.parametrize("garbage", [False, True])
def test_paged_equals_dense_bitwise(garbage):
    """Inside the port on the CPU, with MP * ps == cache_len: the same
    prefill, then the dense and the paged decode give identical logits,
    also when the pool's unwritten rows hold large finite garbage."""
    port = _weights()["port"]
    lens, ps, P, MP, N = [5, 16, 9, 1], 8, 16, 8, 40
    toks, bt, page_idx = _paged_setup(lens, ps, P, MP, N, seed=1)
    plens = torch.tensor(lens, dtype=torch.int32)
    _, dstate = M.prefill(port, torch.from_numpy(toks), MP * ps, prompt_lens=plens)
    logits0, pre = M.prefill(port, torch.from_numpy(toks), P, prompt_lens=plens)
    pools = T.paged_pools_init(port.cfg, N, ps, "cpu")
    if garbage:
        for pool in pools:
            pool.k.copy_(torch.where(torch.rand(pool.k.shape) < 0.5, -1e30, 1e30))
            pool.v.copy_(torch.where(torch.rand(pool.v.shape) < 0.5, 1e30, -1e30))
    M.paged_splice_prompt(pools, pre.caches, page_idx)
    pstate = M.PagedDecodeState(pools, torch.from_numpy(bt), plens.clone(), pre.last_tok)
    nxt = logits0.argmax(-1).to(torch.int32)
    for _ in range(4):
        ld, dstate = M.decode_step(port, dstate, nxt)
        lp, pstate = M.decode_step_paged(port, pstate, nxt)
        assert torch.equal(ld, lp)
        nxt = ld.argmax(-1).to(torch.int32)


# ---------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def w():
    return _weights()


def _paged_pair(w, **kw):
    base = dict(prompt_len=16, cache_len=64, page_size=16, num_pages=16, max_active=8)
    base.update(kw)
    return (PagedEngine(w["port"], PagedEngineConfig(**base)),
            RefPagedEngine(w["cfg"], w["params"], RefPagedEngineConfig(**base)))


def _reqs(cfg, n, max_new=4, seed=3):
    src = RefSource(vocab_size=cfg.vocab_size, prompt_len=16, raw_rate=n,
                    max_new_tokens=max_new, seed=seed)
    return src.poll(0, float(n))


def _same_as_reference(w, ours, ref):
    got, prompts = _streams(ours)
    want, _ = _streams(ref)
    MarginComparator(w["params"], w["cfg"], 64, MARGIN).check(got, want, prompts)
    assert dataclasses.asdict(ours.allocator.stats()) == dataclasses.asdict(ref.allocator.stats())
    assert ours.counters() == ref.counters()
    ours.allocator.check()


def _run(engines, reqs, slots, n_steps, until=None):
    for e in engines:
        e.submit([copy.deepcopy(r) for r in reqs])
    for t in range(slots):
        for e in engines:
            e.step_slot(t, n_steps=n_steps)
        if until is not None and all(until(e) for e in engines):
            break


def test_paged_engine_matches_dense_tokens(w):
    """Same workload, greedy: the paged engine's tokens equal the port's
    dense engine's and the reference paged engine's, with all 8 requests in
    flight at once in the dense engine's KV memory (16 x 16 = 4 x 64 rows)."""
    reqs = _reqs(w["cfg"], 8)
    dense = Engine(w["port"], EngineConfig(batch_slots=4, prompt_len=16, cache_len=64))
    ours, ref = _paged_pair(w)
    _run([dense, ours, ref], reqs, 12, 2)
    assert len(ours.finished) == len(dense.finished) == len(reqs)
    assert {r.rid: r.generated for r in ours.finished} == \
        {r.rid: r.generated for r in dense.finished}
    assert ours.peak_active == 8 > dense.ecfg.batch_slots
    assert ours.allocator.used_pages == 0
    _same_as_reference(w, ours, ref)


def test_paged_dispatch_budget_and_trace_match_reference(w):
    """<= 1 prefill + 1 decode dispatch per slot, and the serve trace
    (occupancy column included) equals the reference's under MemoryAware."""
    ours, ref = _paged_pair(w)
    rates = tuple(float(f) for f in range(1, 6))
    src_kw = dict(vocab_size=w["cfg"].vocab_size, prompt_len=16, raw_rate=5, max_new_tokens=4)
    tr = serve(ours, MemoryAwareScheduler(rates=rates, V=20.0, capacity=32, device="cpu"),
               RequestSource(**src_kw), horizon=15, steps_per_slot=3)
    ref_tr = ref_serve(ref, RefMemoryAwareScheduler(rates=rates, V=20.0, capacity=32),
                       RefSource(**src_kw), horizon=15, steps_per_slot=3)
    for col in COLUMNS:
        np.testing.assert_array_equal(tr[col], ref_tr[col], err_msg=col)
    assert ours.prefill_dispatches <= 15 and ours.decode_dispatches <= 15
    assert int(tr["dispatches"].max()) <= 2 and int(tr["served"].sum()) > 0
    _same_as_reference(w, ours, ref)


def test_paged_request_grows_past_cache_len(w):
    ours, ref = _paged_pair(w, cache_len=32, max_pages_per_req=5, num_pages=8, max_active=2)
    _run([ours, ref], _reqs(w["cfg"], 1, max_new=50), 40, 4, until=lambda e: e.finished)
    assert len(ours.finished) == 1 and len(ours.finished[0].generated) == 50
    assert ours.allocator.used_pages == 0
    assert ours.allocator.peak_used_pages == 5      # grew to the block-table cap
    _same_as_reference(w, ours, ref)


def test_paged_preemption_recovers(w):
    """The pool fits both requests' admission but not both growths: one is
    preempted, re-queued and recomputed, and both finish with the dense
    engine's tokens."""
    reqs = _reqs(w["cfg"], 2, max_new=20)
    ours, ref = _paged_pair(w, num_pages=5, max_active=2, max_pages_per_req=3)
    _run([ours, ref], reqs, 60, 2, until=lambda e: len(e.finished) == 2)
    assert len(ours.finished) == 2 and ours.preemptions > 0
    assert all(len(r.generated) == 20 for r in ours.finished)
    dense = Engine(w["port"], EngineConfig(batch_slots=2, prompt_len=16, cache_len=64))
    _run([dense], reqs, 40, 2)
    assert {r.rid: r.generated for r in ours.finished} == \
        {r.rid: r.generated for r in dense.finished}
    assert ours.allocator.used_pages == 0
    _same_as_reference(w, ours, ref)


@pytest.mark.parametrize("kw,call,match", [
    (dict(), "step", "no legacy per-step loop"),
])
def test_paged_engine_refuses_unported_paths(w, kw, call, match):
    cfg = PagedEngineConfig(prompt_len=16, cache_len=64, num_pages=8, max_active=2, **kw)
    with pytest.raises(NotImplementedError, match=match):
        getattr(PagedEngine(w["port"], cfg), call or "counters")(0)


@pytest.mark.parametrize("kw,call", [
    (dict(prefix_sharing=True), "step_slot"),
    (dict(), "step_slot_sync"),
    (dict(), "step_slot_chunked"),
])
def test_paged_engine_runs_the_ported_paths(w, kw, call):
    """Prefix sharing and the sync-free and chunked loops, which the paged
    engine refused before they were ported, serve two requests to the end
    and leave nothing allocated but the prefix index's pins."""
    eng = PagedEngine(w["port"], PagedEngineConfig(prompt_len=16, cache_len=64, num_pages=8,
                                                   max_active=2, **kw))
    reqs = _reqs(w["cfg"], 2)
    eng.submit([copy.deepcopy(r) for r in reqs])
    for t in range(8):
        getattr(eng, call)(t, n_steps=2)
    if call != "step_slot":
        eng.drain()
    assert sorted(r.rid for r in eng.finished) == sorted(r.rid for r in reqs)
    assert all(len(r.generated) == r.max_new_tokens for r in eng.finished)
    pins = len(eng._prefix) if eng._prefix is not None else 0
    assert eng.allocator.used_pages == pins
    eng.allocator.check()


# ---------------------------------------------------------------- control
def _ref_dispatch(backlog, z, f, s, lam, V, cost):
    return float(ref_sched._act_on_tables(jnp.float32(backlog), f, s, lam, jnp.float32(V),
                                          jnp.float32(z), np.float32(cost) * f))


@pytest.mark.parametrize("V,n_rates,gain", [(20.0, 5, 2.0), (50.0, 10, 2.0), (7.5, 5, 3.0)])
def test_memory_aware_matches_reference_dispatch(V, n_rates, gain):
    """MemoryAware's decision against the reference scheduler's jitted
    dispatch over backlog x Z, including the exact ties of
    V * S(f) = (Q + gain * Z) * f (for V = 20, F = 1..5: Q + 2Z = 4)."""
    rates = tuple(float(x) for x in range(1, n_rates + 1))
    pol = MemoryAware(rates=rates, V=V, pages_per_request=gain)
    f, s, lam = (t.numpy() for t in pol.tables())
    zs = np.concatenate([np.arange(0, 6, 0.25), np.random.default_rng(0).uniform(0, 3, 12)])
    carry = pol.init()
    for z in zs.astype(np.float32):
        carry = carry._replace(value=torch.tensor(z))
        for q in range(0, 41):
            got = float(pol.act(carry, torch.tensor(float(q)))[0])
            assert got == _ref_dispatch(q, z, f, s, lam, V, pol.vq_cost_per_rate), (q, z)


def test_memory_aware_tie_needs_two_roundings():
    """At V = 7.5, F = 1..5, price 3f, Q = 0, Z = 0.5 every rate ties
    exactly (7.5 * f / 5 = 0.5 * 3f). The reference's dispatch rounds
    V*S - Q*lambda, then subtracts Z*cost and rounds again: f = 1. One
    rounding of the whole functional keeps S(3) = 0.6's float32 excess
    and picks f = 3 (ROADMAP R4)."""
    pol = MemoryAware(rates=tuple(float(x) for x in range(1, 6)), V=7.5, pages_per_request=3.0)
    f, s, lam = (t.numpy().astype(np.float64) for t in pol.tables())
    once = 7.5 * s - 0.0 * lam - 0.5 * (3.0 * f)
    assert float(f[np.argmax(once.astype(np.float32))]) == 3.0
    want = _ref_dispatch(0, np.float32(0.5), *(t.numpy() for t in pol.tables()), 7.5, 3.0)
    got = float(pol.act(pol.init()._replace(value=torch.tensor(0.5)), torch.tensor(0.0))[0])
    assert got == want == 1.0


def test_memory_aware_scheduler_matches_reference():
    rng = np.random.default_rng(2)
    backlog = rng.integers(0, 30, 150)
    occ = np.round(rng.uniform(0, 1, 150), 4)
    rates = tuple(float(x) for x in range(1, 6))
    ours = MemoryAwareScheduler(rates=rates, V=20.0, device="cpu")
    ref = RefMemoryAwareScheduler(rates=rates, V=20.0)
    got = [ours.control(int(q), occupancy=float(o)) for q, o in zip(backlog, occ)]
    want = [ref.control(int(q), occupancy=float(o)) for q, o in zip(backlog, occ)]
    assert got == want
    assert float(ours._carry.value) == float(ref._carry.value)
    assert len(set(got)) > 1   # the virtual queue moved the decision


# ---------------------------------------------------------------- launcher
@pytest.mark.parametrize("argv,err,match", [
    (["--policy", "memory-aware"], ValueError, "requires --paged"),
    (["--paged", "--legacy-loop"], ValueError, "no per-step loop"),
    (["--prefix-sharing"], ValueError, "requires --paged"),
    (["--quant-pages", "4", "--kv-precision", "int8"], ValueError, "requires --paged"),
    (["--paged", "--quant-pages", "4"], ValueError, "needs --kv-precision"),
    (["--paged", "--num-pages", "0"], ValueError, "--num-pages must be >= 1"),
])
def test_launcher_checks_paged_arguments(argv, err, match):
    from repro_torch.launch import serve as launcher
    with pytest.raises(err, match=match):
        launcher.main(["--arch", "granite-3-2b", "--smoke", "--device", "cpu", *argv])


@pytest.mark.parametrize("num_pages,want", [
    (64, ["policy=memory-aware served=55 dropped=0 tail_backlog=0.0 mean_rate=5.00 "
          "dispatches_per_slot=2.00 blocking_syncs_per_slot=2.00",
          "paged: peak_occupancy=0.31 peak_pages=20/64 peak_active=10 alloc_failures=0 "
          "preemptions=0"]),
    (12, ["policy=memory-aware served=28 dropped=0 tail_backlog=0.8 mean_rate=2.67 "
          "dispatches_per_slot=1.92 blocking_syncs_per_slot=1.92",
          "paged: peak_occupancy=1.00 peak_pages=12/12 peak_active=6 alloc_failures=5 "
          "preemptions=0"]),
])
def test_launcher_paged_lines_match_reference(num_pages, want):
    args = ("--paged", "--policy", "memory-aware", "--num-pages", str(num_pages))
    with ThreadPoolExecutor(2) as pool:   # the two launchers side by side
        ours = pool.submit(_launch, "repro_torch.launch.serve", "--device", "cpu", *args)
        ref = pool.submit(_launch, "repro.launch.serve", *args)
        ours, ref = ours.result(), ref.result()
    assert ours == ref          # summary, paged and latency lines
    assert ours[:2] == want
