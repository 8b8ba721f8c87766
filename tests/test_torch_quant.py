"""The port's quantized and mixed KV page pools against the reference's:
``quantize_kv``/``dequantize_kv`` bit for bit, the plain quantized and
mixed paged attention (against the reference's oracle, its Pallas kernel
in interpret mode and its ``_pool_read`` gather), the quantized paged
decode step with the reference's weights carried across, the two-region
allocator, ``PrecisionAware`` (decisions, latch, scheduler), the engine
scenarios of tests/test_quant.py, and the launcher's quantized lines."""
import copy
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import PageAllocator as RefAllocator
from repro.cache.precision import parse_kv_precision as ref_parse
from repro.control import PrecisionAware as RefPrecisionAware
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro.kernels.quant import dequantize_kv as ref_dequantize
from repro.kernels.quant import quantize_kv as ref_quantize
from repro.models import attention as RA
from repro.models import model as RM
from repro.models import transformer as RT
from repro.runtime import PagedEngine as RefPagedEngine
from repro.runtime import PagedEngineConfig as RefPagedEngineConfig
from repro.runtime import PrecisionAwareScheduler as RefPrecisionAwareScheduler
from repro.runtime import RequestSource as RefSource
from repro.runtime import serve as ref_serve
from repro.runtime.request import Request as RefRequest
from repro_torch.cache import PageAllocator, parse_kv_precision
from repro_torch.control import PrecisionAware
from repro_torch.kernels import ops
from repro_torch.kernels.quant import dequantize_kv, quantize_kv
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.runtime import (PagedEngine, PagedEngineConfig, PrecisionAwareScheduler,
                                 RequestSource, serve)
from test_torch_engine import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    MARGIN, MarginComparator, _launch, _streams, _weights, one_torch_thread)
from test_torch_paged import ATOL, COLUMNS, TOL, _paged_setup, _ref_dispatch

PRECS = ("int8", "fp8")


def _codes(t) -> np.ndarray:
    """Codes of either framework as raw bytes."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.uint8).numpy()
    return np.asarray(t).view(np.uint8)


# -------------------------------------------------------------- quantizer
def _rows(seed, shape):
    """Seeded K/V-like rows with the cases that stress the quantizer: heads
    spread over 1e-30..1e30, an all-zero token, subnormal rows, and rows
    whose elements sit exactly on int8 half steps (x / scale = n + 0.5)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x *= np.logspace(-30, 30, shape[-2], dtype=np.float32)[None, None, :, None]
    x[0] = 0.0
    x[1] = rng.standard_normal(shape[1:]).astype(np.float32) * 1e-40
    half = (np.arange(shape[-1]) % 9 - 4 + 0.5).astype(np.float32)
    half[0] = 127.0                         # amax = 127 -> scale 1, codes at n + 0.5
    x[2, :, 0] = half
    return x


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("shape", [(6, 16, 4, 32), (4, 8, 2, 64)])
def test_quantize_kv_bit_exact(prec, shape):
    """On the same inputs the codes and scales are the reference's bit for
    bit, and so is the dequantization to float32 and to bfloat16."""
    x = _rows(sum(shape), shape)
    codes, scale = quantize_kv(torch.from_numpy(x), parse_kv_precision(prec))
    rcodes, rscale = ref_quantize(jnp.asarray(x), ref_parse(prec))
    assert codes.dtype == (torch.int8 if prec == "int8" else torch.float8_e4m3fn)
    np.testing.assert_array_equal(_codes(codes), _codes(rcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(rscale))
    floor = torch.tensor(1e-8) / parse_kv_precision(prec).qmax
    assert (scale[0] == floor).all() and not codes[0].view(torch.uint8).any()   # zero rows
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = dequantize_kv(codes, scale, dt).float().numpy()
        want = np.asarray(ref_dequantize(rcodes, rscale, jdt).astype(jnp.float32))
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------- paged attention
def _quant_pool(seed, shape, prec):
    """Native K/V of a pool's shape and their codes and scales (the
    reference's quantizer, which the test above holds equal to the port's)."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    qk, ks = ref_quantize(jnp.asarray(k), ref_parse(prec))
    qv, vs = ref_quantize(jnp.asarray(v), ref_parse(prec))
    return k, v, qk, qv, ks, vs


def _boundary_case():
    """tests/test_quant.py's page-boundary case: pos at the last slot of a
    page and the first of the next, unallocated table tails."""
    N, ps, KVH, hd, H, B, MP = 20, 16, 2, 32, 4, 4, 4
    rng = np.random.default_rng(0)
    bt = rng.permutation(N)[:B * MP].reshape(B, MP).astype(np.int32)
    bt[0, 3] = -1
    bt[1, 2:] = -1
    pos = np.asarray([ps - 1, ps, 2 * ps - 1, 3 * ps + 5], np.int32)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    return q, bt, pos, (N, ps, KVH, hd)


def _t(*arrays):
    """numpy/JAX arrays as CPU tensors (fp8 through its bytes)."""
    out = []
    for a in arrays:
        a = np.array(a)
        if a.dtype == jnp.float8_e4m3fn:
            out.append(torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn))
        else:
            out.append(torch.from_numpy(a))
    return out


@pytest.mark.parametrize("prec", PRECS)
def test_plain_quant_paged_matches_pallas_and_oracle(prec):
    """All-quantized pool, float32 at 2e-5 (summation order only): the
    port's plain version against the reference's quantized oracle and,
    for int8, its Pallas kernel in interpret mode."""
    q, bt, pos, shape = _boundary_case()
    _, _, qk, qv, ks, vs = _quant_pool(1, shape, prec)
    got = ops.paged_decode_attention_quant(*_t(q), None, None, *_t(qk, qv, ks, vs, bt, pos))
    ora = ref_oracles.paged_decode_attention_quant_ref(q, qk, qv, ks, vs, bt, pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(ora), atol=ATOL, rtol=0)
    if prec == "int8":   # the reference runs its quantized Pallas kernel on int8 pools
        pal = ref_ops.paged_decode_attention(q, qk, qv, bt, pos, k_scale=ks, v_scale=vs,
                                             impl="interpret")
        np.testing.assert_allclose(got.numpy(), np.asarray(pal), atol=ATOL, rtol=0)


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("native_pages", [7, 13])
def test_plain_mixed_paged_matches_pool_read(prec, native_pages):
    """A two-region pool: the port's plain version against the reference's
    model path, its ``_pool_read`` gather (native pages below native_pages,
    quantized pages dequantized above) and the paged oracle's mask, float32
    at 2e-5."""
    q, bt, pos, shape = _boundary_case()
    k, v, qk, qv, ks, vs = _quant_pool(2, shape, prec)
    nn = native_pages
    pool = RA.PagedKVPool(k=jnp.asarray(k[:nn]), v=jnp.asarray(v[:nn]), qk=qk[nn:],
                          qv=qv[nn:], k_scale=ks[nn:], v_scale=vs[nn:])
    kk, vv = RA._pool_read(pool, jnp.asarray(bt), jnp.float32)
    ps = shape[1]
    j = np.arange(bt.shape[1] * ps)[None, :]
    slot_pos = np.where(np.repeat(bt >= 0, ps, axis=1), j, -1).astype(np.int32)
    want = ref_oracles.decode_attention_ref(q, kk, vv, slot_pos, pos)
    got = ops.paged_decode_attention_quant(
        *_t(q, k[:nn], v[:nn], qk[nn:], qv[nn:], ks[nn:], vs[nn:], bt, pos))
    native = (bt >= 0) & (bt < nn)
    assert (native & (bt >= 0)).any() and (bt >= nn).any()
    assert (native.any(axis=1) & (bt >= nn).any(axis=1)).any()   # a row spans both regions
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


# ------------------------------------------------------------ model step
def _quant_states(w, prec, native_pages, lens, ps, P, MP, N, seed):
    """The same prompts prefilled and spliced into a quantized (or mixed)
    pool by the reference and by the port."""
    cfg, params, port = w["cfg"], w["params"], w["port"]
    toks, bt, page_idx = _paged_setup(lens, ps, P, MP, N, seed=seed)
    plens = np.maximum(np.asarray(lens, np.int32), 1)
    _, ref_dense = RM.prefill(params, {"tokens": jnp.asarray(toks)}, cfg, P,
                              prompt_lens=jnp.asarray(plens))
    qcfg = cfg.replace(kv_precision=prec)
    ref_pools = RM.paged_splice_prompt(RT.paged_pools_init(qcfg, N, ps, native_pages=native_pages),
                                       ref_dense.caches, jnp.asarray(page_idx))
    logits, dense = M.prefill(port, torch.from_numpy(toks), P, prompt_lens=torch.from_numpy(plens))
    pools = M.paged_splice_prompt(
        T.paged_pools_init(port.cfg.replace(kv_precision=prec), N, ps, "cpu",
                           native_pages=native_pages), dense.caches, page_idx)
    pos = np.where(np.asarray(lens) > 0, plens, 0).astype(np.int32)
    ref_state = RM.PagedDecodeState(ref_pools, jnp.asarray(bt), jnp.asarray(pos),
                                    jnp.asarray(toks[:, 0]))
    state = M.PagedDecodeState(pools, torch.from_numpy(bt), torch.from_numpy(pos),
                               torch.from_numpy(toks[:, 0]))
    return qcfg, ref_state, state, logits.argmax(-1).to(torch.int32)


def _one_flip_logit_change(port, state, nxt) -> float:
    """What one code that rounds the other way does to the step's logits:
    the quantized K code of largest scale moved by one step (a dequantized
    change of its row's scale, amax / 127 for int8), the step run on a copy
    of the pools with and without it."""
    def run(pools):
        st = state._replace(pools=[_clone_pool(p) for p in pools])
        return M.decode_step_paged(port, st, nxt)[0]

    base = run(state.pools)
    flipped = [_clone_pool(p) for p in state.pools]
    pool = flipped[0]
    live = torch.zeros_like(pool.k_scale, dtype=torch.bool)
    bt, pos = state.block_tables.numpy(), state.pos.numpy()
    ps, nn = pool.page_size, pool.native_pages
    for b in range(bt.shape[0]):
        for j in range(int(pos[b])):
            page = bt[b, j // ps]
            if page >= nn:
                live[:, page - nn, j % ps] = True
    i = torch.where(live, pool.k_scale, -1.0).flatten().argmax()
    layer, page, row, head = np.unravel_index(int(i), pool.k_scale.shape)
    codes = pool.qk[layer, page, row, head]
    step = 1 if codes.dtype == torch.int8 else 0
    if step:
        codes[0] = codes[0] + (1 if codes[0] < 127 else -1)
    else:    # fp8: the neighbouring code
        raw = codes.view(torch.uint8)
        raw[0] = raw[0] ^ 1
    return float((run(flipped) - base).abs().max())


def _clone_pool(pool):
    return type(pool)(*(None if t is None else t.clone() for t in pool))


@pytest.mark.parametrize("prec,native_pages", [("int8", 0), ("fp8", 12)])
def test_decode_step_quant_paged_matches_reference(prec, native_pages):
    """Quantized and mixed pools through the paged decode step: written
    codes and scales, and the logits, against the reference's, with the
    reference's weights. The port's K/V rows differ from the reference's by
    ~1e-6 before quantization, so a code may round the other way at an
    int8 half step; the logit tolerance allows one such flip, measured as
    the change one flip of the pool's largest scale makes, on top of the
    native decode's 1e-4."""
    w = _weights()
    lens, ps, P, MP, N = [0, 5, 16, 9], 8, 16, 6, 24
    qcfg, ref_state, state, nxt = _quant_states(w, prec, native_pages, lens, ps, P, MP, N, 8)
    flip_tol = _one_flip_logit_change(w["port"], state, nxt)
    assert flip_tol > 0
    tol = TOL["atol"] + flip_tol
    for _ in range(4):   # rows 1 and 2 cross into a new page
        ref_logits, ref_state = RM.decode_step_paged(w["params"], ref_state, jnp.asarray(nxt),
                                                     qcfg)
        logits, state = M.decode_step_paged(w["port"], state, nxt)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=tol, rtol=0)
        nxt = torch.from_numpy(np.asarray(jnp.argmax(ref_logits, -1)).astype(np.int32))
    for pool, ref_pool in zip(state.pools, ref_state.pools, strict=True):
        kn, vn, qk, qv, ks, _ = pool.regions()   # the pages without the scratch pages
        flips = (_codes(qk) != _codes(ref_pool.qk)).sum() + \
            (_codes(qv) != _codes(ref_pool.qv)).sum()
        assert flips <= 1
        np.testing.assert_allclose(ks.numpy(), np.asarray(ref_pool.k_scale),
                                   rtol=1e-5, atol=0)
        if native_pages:
            np.testing.assert_allclose(kn.numpy(), np.asarray(ref_pool.k), **TOL)
            np.testing.assert_allclose(vn.numpy(), np.asarray(ref_pool.v), **TOL)


def test_decode_write_splits_regions_with_one_readback():
    """Rows on native pages, rows on quantized pages, an inactive row and a
    row past its table: each writes its own region (quantized pages at
    id - native_pages), the others only the region's scratch page past its
    last id, where the reference drops the write. The targets are computed
    on the device with no readback at all."""
    from repro_torch.models import attention as A
    port = _weights()["port"]
    cfg = port.cfg.replace(kv_precision="int8")
    N, nn, ps = 8, 4, 4
    nq = N - nn
    pool = A.paged_pool_init(N, ps, cfg, "cpu", native_pages=nn)
    assert (pool.native_pages, pool.quant_pages) == (nn, nq)
    bt = torch.tensor([[-1, -1], [5, 1], [2, 6], [7, 3], [0, -1]], dtype=torch.int32)
    pos = torch.tensor([0, 5, 2, 9, 3], dtype=torch.int32)   # row 3 past its table
    w = A.paged_write_targets(bt, pos, nn, nq, ps)
    assert (w.pages.tolist(), w.offs.tolist()) == ([nn, 1, 2, nn, 0], [0, 1, 2, 1, 3])
    assert w.qpages.tolist() == [nq] * 5
    pos = torch.tensor([0, 2, 5, 1, 3], dtype=torch.int32)
    w = A.paged_write_targets(bt, pos, nn, nq, ps)
    assert (w.pages.tolist(), w.offs.tolist()) == ([nn, nn, nn, nn, 0], [0, 2, 1, 1, 3])
    assert w.qpages.tolist() == [nq, 1, 2, 3, nq]
    before = [t.clone() for t in pool if t is not None]
    A.attn_decode_paged(port.stack[0][0].attn, torch.randn(5, cfg.d_model), pool, bt, pos, cfg)
    after = [t for t in pool if t is not None]
    changed = [sorted(set(map(tuple, (a != b).reshape(*a.shape[:2], -1).any(-1)
                               .nonzero().tolist()))) for a, b in zip(after, before)]
    assert changed[0] == changed[1] == [(0, 3), (nn, 0), (nn, 1), (nn, 2)]   # (nn, *): scratch
    assert changed[2] == changed[3] == [(1, 2), (2, 1), (3, 1), (nq, 0), (nq, 3)]
    assert changed[4] == changed[5] == [(1, 2), (2, 1), (3, 1), (nq, 0), (nq, 3)]


# -------------------------------------------------------------- allocator
def _both(*a, **kw):
    return PageAllocator(*a, **kw), RefAllocator(*a, **kw)


def _same_stats(ours, ref):
    assert dataclasses.asdict(ours.stats()) == dataclasses.asdict(ref.stats())
    assert ours.quant_occupancy() == ref.quant_occupancy()
    ours.check()


def test_allocator_two_regions_match_reference():
    """tests/test_quant.py's two-region cases on the port's allocator and
    the reference's side by side."""
    pair = _both(num_pages=8, page_size=4, quant_pages=3)
    for a in pair:
        assert (a.free_pages_for("native"), a.free_pages_for("int8")) == (5, 3)
        assert a.region_of(0) == "native" and a.region_of(5) == "int8"
    tabs = [(a.alloc("r1", 8), a.alloc("r2", 8, precision="int8")) for a in pair]
    assert tabs[0] == tabs[1]
    assert all(p < 5 for p in tabs[0][0]) and all(p >= 5 for p in tabs[0][1])
    _same_stats(*pair)
    grown = [a.extend("r2", 12) for a in pair]     # the int8 region's last page
    assert grown[0] == grown[1] and all(p >= 5 for p in grown[0])
    assert [a.extend("r2", 16) for a in pair] == [None, None]   # the int8 region is full
    grown = [a.extend("r1", 16) for a in pair]     # the native region is not
    assert grown[0] == grown[1] and all(p < 5 for p in grown[0])
    _same_stats(*pair)
    for a in pair:
        with pytest.raises(ValueError):
            a.alloc("r3", 4, shared=[tabs[0][1][0]], precision="native")
        with pytest.raises(ValueError):
            a.alloc("r4", 4, precision="fp8")
        a.free("r1")
        a.free("r2")
    _same_stats(*pair)
    pair = _both(num_pages=4, page_size=4, quant_pages=2)
    assert [a.alloc("q", 8, precision="int8") for a in pair][0] is not None
    assert [a.alloc("q2", 4, precision="int8") for a in pair] == [None, None]
    tabs = [a.alloc("n", 8) for a in pair]
    assert tabs[0] == tabs[1] and tabs[0] is not None
    _same_stats(*pair)
    pair = _both(num_pages=8, page_size=4, quant_pages=4)
    for a in pair:
        tq = a.alloc("w", 4, precision="int8")
        a.pin(tq[0], key=("k",))
        assert a.alloc("s", 4, shared=tq, precision="int8") == tq
        src, dst = a.fork_page("s", 0)
        assert src == tq[0] and a.region_of(dst) == "int8"
    _same_stats(*pair)


# ---------------------------------------------------------------- control
@pytest.mark.parametrize("V,n_rates,ppr,gain", [(20.0, 5, 2.0, 1.0), (50.0, 10, 2.0, 1.0),
                                                (7.5, 5, 1.5, 2.0)])
def test_precision_aware_matches_reference_dispatch(V, n_rates, ppr, gain):
    """PrecisionAware's decision against the reference scheduler's jitted
    dispatch over backlog x Z, with the exact ties of V * S(f) =
    (Q + cost * Z) * f among them (V = 7.5, cost 3, Q = 0, Z = 0.5: every
    rate ties; ROADMAP R4)."""
    rates = tuple(float(x) for x in range(1, n_rates + 1))
    pol = PrecisionAware(rates=rates, V=V, pages_per_request=ppr, quant_gain=gain)
    f, s, lam = (t.numpy() for t in pol.tables())
    zs = np.concatenate([np.arange(0, 4, 0.25), np.random.default_rng(1).uniform(0, 3, 6)])
    carry = pol.init()
    for z in zs.astype(np.float32):
        carry = carry._replace(value=torch.tensor(z))
        for q in range(0, 31):
            got = float(pol.act(carry, torch.tensor(float(q)))[0])
            assert got == _ref_dispatch(q, z, f, s, lam, V, pol.vq_cost_per_rate), (q, z)


def test_precision_latch_matches_reference():
    """The hysteresis latch over an occupancy walk that sits on, crosses
    and wanders inside the dead band [upgrade_at, downgrade_at]."""
    kw = dict(rates=(1.0, 2.0, 4.0), V=10.0, downgrade_at=0.7, upgrade_at=0.4)
    ours, ref = PrecisionAware(**kw), RefPrecisionAware(**kw)
    walk = [0.3, 0.69, 0.7, 0.55, 0.4, 0.41, 0.6, 0.7, 0.4000001, 0.4, 0.0, 1.0, 0.7, 0.69]
    walk += list(np.random.default_rng(4).uniform(0.3, 0.8, 60))
    c, rc = ours.init(), ref.init()
    got, want = [], []
    for occ in walk:
        p, c = ours.admit_precision(c, occ)
        rp, rc = ref.admit_precision(rc, occ)
        got.append(p)
        want.append(rp)
        assert isinstance(c.lossy, bool)
    assert got == want and len(set(got)) == 2
    with pytest.raises(ValueError):
        PrecisionAware(rates=(1.0,), V=1.0, downgrade_at=0.3, upgrade_at=0.5)


def test_precision_scheduler_matches_reference():
    """The scheduler: rates with the quantized-occupancy virtual queue and
    the admission precision, slot by slot, against the reference's."""
    rng = np.random.default_rng(6)
    kw = dict(rates=tuple(float(x) for x in range(1, 6)), V=20.0, downgrade_at=0.6,
              upgrade_at=0.3)
    ours = PrecisionAwareScheduler(device="cpu", **kw)
    ref = RefPrecisionAwareScheduler(**kw)
    zs = []
    for _ in range(120):
        q, occ, qocc = int(rng.integers(0, 30)), float(rng.uniform()), float(rng.uniform())
        assert ours.control(q, occupancy=occ, quant_occupancy=qocc) == \
            ref.control(q, occupancy=occ, quant_occupancy=qocc)
        assert ours.admit_precision(occ) == ref.admit_precision(occ)
        zs.append(float(ours._carry.value))
        assert zs[-1] == float(ref._carry.value)
    assert max(zs) > 0 and len(set(ours.rate_history)) > 1


# ---------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def w():
    return _weights()


def _pair(w, **kw):
    base = dict(prompt_len=16, cache_len=64, page_size=8, kv_precision="int8")
    base.update(kw)
    return (PagedEngine(w["port"], PagedEngineConfig(**base)),
            RefPagedEngine(w["cfg"], w["params"], RefPagedEngineConfig(**base)))


def _req(rid, t, n, rng, max_new=8):
    return RefRequest(rid=rid, arrival_slot=t, tokens=rng.integers(0, 256, n, dtype=np.int32),
                      max_new_tokens=max_new)


def _same(w, ours, ref):
    got, prompts = _streams(ours)
    want, _ = _streams(ref)
    MarginComparator(w["params"], w["cfg"], 64, MARGIN).check(got, want, prompts)
    assert dataclasses.asdict(ours.allocator.stats()) == dataclasses.asdict(ref.allocator.stats())
    assert ours.counters() == ref.counters()
    assert ours.quant_occupancy() == ref.quant_occupancy()
    assert ours.admit_precision == ref.admit_precision
    ours.allocator.check()


def _slot(engines, t, n_steps):
    for e in engines:
        e.step_slot(t, n_steps=n_steps)


def test_mixed_pool_admit_precision_matches_reference(w):
    """tests/test_quant.py's mixed-pool scenario: admissions native by
    default, then the lever flipped to int8 and a new row lands on int8
    pages; both finish, with the reference's streams, allocator stats and
    counters after every slot."""
    ours, ref = _pair(w, num_pages=16, max_active=4, quant_pages=8)
    assert ours.admit_precision == "native"
    rng = np.random.default_rng(3)
    r0, r1 = _req(0, 0, 12, rng), _req(1, 1, 12, rng)
    for e in (ours, ref):
        e.submit([copy.deepcopy(r0)])
    _slot((ours, ref), 0, 2)
    assert {ours.allocator.precision_of(r) for r in ours.allocator.holders()} == {"native"}
    _same(w, ours, ref)
    for e in (ours, ref):
        e.admit_precision = "int8"
        e.submit([copy.deepcopy(r1)])
    _slot((ours, ref), 1, 1)
    assert {ours.allocator.precision_of(r) for r in ours.allocator.holders()} == \
        {"native", "int8"}
    _same(w, ours, ref)
    t = 2
    while len(ours.finished) < 2 and t < 30:
        _slot((ours, ref), t, 2)
        _same(w, ours, ref)
        t += 1
    assert len(ours.finished) == 2 and ours.counters()["pages_quant"] == 8


def test_all_int8_pool_counters_match_reference(w):
    """tests/test_quant.py's auto-quantized pool (quant_pages -1): every
    page int8, admissions on int8, quant_occupancy rising with the row."""
    ours, ref = _pair(w, num_pages=8, max_active=2)
    assert ours.admit_precision == "int8" and ours.counters()["pages_quant"] == 8
    assert ours.quant_occupancy() == 0.0
    r = _req(0, 0, 9, np.random.default_rng(5))
    for e in (ours, ref):
        e.submit([copy.deepcopy(r)])
    _slot((ours, ref), 0, 2)
    assert ours.quant_occupancy() > 0
    assert ours.counters()["quant_occupancy"] == ours.quant_occupancy()
    _same(w, ours, ref)
    for t in range(1, 6):
        _slot((ours, ref), t, 2)
        _same(w, ours, ref)
    assert len(ours.finished) == 1


def test_preempted_quant_row_readmits_at_current_precision(w):
    """Two rows admitted onto the 4-page int8 region of a mixed pool cannot
    both grow to a third page: the first is preempted, and with the lever
    back at native it is re-admitted onto native pages and recomputed.
    Streams, stats and counters equal the reference's throughout."""
    ours, ref = _pair(w, prompt_len=16, page_size=16, num_pages=8, quant_pages=4,
                      max_active=2, max_pages_per_req=3)
    rng = np.random.default_rng(7)
    reqs = [_req(i, 0, 16, rng, max_new=20) for i in range(2)]
    for e in (ours, ref):
        e.admit_precision = "int8"
        e.submit([copy.deepcopy(r) for r in reqs])
    precisions = []
    for t in range(40):
        _slot((ours, ref), t, 2)
        _same(w, ours, ref)
        precisions.append(sorted(ours.allocator.precision_of(r)
                                 for r in ours.allocator.holders()))
        if ours.preemptions:
            for e in (ours, ref):
                e.admit_precision = "native"
        if len(ours.finished) == 2:
            break
    assert ours.preemptions == 1 and len(ours.finished) == 2
    assert ["int8", "int8"] in precisions and any("native" in p for p in precisions)
    assert all(len(r.generated) == 20 for r in ours.finished)


def _recorded(sched) -> list:
    """Record every admission precision ``sched`` chooses."""
    log, ask = [], sched.admit_precision

    def recorded(occupancy):
        log.append(ask(occupancy))
        return log[-1]
    sched.admit_precision = recorded
    return log


def test_precision_aware_serve_trace_matches_reference(w):
    """The serve loop under PrecisionAware on a mixed pool that fills: the
    trace columns, the admission precision chosen each slot (flipping both
    ways) and the engines' state equal the reference's."""
    ours, ref = _pair(w, page_size=16, num_pages=24, quant_pages=8, max_active=8)
    rates = tuple(float(f) for f in range(1, 6))
    kw = dict(rates=rates, V=20.0, capacity=32, downgrade_at=0.5, upgrade_at=0.3)
    sched = PrecisionAwareScheduler(device="cpu", **kw)
    ref_sched = RefPrecisionAwareScheduler(**kw)
    got, want = _recorded(sched), _recorded(ref_sched)
    src_kw = dict(vocab_size=w["cfg"].vocab_size, prompt_len=16, raw_rate=5, max_new_tokens=6,
                  min_prompt_len=4)
    tr = serve(ours, sched, RequestSource(**src_kw), horizon=20, steps_per_slot=2)
    ref_tr = ref_serve(ref, ref_sched, RefSource(**src_kw), horizon=20, steps_per_slot=2)
    for col in COLUMNS:
        np.testing.assert_array_equal(tr[col], ref_tr[col], err_msg=col)
    assert got == want
    flips = [(a, b) for a, b in zip(got, got[1:]) if a != b]
    assert ("native", "int8") in flips and ("int8", "native") in flips
    _same(w, ours, ref)


# ---------------------------------------------------------------- launcher
QUANT_ARGS = ["--slots", "8", "--prompt-len", "512", "--min-prompt-len", "128",
              "--cache-len", "1024", "--raw-rate", "5", "--paged", "--max-active", "16",
              "--page-size", "16", "--num-pages", "192", "--policy", "precision-aware",
              "--kv-precision", "int8", "--quant-pages", "64", "--downgrade-at", "0.5",
              "--upgrade-at", "0.3"]


def test_launcher_quant_lines_match_reference():
    """The chip smoke's quantized serve geometry at the smoke model's
    widths: the summary, paged, quant and latency lines of both launchers."""
    with ThreadPoolExecutor(2) as pool:
        ours = pool.submit(_launch, "repro_torch.launch.serve", "--device", "cpu", *QUANT_ARGS)
        ref = pool.submit(_launch, "repro.launch.serve", *QUANT_ARGS)
        ours, ref = ours.result(), ref.result()
    assert ours == ref
    assert ours[:3] == [
        "policy=precision-aware served=31 dropped=0 tail_backlog=4.2 mean_rate=3.33 "
        "dispatches_per_slot=1.67 blocking_syncs_per_slot=1.67",
        "paged: peak_occupancy=0.95 peak_pages=182/192 peak_active=9 alloc_failures=11 "
        "preemptions=0",
        "quant: precision=int8 pages_quant=64/192 quant_occupancy=0.00 admit=int8 "
        "precision_flips=0"]


def test_precision_aware_fp8_admits_onto_the_fp8_region(capsys):
    """With fp8 pages the port hands the allocator's region tag to the
    policy; the reference passes the flag's spelling "fp8", which names no
    region, and its first downgrade raises (ROADMAP R6)."""
    from repro.launch import serve as ref_launcher
    from repro_torch.launch import serve as launcher
    argv = ["--arch", "granite-3-2b", "--smoke", "--horizon", "12", "--paged", "--policy",
            "precision-aware", "--kv-precision", "fp8", "--quant-pages", "32",
            "--downgrade-at", "0.2", "--upgrade-at", "0.1"]
    launcher.main([*argv, "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[2] == ("quant: precision=fp8 pages_quant=32/64 quant_occupancy=0.31 "
                        "admit=float8_e4m3fn precision_flips=0")
    import sys
    old, sys.argv = sys.argv, ["serve", *argv]
    try:
        with pytest.raises(ValueError, match="no 'fp8' page region"):
            ref_launcher.main()
    finally:
        sys.argv = old


@pytest.mark.parametrize("argv,err,match", [
    (["--policy", "precision-aware", "--kv-precision", "int8", "--quant-pages", "4"],
     ValueError, "requires --paged"),
    (["--paged", "--policy", "precision-aware"], ValueError, "needs a quantized page region"),
    (["--paged", "--policy", "precision-aware", "--kv-precision", "int8"], ValueError,
     r"--quant-pages in \(0, num-pages\)"),
    (["--paged", "--kv-precision", "int8", "--downgrade-at", "0.3", "--upgrade-at", "0.5"],
     ValueError, "hysteresis"),
    (["--kv-precision", "fp8"], NotImplementedError, "item 9"),
    (["--paged", "--kv-precision", "int8", "--chunked", "--policy", "precision-aware"],
     ValueError, r"--quant-pages in \(0, num-pages\)"),
])
def test_launcher_checks_quant_arguments(argv, err, match):
    from repro_torch.launch import serve as launcher
    with pytest.raises(err, match=match):
        launcher.main(["--arch", "granite-3-2b", "--smoke", "--device", "cpu", *argv])


def test_dense_engine_refuses_quantized_precision(w):
    from repro_torch.runtime import Engine, EngineConfig
    with pytest.raises(NotImplementedError, match="item 9"):
        Engine(w["port"], EngineConfig(kv_precision="int8"))
