"""The port's paged chunked prefill and paged sync-free loop against the
reference's: K4q's plain version (against the reference's oracle and its
Pallas kernel in interpret mode), ``attn_chunk_paged`` and ``fork_pages`` on
native, int8, fp8 and mixed pools with the pools carried across, the
paged ``chunk_step`` and the write targets that read nothing back (fault
F1), the paged sync-free and chunked engines over the workloads of
tests/test_differential.py (native, int8 and a mixed pool under
``PrecisionAware``), and the launcher's paged sync-free and chunked
lines."""
import copy
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache.precision import parse_kv_precision as ref_parse
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro.kernels.quant import quantize_kv as ref_quantize
from repro.models import attention as RA
from repro.models import model as RM
from repro.models import transformer as RT
from repro.runtime import PagedEngine as RefPagedEngine
from repro.runtime import PagedEngineConfig as RefPagedEngineConfig
from repro.runtime import PrecisionAwareScheduler as RefPrecisionAwareScheduler
from repro.runtime import RequestSource as RefSource
from repro.runtime import serve as ref_serve
from repro_torch.kernels import ops
from repro_torch.kernels import paged_chunk_attention as k_pca
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.models.convert import paged_pool_from_numpy
from repro_torch.runtime import (PagedEngine, PagedEngineConfig, PrecisionAwareScheduler,
                                 RequestSource, serve)
from test_differential import drive, make_workload
from test_torch_chunked import _launch_late, chunk_case, late_consume
from test_torch_engine import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    MARGIN, MarginComparator, _launch, _weights, one_torch_thread)
from test_torch_paged import COLUMNS, TOL

# float32 on both sides; the softmaxes differ only in summation order
ATOL = 2e-5
# K4q over keys whose per-head scales spread over 1e-2..1e2 (the spread of
# tests/test_quant.py's extreme case, whose 2e-5 the reference's own flash
# kernel misses here, ROADMAP R3): the port's own rule, relative to the
# output's largest magnitude (280 here). Large K scales sharpen the
# softmax, so the Pallas kernel's tiled online softmax and a full softmax
# round differently: measured 4.7e-6 of that magnitude against the Pallas
# kernel, 5.4e-8 against the oracle.
EXTREME_RTOL = 1e-5


def _t(a) -> torch.Tensor:
    """A numpy/JAX array as a CPU tensor (fp8 through its bytes)."""
    a = np.array(a)
    if a.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(a)


def _codes(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.view(torch.uint8).numpy()
    return np.asarray(t).view(np.uint8)


# ------------------------------------------------------------- K4q plain
@pytest.mark.parametrize("prec,spread", [("int8", False), ("fp8", False), ("int8", True)])
def test_plain_chunk_attention_quant_matches_pallas_and_oracle(prec, spread):
    """K4q's plain version over a chunk mix (a first chunk, a mid-prompt
    chunk with a hole, a partial final chunk, an inactive row) against the
    reference's quantized oracle and its Pallas kernel in interpret mode,
    float32 at 2e-5; with per-head scales spread over 1e-2..1e2, at the
    port's own rule (EXTREME_RTOL)."""
    rng = np.random.default_rng(7)
    B, C, L, H, KVH, hd = 4, 8, 32, 4, 2, 32
    q, k, v, sp, pos0, valid = chunk_case(rng, B, C, L, H, KVH, hd)
    if spread:
        mul = np.logspace(-2, 2, KVH, dtype=np.float32)[None, None, :, None]
        k, v = k * mul, v * mul
    # the garbage rows of chunk_case (+-1e30) quantize to +-qmax codes
    qk, ks = ref_quantize(jnp.asarray(k), ref_parse(prec))
    qv, vs = ref_quantize(jnp.asarray(v), ref_parse(prec))
    got = ops.chunk_attention(*map(_t, (q, qk, qv, sp, pos0, valid)), k_scale=_t(ks),
                              v_scale=_t(vs)).numpy()
    ora = np.asarray(ref_oracles.chunk_attention_quant_ref(q, qk, qv, ks, vs, sp, pos0, valid))
    pal = np.asarray(ref_ops.chunk_attention(q, qk, qv, sp, pos0, valid, k_scale=ks,
                                             v_scale=vs, impl="interpret", block_l=16))
    atol = EXTREME_RTOL * np.abs(ora).max() if spread else ATOL
    np.testing.assert_allclose(got, ora, atol=atol, rtol=0)
    np.testing.assert_allclose(got, pal, atol=atol, rtol=0)
    assert not got[valid == 0].any()


def test_chunk_kernels_refuse_cpu_tensors():
    q = torch.zeros((1, 4, 2, 32))
    codes = torch.zeros((1, 8, 1, 32), dtype=torch.int8)
    scale, i32 = torch.ones((1, 8, 1)), torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        k_pca.chunk_attention_quant(q, codes, codes, scale, scale,
                                    torch.zeros((1, 8), dtype=torch.int32), i32, i32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        k_pca.paged_chunk_attention(q, None, None, codes.view(2, 4, 1, 32),
                                    codes.view(2, 4, 1, 32), scale.view(2, 4, 1),
                                    scale.view(2, 4, 1), torch.zeros((1, 2), dtype=torch.int32),
                                    i32, i32)


# ----------------------------------------------------- attn_chunk_paged
# pools: (name, kv precision, native pages of N); N pages of ps rows
N, PS, MP = 16, 4, 5
POOLS = [("native", "", N), ("int8", "int8", 0), ("fp8", "fp8", 0), ("mixed", "int8", 7)]


def _pools(rng, cfg, kind, prec, nn, B, SL):
    """The same random pool contents for the reference (one layer) and the
    port (through ``paged_pool_from_numpy``): native pages, codes and
    scales, staging buffers under a lossy precision."""
    qcfg = cfg.replace(kv_precision=prec) if prec else cfg
    ref = RA.paged_pool_init(N, PS, qcfg, native_pages=nn, stage_rows=B, stage_len=SL)
    KVH, hd = cfg.n_kv_heads, cfg.head_dim_
    leaves = {}
    if nn:
        for name in ("k", "v"):
            leaves[name] = rng.standard_normal((nn, PS, KVH, hd)).astype(np.float32)
    if N - nn:
        for name, sname in (("qk", "k_scale"), ("qv", "v_scale")):
            x = rng.standard_normal((N - nn, PS, KVH, hd)).astype(np.float32)
            leaves[name], leaves[sname] = ref_quantize(jnp.asarray(x), ref_parse(prec))
    if ref.stage_k is not None:
        for name in ("stage_k", "stage_v"):
            leaves[name] = rng.standard_normal((B, SL, KVH, hd)).astype(np.float32)
    ref = ref._replace(**{n: jnp.asarray(a) for n, a in leaves.items()})
    return qcfg, ref, paged_pool_from_numpy(**{n: np.asarray(a) for n, a in leaves.items()})


def _chunk_rows(rng, B, C, L):
    """Block tables over a random permutation of the pool and per row
    (pos0, valid, base): a first chunk with no hit, a hit ending mid-page
    with the chunk starting there, a hit covering all but the last prompt
    token (the cap of ``_claim_row``) with a one-token chunk, and an
    inactive row (all -1). Each active row holds pages up to its chunk's
    last position."""
    perm = rng.permutation(N).astype(np.int32)
    bt = np.full((B, MP), -1, np.int32)
    rows = [(0, C, 0), (6, C, 6), (L - 1, 1, L - 1), (0, 0, 0)][:B]
    used = 0
    for b, (p0, nv, _base) in enumerate(rows):
        if nv:
            n = (p0 + nv - 1) // PS + 1
            bt[b, :n] = perm[used:used + n]
            used += n
    pos0, valid, base = (np.asarray(c, np.int32) for c in zip(*rows, strict=True))
    return bt, pos0, valid, base


@pytest.mark.parametrize("kind,prec,nn", POOLS)
def test_attn_chunk_paged_matches_reference(kind, prec, nn):
    """One layer's ``attn_chunk_paged`` on the same pool contents: the
    outputs of the valid chunk rows at 1e-4, the native pages and staging
    buffers the chunk wrote at 1e-4; the codes it wrote may differ at a
    half step (the K/V rows differ by ~1e-6 before quantization), so at
    most one code per row flips, and the scales agree to 1e-5."""
    w = _weights()
    cfg, params, port = w["cfg"], w["params"], w["port"]
    rng = np.random.default_rng(len(kind))
    B, C, L = 4, 8, 18
    qcfg, ref_pool, pool = _pools(rng, cfg, kind, prec, nn, B, L)
    bt, pos0, valid, base = _chunk_rows(rng, B, C, L)
    x = rng.standard_normal((B, C, cfg.d_model)).astype(np.float32)
    lp = jax.tree.map(lambda a: a[0], params["stack"][0]["attn"])
    ry, ref_pool = RA.attn_chunk_paged(lp, jnp.asarray(x), ref_pool, jnp.asarray(bt),
                                       jnp.asarray(pos0), jnp.asarray(valid), qcfg,
                                       base=jnp.asarray(base))
    tb, tp0, tv, tbase = map(torch.from_numpy, (bt, pos0, valid, base))
    writes = A.paged_chunk_targets(tb, tp0, tv, pool, C)
    y = A.attn_chunk_paged(port.stack[0][0].attn, torch.from_numpy(x), pool, tb, tp0, tv,
                           port.cfg, writes, tbase)
    live = np.arange(C)[None, :] < valid[:, None]
    np.testing.assert_allclose(y.numpy()[live], np.asarray(ry)[live], **TOL)
    assert not y.numpy()[~live].any()
    kn, vn, qk, qv, ks, vs = pool.regions()
    if nn:
        np.testing.assert_allclose(kn.numpy(), np.asarray(ref_pool.k), **TOL)
        np.testing.assert_allclose(vn.numpy(), np.asarray(ref_pool.v), **TOL)
    if N - nn:
        flips = (_codes(qk) != _codes(ref_pool.qk)).any(-1).sum(-1)
        assert flips.max() <= 1
        np.testing.assert_allclose(ks.numpy(), np.asarray(ref_pool.k_scale), rtol=1e-5, atol=0)
        np.testing.assert_allclose(vs.numpy(), np.asarray(ref_pool.v_scale), rtol=1e-5, atol=0)
    if pool.stage_k is not None:
        np.testing.assert_allclose(pool.stage_k[:, :L].numpy(), np.asarray(ref_pool.stage_k),
                                   **TOL)
        np.testing.assert_allclose(pool.stage_v[:, :L].numpy(), np.asarray(ref_pool.stage_v),
                                   **TOL)


@pytest.mark.parametrize("kind,prec,nn", POOLS)
def test_fork_pages_matches_reference(kind, prec, nn):
    """Whole-page copies per region, pads (dst outside the pool) dropped:
    every page equals the reference's bit for bit; the pads land on the
    scratch pages only."""
    w = _weights()
    rng = np.random.default_rng(3 + len(kind))
    _, ref_pool, pool = _pools(rng, w["cfg"], kind, prec, nn, 2, 8)
    pairs = [(1, 9), (12, 3)] if kind == "native" else [(nn + 1, nn + 2), (N - 1, N - 4)]
    if kind == "mixed":
        pairs = [(0, 5), (nn + 1, N - 2)]   # one fork in each region
    src = np.asarray([s for s, _ in pairs] + [4, 0], np.int32)
    dst = np.asarray([d for _, d in pairs] + [N, N], np.int32)   # two pads
    before = [None if t is None else t.clone() for t in pool]
    ref_pool = RA.fork_pages(ref_pool, jnp.asarray(src), jnp.asarray(dst))
    A.fork_pages(pool, torch.from_numpy(src).long(), torch.from_numpy(dst).long())
    for name, got, want in zip(("k", "v", "qk", "qv", "k_scale", "v_scale"), pool.regions(),
                               ref_pool[:6], strict=True):
        if got is None:
            assert want is None
            continue
        np.testing.assert_array_equal(_codes(got) if got.dtype != torch.float32 else got.numpy(),
                                      _codes(want) if got.dtype != torch.float32
                                      else np.asarray(want), err_msg=name)
    allowed = {"native": {d for d in dst if d < nn} | {nn},     # region-local; scratch last
               "quant": {d - nn for d in dst if nn <= d < N} | {N - nn}}
    for region, t, b in zip(("native",) * 2 + ("quant",) * 4, pool[:6], before[:6],
                            strict=True):
        if t is not None:
            pages = set((t != b).reshape(t.shape[0], -1).any(-1).nonzero()[:, 0].tolist())
            assert pages <= allowed[region]


# ------------------------------------------------------------ chunk_step
@pytest.mark.parametrize("prec,nn", [("", N), ("int8", 0), ("int8", 9)])
def test_chunk_step_paged_matches_reference(prec, nn):
    """Two chunks of three rows through the whole smoke model: a row whose
    prompt enters at 0, a row whose prefix [0, 6) is already resident
    (base 6: pool pages on a lossy pool, staging from 6 on) and an idle
    row; last-token logits and positions against the reference's."""
    w = _weights()
    cfg, params, port = w["cfg"], w["params"], w["port"]
    rng = np.random.default_rng(11)
    B, C, SL = 3, 8, 24
    qcfg = cfg.replace(kv_precision=prec) if prec else cfg
    ref_pools = RT.paged_pools_init(qcfg, N, PS, native_pages=nn, stage_rows=B, stage_len=SL)
    leaves = [{n: np.asarray(a) for n, a in zip(p._fields, p, strict=True) if a is not None}
              for p in ref_pools]
    for p in leaves:   # random resident contents, as an earlier tenant leaves them
        for n, a in p.items():
            if a.dtype == np.int8:
                p[n] = rng.integers(-127, 128, a.shape).astype(np.int8)
            else:
                x = rng.standard_normal(a.shape).astype(np.float32)
                p[n] = np.abs(x) / 64 if n.endswith("scale") else x
    ref_pools = [rp._replace(**{n: jnp.asarray(a) for n, a in p.items()})
                 for rp, p in zip(ref_pools, leaves, strict=True)]
    pools = [paged_pool_from_numpy(**p) for p in leaves]
    bt = np.full((B, MP), -1, np.int32)
    bt[0, :4] = [3, 8, 1, 14]
    bt[1, :5] = [5, 0, 11, 2, 9]
    base = np.asarray([0, 6, 0], np.int32)
    rstate = RM.PagedDecodeState(ref_pools, jnp.asarray(bt), jnp.zeros(B, jnp.int32),
                                 jnp.zeros(B, jnp.int32))
    state = M.PagedDecodeState(pools, torch.from_numpy(bt), torch.zeros(B, dtype=torch.int32),
                               torch.zeros(B, dtype=torch.int32))
    for pos0, valid in (([0, 6, 0], [8, 8, 0]), ([8, 14, 0], [5, 3, 0])):
        toks = rng.integers(0, cfg.vocab_size, (B, C)).astype(np.int32)
        pos0, valid = np.asarray(pos0, np.int32), np.asarray(valid, np.int32)
        rlogits, rstate = RM.chunk_step_paged(params, rstate, jnp.asarray(toks),
                                              jnp.asarray(pos0), jnp.asarray(valid), qcfg,
                                              base=jnp.asarray(base))
        logits, state = M.chunk_step_paged(port, state, *map(torch.from_numpy,
                                                             (toks, pos0, valid, base)))
        live = valid > 0
        np.testing.assert_allclose(logits.numpy()[live], np.asarray(rlogits)[live], **TOL)
        np.testing.assert_array_equal(state.pos.numpy(), np.asarray(rstate.pos))
        np.testing.assert_array_equal(state.last_tok.numpy(), np.asarray(rstate.last_tok))


class _NoReadback:
    """Every way a tensor reaches the host raises inside the block."""

    NAMES = ("tolist", "item", "cpu", "numpy", "__bool__")

    def __enter__(self):
        self.saved = {n: getattr(torch.Tensor, n) for n in self.NAMES}

        def refuse(name):
            def f(self, *a, **kw):
                raise AssertionError(f"a host readback: Tensor.{name}")
            return f
        for n in self.NAMES:
            setattr(torch.Tensor, n, refuse(n))
        return self

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(torch.Tensor, n, f)


@pytest.mark.parametrize("prec,nn", [("", N), ("int8", 0), ("fp8", 9)])
def test_paged_steps_read_nothing_back(prec, nn):
    """Fault F1: ``decode_step_paged`` and ``chunk_step_paged`` run with
    every host readback patched to raise, over an inactive row, a position
    past its table and rows in either region. Their write targets come
    from the device's positions, and dropped writes go to the scratch
    pages."""
    port = _weights()["port"]
    cfg = port.cfg.replace(kv_precision=prec) if prec else port.cfg
    B = 4
    pools = T.paged_pools_init(cfg, N, PS, "cpu", native_pages=nn, stage_rows=B, stage_len=16)
    bt = torch.tensor([[-1] * MP, [3, 12, -1, -1, -1], [10, 2, 15, 4, 7], [6, 13, 0, 5, 1]],
                      dtype=torch.int32)
    state = M.PagedDecodeState(pools, bt, torch.tensor([0, 5, 19, 25], dtype=torch.int32),
                               torch.zeros(B, dtype=torch.int32))
    toks = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    chunk = torch.arange(B * 4, dtype=torch.int32).view(B, 4)
    with _NoReadback():
        logits, state = M.decode_step_paged(port, state, toks)
        logits2, state = M.chunk_step_paged(
            port, state, chunk, torch.tensor([0, 5, 8, 2], dtype=torch.int32),
            torch.tensor([0, 3, 4, 4], dtype=torch.int32),
            torch.tensor([0, 4, 0, 2], dtype=torch.int32))
    assert torch.isfinite(logits).all() and torch.isfinite(logits2).all()
    assert state.pos.tolist() == [1, 8, 12, 6]


# ---------------------------------------------------------------- engines
def _pair(w, **kw):
    base = dict(prompt_len=16, cache_len=64, page_size=8, num_pages=32, max_active=6)
    base.update(kw)
    return (PagedEngine(w["port"], PagedEngineConfig(**base)),
            late_consume(RefPagedEngine(w["cfg"], w["params"], RefPagedEngineConfig(**base))))


def _counters(engine) -> dict:
    """The engine's counters but ``readback_waits``, which times the host
    against the device (the reference's with its early consume forced off
    counts every packet)."""
    c = engine.counters()
    del c["readback_waits"]
    return c


def _check(w, ours, ref, mode, reqs, schedule, exact=False, n_steps=2):
    got = drive(ours, mode, reqs, schedule, n_steps=n_steps)
    want = drive(ref, mode, reqs, schedule, n_steps=n_steps)
    streams, retired, (served, finished) = got
    assert served == finished == len(reqs)
    assert retired == want[1]
    assert ours.served_history == ref.served_history       # per-slot conservation
    assert ours.decode_dispatches == ref.decode_dispatches
    assert ours.prefill_dispatches == ref.prefill_dispatches
    assert ours.blocking_syncs == ref.blocking_syncs == 0
    assert _counters(ours) == _counters(ref)
    if exact:
        assert streams == want[0]
    else:
        MarginComparator(w["params"], w["cfg"], 64, MARGIN).check(
            {k: list(v) for k, v in streams.items()}, {k: list(v) for k, v in want[0].items()},
            {r.rid: r.tokens for r in reqs})
    ours.allocator.check()
    return streams


@pytest.mark.parametrize("mode", ["sync", "chunked"])
@pytest.mark.parametrize("prec", ["", "int8"])
def test_paged_engine_matches_reference(mode, prec):
    """The bursty ragged workload through the paged sync-free and chunked
    loops, native and all-int8: streams, retirement, per-slot served
    counts, dispatches and every counter equal the reference's. The int8
    cells are held exactly (both sides quantize the same values)."""
    w = _weights()
    reqs, schedule = make_workload(seed=0)
    ours, ref = _pair(w, kv_precision=prec, chunk_size=4 if mode == "chunked" else 0)
    _check(w, ours, ref, mode, reqs, schedule, exact=bool(prec))


@pytest.mark.parametrize("mode,kw", [("sync", {}), ("chunked", {"chunk_size": 8})])
def test_paged_preemption_pressure_matches_reference(mode, kw):
    """A pool too small for the load (10 pages): decode preemption, and on
    the chunked loop prefill preemption; the same schedule and counters as
    the reference's."""
    w = _weights()
    reqs, schedule = make_workload(seed=7, n_reqs=8, max_new_lo=4, max_new_hi=10)
    ours, ref = _pair(w, num_pages=10, **kw)
    _check(w, ours, ref, mode, reqs, schedule)
    assert ours.preemptions > 0


@pytest.mark.parametrize("mode", ["sync", "chunked"])
def test_precision_aware_paged_loops_match_reference(mode):
    """A mixed pool (64 native, 32 int8 pages) under ``PrecisionAware`` on
    the sync-free and chunked loops (one-slot-lagged control): the serve
    trace, the admission precision and the counters equal the reference's
    on the launcher's smoke workload."""
    w = _weights()
    kw = dict(prompt_len=16, cache_len=64, page_size=16, num_pages=64, max_active=16,
              kv_precision="int8", quant_pages=32)
    ours = PagedEngine(w["port"], PagedEngineConfig(**kw))
    ref = late_consume(RefPagedEngine(w["cfg"], w["params"], RefPagedEngineConfig(**kw)))
    rates = tuple(float(f) for f in range(1, 6))
    pkw = dict(rates=rates, V=20.0, quant_budget=0.6, downgrade_at=0.2, upgrade_at=0.1,
               quant_precision="int8", capacity=32)
    src = dict(vocab_size=w["cfg"].vocab_size, prompt_len=16, raw_rate=5, max_new_tokens=4)
    flags = dict(sync_free=mode == "sync", chunked=mode == "chunked")
    tr = serve(ours, PrecisionAwareScheduler(**pkw), RequestSource(**src), horizon=12,
               steps_per_slot=2, **flags)
    ref_tr = ref_serve(ref, RefPrecisionAwareScheduler(**pkw), RefSource(**src), horizon=12,
                       steps_per_slot=2, **flags)
    for col in COLUMNS + ("occupancy",):
        np.testing.assert_array_equal(tr[col], ref_tr[col], err_msg=col)
    assert ours.admit_precision == ref.admit_precision
    assert _counters(ours) == _counters(ref)
    # the latch moved admissions onto the int8 pages once occupancy passed 0.2
    assert max(tr["occupancy"]) > 0.2 and ours.admit_precision == "int8"
    assert ours.allocator.stats().quant_used_pages > 0
    ours.allocator.check()


def test_paged_sync_admission_refuses_a_long_budget():
    """The sync-free admission checks the token ring before it pops."""
    w = _weights()
    ours, _ = _pair(w, gen_buf_len=4)
    reqs, _ = make_workload(seed=0, n_reqs=1, max_new_lo=9, max_new_hi=9)
    ours.submit(copy.deepcopy(reqs))
    with pytest.raises(ValueError, match="gen_buf_len"):
        ours.step_slot_sync(0)
    with pytest.raises(ValueError, match="gen_buf_len"):
        ours.step_slot_chunked(0)
    assert len(ours.pending) == 1


# ---------------------------------------------------------------- launcher
@pytest.mark.parametrize("args", [("--paged", "--sync-free"),
                                  ("--paged", "--sync-free", "--policy", "memory-aware",
                                   "--num-pages", "12"),
                                  ("--paged", "--chunked", "--policy", "token-aware")])
def test_launcher_paged_loop_lines_match_reference(args):
    """The launcher's summary, paged and latency lines equal the
    reference's (its early consume off, ROADMAP R5), also under
    ``MemoryAware`` on a full pool (one-slot-lagged control)."""
    with ThreadPoolExecutor(2) as pool:   # the two launchers side by side
        ours = pool.submit(_launch, "repro_torch.launch.serve", "--device", "cpu", *args)
        ref = pool.submit(_launch_late, "repro.launch.serve", *args)
        ours, ref = ours.result(), ref.result()
    assert ours == ref
    assert "blocking_syncs_per_slot=0.00" in ours[0]
