"""The port's MoE stack (olmoe-1b-7b, deepseek-moe-16b with its shared
experts and dense first layer) against the reference's: ``moe_ffn`` and
its auxiliary terms, the last-writer rule of the reference's capacity
table (ROADMAP.md R8), top-k ties, the dispatch invariants of
tests/test_moe.py, blocked dispatch, the smoke models' prefill and decode,
the dense and paged engines' traces and streams, what free rows feed the
decode, and the launcher's lines and refusals."""
import copy
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import init_params as ref_init_params
from repro.models import model as RM
from repro.models import moe as RMOE
from repro.runtime import AdaptiveScheduler as RefAdaptive
from repro.runtime import Engine as RefEngine
from repro.runtime import EngineConfig as RefEngineConfig
from repro.runtime import MemoryAwareScheduler as RefMemoryAwareScheduler
from repro.runtime import PagedEngine as RefPagedEngine
from repro.runtime import PagedEngineConfig as RefPagedEngineConfig
from repro.runtime import RequestSource as RefSource
from repro.runtime import serve as ref_serve
from repro_torch.configs import get_config
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime import (AdaptiveScheduler, Engine, EngineConfig, MemoryAwareScheduler,
                                 PagedEngine, PagedEngineConfig, RequestSource, serve)
from test_torch_chunked import _launch_late, late_consume
from test_torch_engine import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    COLUMNS, MARGIN, SRC, _launch, one_torch_thread)
from test_torch_ssm import PaddedPromptComparator

ARCHS = ("olmoe-1b-7b", "deepseek-moe-16b")
KEY = jax.random.PRNGKey(11)
# float32 on both sides. The router, the expert products and the combine
# differ only in summation order (measured 1e-6 of an output scale of 3-4
# on the smoke configs); 2e-5 keeps a margin and is far below one expert's
# share of a token's output, which a wrong slot or weight would move.
FFN_TOL = dict(atol=2e-5, rtol=2e-5)
# the model tolerance of tests/test_torch_model.py: two layers leave ~1e-6
# on the logits and caches (measured 8e-7 here)
TOL = dict(atol=1e-4, rtol=1e-4)
_M = {}


def _cfgs(arch, **kw):
    ref_cfg, cfg = ref_get_config(arch, smoke=True), get_config(arch, smoke=True)
    return (ref_cfg.replace(**kw), cfg.replace(**kw)) if kw else (ref_cfg, cfg)


def _port_moe(p, cfg) -> MOE.MoE:
    """The port's MoE holding the reference's ``moe`` leaves ``p``."""
    m = MOE.MoE(cfg, "cpu")
    with torch.no_grad():
        for name in ("router", "w_gate", "w_up", "w_down"):
            getattr(m, name).copy_(torch.from_numpy(np.array(p[name])))
        for name in ("w_gate", "w_up", "w_down") if m.shared is not None else ():
            getattr(m.shared, name).copy_(torch.from_numpy(np.array(p["shared"][name])))
    return m


def _pair(arch, **kw):
    """(reference config, its ``moe_init`` leaves, port config, port MoE)."""
    ref_cfg, cfg = _cfgs(arch, **kw)
    p = RMOE.moe_init(KEY, ref_cfg)
    return ref_cfg, p, cfg, _port_moe(p, cfg)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(p, m, ref_cfg, cfg, x):
    """y and aux from the reference and from the port (numpy)."""
    y, aux = RMOE.moe_ffn(p, jnp.asarray(x), ref_cfg)
    yt, routings = MOE.moe_ffn(m, torch.from_numpy(x), cfg)
    terms = [MOE.moe_aux(r, cfg) for r in routings]
    auxt = {k: torch.stack([t[k] for t in terms]).mean() for k in terms[0]}
    return (np.asarray(y), {k: float(v) for k, v in aux.items()},
            yt.numpy(), {k: float(v) for k, v in auxt.items()})


def _check_aux(got, want):
    assert got.keys() == want.keys()
    assert got["drop_frac"] == want["drop_frac"]     # counts: exact
    for k in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


# ------------------------------------------------------------ the FFN
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, capacity_factor):
    """(4, 16) tokens; at capacity 0.5 half the assignments drop."""
    ref_cfg, p, cfg, m = _pair(arch, capacity_factor=capacity_factor)
    y, aux, yt, auxt = _both(p, m, ref_cfg, cfg, _x(0, (4, 16, cfg.d_model)))
    np.testing.assert_allclose(yt, y, **FFN_TOL)
    _check_aux(auxt, aux)
    assert (aux["drop_frac"] > 0) == (capacity_factor < 1)


def test_dropped_assignment_takes_expert_0s_last_slot():
    """ROADMAP.md R8. With a zero router every token picks experts 0 and 1
    (a tie, weights 1/2 each); 16 tokens at capacity 0.5 give C = 8, so
    tokens 8-15 drop. Every dropped assignment writes the reference's
    table cell (expert 0, slot 7) after token 7's kept one, so token 7
    gets only expert 1's half; tokens 0-6 get both halves. The port does
    the same."""
    ref_cfg, p, cfg, m = _pair("olmoe-1b-7b", capacity_factor=0.5)
    p["router"] = jnp.zeros_like(p["router"])
    with torch.no_grad():
        m.router.zero_()
    x = _x(1, (16, cfg.d_model))
    assert MOE.expert_capacity(16, cfg) == RMOE.expert_capacity(16, ref_cfg) == 8
    y, aux, yt, auxt = _both(p, m, ref_cfg, cfg, x)
    np.testing.assert_allclose(yt, y, **FFN_TOL)
    _check_aux(auxt, aux)

    def expert(e, xs):
        wg, wu, wd = (np.asarray(p[k][e]) for k in ("w_gate", "w_up", "w_down"))
        g = xs @ wg
        return ((g / (1 + np.exp(-g))) * (xs @ wu)) @ wd
    half0, half1 = 0.5 * expert(0, x), 0.5 * expert(1, x)
    np.testing.assert_allclose(yt[:7], half0[:7] + half1[:7], **FFN_TOL)
    np.testing.assert_allclose(yt[7], half1[7], **FFN_TOL)
    assert np.abs(yt[7] - (half0[7] + half1[7])).max() > 0.1   # expert 0's half is gone
    assert not yt[8:].any()


@pytest.mark.parametrize("rows", [
    [[0.25, 0.25, 0.25, 0.25]],
    [[0.1, 0.3, 0.3, 0.3], [0.3, 0.1, 0.3, 0.3], [0.4, 0.2, 0.2, 0.2]],
    "many_ties",
])
def test_top_k_ties_resolve_to_the_lower_expert(rows):
    """``route`` orders experts as ``jax.lax.top_k`` does: by descending
    probability, equal ones by ascending index."""
    if rows == "many_ties":   # 64 experts, values from a few levels
        rows = np.random.default_rng(2).integers(0, 4, (32, 64)).astype(np.float32) / 8
    probs = np.asarray(rows, np.float32)
    for k in (1, 2, 3):
        wp, we = jax.lax.top_k(jnp.asarray(probs), k)
        gp, ge = MOE.route(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ge.numpy(), np.asarray(we))
        np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))


def _perm_case(ref_cfg, p, cfg, m):
    x = _x(3, (2, 8, cfg.d_model))
    perm = np.asarray([2, 0, 3, 1])
    p2 = dict(p, router=p["router"][:, perm], **{k: p[k][perm] for k in ("w_gate", "w_up",
                                                                          "w_down")})
    y1 = MOE.moe_ffn(m, torch.from_numpy(x), cfg)[0].numpy()
    y2 = MOE.moe_ffn(_port_moe(p2, cfg), torch.from_numpy(x), cfg)[0].numpy()
    np.testing.assert_allclose(y1, y2, atol=1e-5, rtol=1e-5)
    return x


INVARIANTS = {  # tests/test_moe.py's cases: (arch, config overrides)
    "drops_counted": ("olmoe-1b-7b", dict(capacity_factor=0.25)),
    "no_drops_at_high_capacity": ("olmoe-1b-7b", dict(capacity_factor=8.0)),
    "uniform_router_balanced_lb_loss": ("olmoe-1b-7b", dict(capacity_factor=8.0)),
    "expert_permutation_invariance": ("olmoe-1b-7b", dict(capacity_factor=8.0)),
    "shared_experts_always_on": ("deepseek-moe-16b", dict(capacity_factor=8.0)),
}


@pytest.mark.parametrize("case", sorted(INVARIANTS))
def test_dispatch_invariants_match_reference(case):
    """Each invariant of tests/test_moe.py holds on the port, and the
    port's y and aux equal the reference's on the case's input."""
    arch, kw = INVARIANTS[case]
    ref_cfg, p, cfg, m = _pair(arch, **kw)
    x = _x(4, (8, 16, cfg.d_model))
    if case == "uniform_router_balanced_lb_loss":
        p["router"] = jnp.zeros_like(p["router"])
        m = _port_moe(p, cfg)
        x = _x(4, (16, 16, cfg.d_model))
    elif case == "expert_permutation_invariance":
        x = _perm_case(ref_cfg, p, cfg, m)
    elif case == "shared_experts_always_on":
        p["w_down"] = jnp.zeros_like(p["w_down"])   # the routed path gives nothing
        m = _port_moe(p, cfg)
        x = _x(4, (2, 8, cfg.d_model))
    y, aux, yt, auxt = _both(p, m, ref_cfg, cfg, x)
    np.testing.assert_allclose(yt, y, **FFN_TOL)
    _check_aux(auxt, aux)
    if case == "drops_counted":
        assert auxt["drop_frac"] > 0.0
    elif case == "no_drops_at_high_capacity":
        assert auxt["drop_frac"] == 0.0
    elif case == "uniform_router_balanced_lb_loss":
        assert auxt["lb_loss"] == pytest.approx(1.0, abs=0.05)
    elif case == "shared_experts_always_on":
        assert np.abs(yt).sum() > 0.0
        shared = m.shared(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(yt, shared, **FFN_TOL)


def test_blocked_dispatch_equals_unblocked_and_reference():
    """tests/test_perf_knobs.py's case: blocks of 32 tokens (capacity per
    block) against one block, at a capacity where nothing drops; and the
    blocked dispatch, aux averaged over the blocks, against the
    reference's scan."""
    ref_cfg, p, cfg, m = _pair("olmoe-1b-7b", capacity_factor=8.0, moe_block=32)
    x = _x(5, (4, 32, cfg.d_model))
    y_blk, aux, yt_blk, auxt = _both(p, m, ref_cfg, cfg, x)
    yt_full = MOE.moe_ffn(m, torch.from_numpy(x), cfg.replace(moe_block=1 << 20))[0].numpy()
    np.testing.assert_allclose(yt_blk, yt_full, atol=1e-5)
    np.testing.assert_allclose(yt_blk, y_blk, **FFN_TOL)
    _check_aux(auxt, aux)


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_capacity_matches_reference(arch):
    ref_cfg, cfg = _cfgs(arch)
    for T_ in range(1, 130):
        for cf in (0.25, 0.5, 1.25, 8.0):
            assert MOE.expert_capacity(T_, cfg.replace(capacity_factor=cf)) == \
                RMOE.expert_capacity(T_, ref_cfg.replace(capacity_factor=cf))


# ---------------------------------------------------------- the models
def _models(arch, **kw):
    key = (arch, tuple(sorted(kw.items())))
    if key not in _M:
        ref_cfg, cfg = _cfgs(arch, **kw)
        params = ref_init_params(jax.random.PRNGKey(0), ref_cfg)
        port = params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
        _M[key] = (ref_cfg, params, port)
    return _M[key]


def _check_state(got, want):
    assert len(got.caches) == len(want.caches)
    for g, w in zip(got.caches, want.caches):
        np.testing.assert_allclose(g.k.numpy(), np.asarray(w.k), **TOL)
        np.testing.assert_allclose(g.v.numpy(), np.asarray(w.v), **TOL)
        np.testing.assert_array_equal(g.slot_pos.numpy(), np.asarray(w.slot_pos))
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
    np.testing.assert_array_equal(got.last_tok.numpy(), np.asarray(want.last_tok))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """A padded bucket with zero pads (as the engines prefill), then greedy
    decode steps; deepseek's stack is a dense layer and an MoE one."""
    cfg, params, port = _models(arch)
    assert [s.kind for s in T.plan_segments(port.cfg)] == (
        ["attn", "attn_moe"] if arch.startswith("deepseek") else ["attn_moe"])
    B, S = 4, 16
    toks = np.random.default_rng(0).integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    toks[1, 5:] = 0
    toks[3, 11:] = 0
    ref_logits, ref_state = RM.prefill(params, {"tokens": jnp.asarray(toks)}, cfg, 64)
    logits, state = prefill(port, torch.from_numpy(toks), 64)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    _check_state(state, ref_state)
    nxt = np.asarray(jnp.argmax(ref_logits, -1)).astype(np.int32)
    assert (logits.argmax(-1).numpy() == nxt).all()
    for _ in range(4):
        ref_logits, ref_state = RM.decode_step(params, ref_state, jnp.asarray(nxt), cfg)
        logits, state = decode_step(port, state, torch.from_numpy(nxt))
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
        nxt = np.asarray(jnp.argmax(ref_logits, -1)).astype(np.int32)
        assert (logits.argmax(-1).numpy() == nxt).all()
    _check_state(state, ref_state)


def test_moe_stack_refuses_chunks_and_ragged_buckets():
    """MoE couples tokens through capacity: the stack takes no chunked
    prefill and the engines no ragged bucket, as the reference's."""
    _, _, port = _models("olmoe-1b-7b")
    assert not T.ragged_prefill_supported(port.cfg)
    assert not T.chunked_prefill_supported(port.cfg)
    assert T.paged_segments_supported(port.cfg)
    caches = prefill(port, torch.zeros((1, 4), dtype=torch.int32), 64)[1].caches
    with pytest.raises(ValueError, match="chunked prefill is not supported for 'attn_moe'"):
        T.chunk_hidden(port.stack, torch.zeros((1, 4, port.cfg.d_model)), caches,
                       torch.zeros(1, dtype=torch.int32), torch.ones(1, dtype=torch.int32),
                       torch.zeros(1, dtype=torch.bool), port.cfg)


def test_init_params_draws_the_moe_leaves_at_the_reference_scales():
    cfg = get_config("deepseek-moe-16b", smoke=True)
    a = init_params(cfg, seed=5, device="cpu")
    b = init_params(cfg, seed=5, device="cpu")
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    D, Fd, S = cfg.d_model, cfg.moe_d_ff, cfg.n_shared_experts * cfg.moe_d_ff
    moe = a.stack[1][0].moe
    for t, scale in ((moe.router, D), (moe.w_gate, D), (moe.w_up, D), (moe.w_down, Fd),
                     (moe.shared.w_gate, D), (moe.shared.w_down, S),
                     (a.stack[0][0].w_down, cfg.d_ff)):
        assert abs(t.std().item() - scale ** -0.5) < 0.1 * scale ** -0.5
    assert moe.router.dtype == torch.float32


def test_moe_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(get_config("olmoe-1b-7b", smoke=True))


# ------------------------------------------------------------ the engines
def _streams(engine):
    reqs = engine.finished + [r for r in engine.active if r is not None and r.generated]
    return {r.rid: list(r.generated) for r in reqs}, {r.rid: r.tokens for r in reqs}


def _same_streams(params, cfg, ours, ref, prompt_len):
    got, prompts = _streams(ours)
    want, _ = _streams(ref)
    assert sum(map(len, got.values())) > 0
    PaddedPromptComparator(params, cfg, 64, MARGIN, prompt_len).check(got, want, prompts)


class DecodeDrops:
    """Counts the MoE blocks of ``tokens`` tokens (a decode's batch) in
    which an assignment dropped."""

    def __init__(self, monkeypatch, tokens: int):
        self.n, block = 0, MOE._moe_block

        def counted(moe, xt, cfg):
            y, r = block(moe, xt, cfg)
            if xt.shape[0] == tokens and not bool(r.keep.all()):
                self.n += 1
            return y, r
        monkeypatch.setattr(MOE, "_moe_block", counted)


@pytest.mark.parametrize("mode", ["fused", "legacy", "sync"])
def test_engine_trace_and_streams_match_reference(mode):
    """olmoe on the dense engine: prompts of 5-16 tokens right-padded to
    the bucket of 16, the serve trace, counters and greedy streams equal
    the reference's."""
    cfg, params, port = _models("olmoe-1b-7b")
    kw = dict(batch_slots=4, prompt_len=16, cache_len=64)
    src_kw = dict(vocab_size=cfg.vocab_size, prompt_len=16, raw_rate=5, max_new_tokens=4,
                  min_prompt_len=5)
    rates = tuple(float(f) for f in range(1, 6))
    run = dict(horizon=12, steps_per_slot=2, fused=mode != "legacy", sync_free=mode == "sync")
    ref = RefEngine(cfg, params, RefEngineConfig(**kw))
    if mode == "sync":
        late_consume(ref)
    ref_tr = ref_serve(ref, RefAdaptive(rates=rates, V=20.0, capacity=32), RefSource(**src_kw),
                       **run)
    ours = Engine(port, EngineConfig(**kw))
    tr = serve(ours, AdaptiveScheduler(rates=rates, V=20.0, capacity=32, device="cpu"),
               RequestSource(**src_kw), **run)
    for col in COLUMNS:
        np.testing.assert_array_equal(tr[col], ref_tr[col], err_msg=col)
    assert ours.counters() == {**ref.counters(), "readback_waits": 0}
    _same_streams(params, cfg, ours, ref, 16)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_paged_engine_with_16_rows_matches_reference(capacity_factor, monkeypatch):
    """olmoe on the paged engine with 16 rows under MemoryAware. At the
    smoke config's capacity a decode of 16 tokens never drops (C = 16); at
    0.5 (C = 8) its assignments drop and the free rows' tokens compete for
    the slots: the trace, the pool and the streams still equal the
    reference's."""
    cfg, params, port = _models("olmoe-1b-7b", capacity_factor=capacity_factor)
    drops = DecodeDrops(monkeypatch, 16)
    base = dict(prompt_len=16, cache_len=64, page_size=8, num_pages=96, max_active=16)
    ours = PagedEngine(port, PagedEngineConfig(**base))
    ref = RefPagedEngine(cfg, params, RefPagedEngineConfig(**base))
    rates = tuple(float(f) for f in range(2, 11, 2))
    src_kw = dict(vocab_size=cfg.vocab_size, prompt_len=16, raw_rate=10, max_new_tokens=6,
                  min_prompt_len=3)
    tr = serve(ours, MemoryAwareScheduler(rates=rates, V=20.0, capacity=64, device="cpu"),
               RequestSource(**src_kw), horizon=10, steps_per_slot=2)
    ref_tr = ref_serve(ref, RefMemoryAwareScheduler(rates=rates, V=20.0, capacity=64),
                       RefSource(**src_kw), horizon=10, steps_per_slot=2)
    for col in COLUMNS:
        np.testing.assert_array_equal(tr[col], ref_tr[col], err_msg=col)
    assert ours.peak_active > 8
    assert dataclasses.asdict(ours.allocator.stats()) == dataclasses.asdict(ref.allocator.stats())
    assert ours.counters() == ref.counters()
    _same_streams(params, cfg, ours, ref, 16)
    assert (drops.n > 0) == (capacity_factor < 1)


def _spy_prefill(engine, attr):
    """Record the token batch of every admission prefill ``engine`` runs."""
    seen, run = [], getattr(engine, attr)

    def spied(toks, *a, **kw):
        t = toks["tokens"] if isinstance(toks, dict) else toks
        seen.append(np.array(t))
        return run(toks, *a, **kw)
    setattr(engine, attr, spied)
    return seen


@pytest.mark.parametrize("kind", ["fused", "sync", "paged", "paged_sync"])
def test_rows_feed_what_the_reference_feeds(kind):
    """What a live row gets from an MoE block depends on every row of the
    dispatch (capacity is shared in flat row order). So each admission's
    prefill batch must hold the admitted requests in the reference's rows
    with the reference's pads, and after every slot each row, free ones
    included, must carry the reference's position, last token and (on the
    sync-free loops) stop state into the next decode."""
    paged = kind.startswith("paged")
    cfg, params, port = _models("olmoe-1b-7b", capacity_factor=0.5)
    if paged:
        base = dict(prompt_len=16, cache_len=64, page_size=8, num_pages=96, max_active=8)
        ours = PagedEngine(port, PagedEngineConfig(**base))
        ref = RefPagedEngine(cfg, params, RefPagedEngineConfig(**base))
    else:
        base = dict(batch_slots=4, prompt_len=16, cache_len=64)
        ours, ref = Engine(port, EngineConfig(**base)), RefEngine(cfg, params,
                                                                  RefEngineConfig(**base))
    sync = kind.endswith("sync")
    if sync:
        late_consume(ref)
    ours_seen, ref_seen = _spy_prefill(ours, "_prefill"), _spy_prefill(ref, "_run_prefill")
    src = RefSource(vocab_size=cfg.vocab_size, prompt_len=16, raw_rate=6, max_new_tokens=5,
                    min_prompt_len=3, seed=8)
    for t in range(8):
        reqs = src.poll(t, 3.0 if t % 3 else 0.0)
        for e in (ours, ref):
            e.submit([copy.deepcopy(r) for r in reqs])
            (e.step_slot_sync if sync else e.step_slot)(t, n_steps=2)
        if paged:
            np.testing.assert_array_equal(ours.pos, ref.pos)
            np.testing.assert_array_equal(ours.block_tables, ref.block_tables)
        else:
            np.testing.assert_array_equal(ours.state.pos.numpy(), np.asarray(ref.state.pos))
            np.testing.assert_array_equal(ours.state.last_tok.numpy(),
                                          np.asarray(ref.state.last_tok))
        if sync:
            for f in ("cur_tok", "age", "budget", "done", "gen_buf"):
                np.testing.assert_array_equal(getattr(ours.sync, f).numpy(),
                                              np.asarray(getattr(ref.sync, f)), err_msg=f)
    assert len(ours_seen) == len(ref_seen) > 1
    for a, b in zip(ours_seen, ref_seen):
        np.testing.assert_array_equal(a, b)
    for e in (ours, ref):
        if sync:
            e.drain()
    _same_streams(params, cfg, ours, ref, 16)


# ----------------------------------------------------------- the launcher
LAUNCH = {
    "olmoe": ("olmoe-1b-7b", ()),
    "olmoe_legacy": ("olmoe-1b-7b", ("--legacy-loop",)),
    "olmoe_sync": ("olmoe-1b-7b", ("--sync-free",)),
    "olmoe_paged": ("olmoe-1b-7b", ("--paged", "--policy", "memory-aware")),
    "deepseek_paged_sync": ("deepseek-moe-16b", ("--paged", "--sync-free")),
}


@pytest.mark.parametrize("case", sorted(LAUNCH))
def test_launcher_lines_match_reference(case):
    """The launcher's summary, paged and latency lines for each MoE path;
    the reference's sync-free lines with its early consume off (R5)."""
    arch, flags = LAUNCH[case]
    ours = _launch("repro_torch.launch.serve", "--arch", arch, "--device", "cpu", *flags)
    launch_ref = _launch_late if "--sync-free" in flags else _launch
    theirs = launch_ref("repro.launch.serve", "--arch", arch, *flags)
    assert ours == theirs
    if case == "olmoe":
        assert ours[0] == ("policy=adaptive served=24 dropped=0 tail_backlog=5.6 mean_rate=2.67 "
                           "dispatches_per_slot=1.50 blocking_syncs_per_slot=1.50")


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_refuses_chunked_like_reference(arch):
    from repro_torch.launch import serve as launcher
    message = f"{arch}-smoke: chunked prefill needs a dense-attention stack and no sliding window"
    flags = ("--chunked", "--policy", "token-aware")
    with pytest.raises(ValueError) as exc:
        launcher.main(["--arch", arch, "--smoke", "--device", "cpu", "--horizon", "12", *flags])
    assert str(exc.value) == message
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "repro.launch.serve", "--arch", arch,
                          "--smoke", "--horizon", "12", *flags], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert out.stderr.strip().splitlines()[-1] == f"ValueError: {message}"
