"""The port's hybrid Griffin path (recurrentgemma-2b) against the
reference's: the plain RG-LRU scan (K7's plain version) against the
reference's ``associative_scan``, the RG-LRU block and the GeLU MLP with the
reference's weights carried across, the smoke model at 3 layers (one
``group`` segment) and 5 (two ``rec`` remainder segments beside it), its
local-attention ring wrapping, ``init_params``' RG-LRU leaves, the dense
engine's token streams on every loop it serves, at native precision and
with the ring quantized to int8 or fp8, sampled serves, and the launcher's
lines and refusals."""
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
from repro.models import layers as RL
from repro.models import model as RM
from repro.models import rglru as RR
from repro.runtime import AdaptiveScheduler as RefAdaptive
from repro.runtime import Engine as RefEngine
from repro.runtime import EngineConfig as RefEngineConfig
from repro.runtime import RequestSource as RefSource
from repro.runtime import serve as ref_serve
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.models import rglru as R
from repro_torch.models.convert import (kv_cache_from_numpy, params_from_numpy,
                                        rec_state_from_numpy)
from repro_torch.models.layers import mlp
from repro_torch.runtime import AdaptiveScheduler, Engine, EngineConfig, RequestSource, serve
from test_differential import make_workload
from test_torch_chunked import _launch_late, late_consume
from test_torch_engine import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    COLUMNS, MARGIN, SRC, _launch, one_torch_thread)
from test_torch_quant_dense import QuantMarginComparator
from test_torch_sampling import _match
from test_torch_ssm import PAD_ID, PaddedPromptComparator

ARCH = "recurrentgemma-2b"
# the scan against the reference's associative_scan, per unit of the
# largest |h| (tests/test_recurrent.py's 2e-5): the two sum the decays in
# other orders (a sequential product against a tree of exp-sums)
SCAN_RTOL = 2e-5
# the model tolerance of tests/test_torch_model.py and tests/test_torch_ssm.py
TOL = dict(atol=1e-4, rtol=1e-4)
# the reference's own block contracts (tests/test_recurrent.py), with the
# margin tests/test_torch_ssm.py keeps for two packages' summation orders
BLOCK_TOL = dict(atol=3e-5, rtol=3e-5)
_M = {}


def _scan_case(seed, B, S, R_, init):
    """Inputs as the RG-LRU block hands them to the scan: log_a in
    (-8 softplus(-2.2), 0), the gated input ~N(0, 0.5^2), numpy float32."""
    rng = np.random.default_rng(seed)
    sp = np.log1p(np.exp(-np.linspace(2.2, 6.9, R_)))
    log_a = (-8.0 * rng.uniform(0.0, 1.0, (B, S, R_)) * sp).astype(np.float32)
    gated = (0.5 * rng.standard_normal((B, S, R_))).astype(np.float32)
    h0 = rng.standard_normal((B, R_)).astype(np.float32) if init else None
    return log_a, gated, h0


def _reference_scan(log_a, gated, h0):
    """The reference's scan as ``rglru_forward_with_state`` calls it: h0
    folded into step 0, then ``associative_scan`` over (log a, b) pairs."""
    def combine(c1, c2):
        (la1, b1), (la2, b2) = c1, c2
        return la1 + la2, b1 * jnp.exp(la2) + b2

    la, g = jnp.asarray(log_a), jnp.asarray(gated)
    h0 = jnp.zeros(g[:, 0].shape, jnp.float32) if h0 is None else jnp.asarray(h0)
    g = g.at[:, 0].add(h0 * jnp.exp(la[:, 0]))
    return np.asarray(jax.lax.associative_scan(combine, (la, g), axis=1)[1])


@pytest.mark.parametrize("B,S,R_,init", [(2, 17, 128, False), (2, 17, 128, True),
                                         (3, 512, 64, False), (1, 1, 32, True),
                                         (2, 100, 96, True)])
def test_plain_rglru_scan_matches_associative_scan(B, S, R_, init):
    log_a, gated, h0 = _scan_case(S + R_, B, S, R_, init)
    got = ops.rglru_scan(torch.from_numpy(log_a), torch.from_numpy(gated),
                         None if h0 is None else torch.from_numpy(h0))
    want = _reference_scan(log_a, gated, h0)
    assert got.dtype == torch.float32 and got.shape == (B, S, R_)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=SCAN_RTOL * max(1.0, float(np.abs(want).max())))


def test_plain_rglru_scan_is_the_stepwise_recurrence():
    """The plain version equals the decode's one-step update applied S
    times, bit for bit (both round the product, then the sum)."""
    log_a, gated, h0 = (torch.from_numpy(a) for a in _scan_case(5, 2, 9, 16, True))
    hs = ref.rglru_scan_ref(log_a, gated, h0)
    h = h0
    for t in range(9):
        h = torch.exp(log_a[:, t]) * h + gated[:, t]
        assert torch.equal(hs[:, t], h)


# ------------------------------------------------------------- the block
def _block():
    """The reference's block parameters (``rglru_init``) and the port's
    RGLRU module holding the same values."""
    if "block" not in _M:
        cfg = ref_get_config(ARCH, smoke=True)
        p = RR.rglru_init(jax.random.PRNGKey(1), cfg)
        blk = R.RGLRU(get_config(ARCH, smoke=True), "cpu")
        with torch.no_grad():
            for name, t in blk.named_parameters():
                t.copy_(torch.from_numpy(np.array(p[name])))
        _M["block"] = (cfg, p, blk)
    return _M["block"]


def _hidden(seed, B, Sq, D):
    return (0.5 * np.random.default_rng(seed).standard_normal((B, Sq, D))).astype(np.float32)


def _check_rec(got: R.RecState, want, tol):
    np.testing.assert_allclose(got.conv.numpy(), np.asarray(want.conv), **tol)
    np.testing.assert_allclose(got.h.numpy(), np.asarray(want.h), **tol)


@pytest.mark.parametrize("S", [1, 2, 17, 40])
def test_rglru_block_forward_and_decode_match_reference(S):
    """From a zero state (S below and above the conv width), then from the
    carried state, then three decode steps written in place."""
    cfg, p, blk = _block()
    pcfg = get_config(ARCH, smoke=True)
    h = _hidden(S, 2, S, cfg.d_model)
    out, st = R.rglru_forward_with_state(blk, torch.from_numpy(h), pcfg)
    rout, rst = RR.rglru_forward_with_state(p, jnp.asarray(h), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), **BLOCK_TOL)
    _check_rec(st, rst, BLOCK_TOL)
    h2 = _hidden(S + 1, 2, 13, cfg.d_model)
    out, st = R.rglru_forward_with_state(blk, torch.from_numpy(h2), pcfg, init=st)
    rout, rst = RR.rglru_forward_with_state(p, jnp.asarray(h2), cfg, init=rst)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), **BLOCK_TOL)
    _check_rec(st, rst, BLOCK_TOL)
    st = R.RecState(st.conv.contiguous(), st.h.contiguous())
    for t in range(3):
        ht = _hidden(S + 2 + t, 2, 1, cfg.d_model)[:, 0]
        ptrs = (st.conv.data_ptr(), st.h.data_ptr())
        y = R.rglru_decode(blk, torch.from_numpy(ht), st, pcfg)
        ry, rst = RR.rglru_decode(p, jnp.asarray(ht), rst, cfg)
        assert (st.conv.data_ptr(), st.h.data_ptr()) == ptrs   # written in place
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), **BLOCK_TOL)
        _check_rec(st, rst, BLOCK_TOL)


def test_rglru_forward_matches_stepwise_decode():
    """The scanned forward equals the one-token recurrence step by step
    (tests/test_recurrent.py's contract, on the port)."""
    _, _, blk = _block()
    cfg = get_config(ARCH, smoke=True)
    h = torch.from_numpy(_hidden(4, 2, 17, cfg.d_model))
    y_fwd, final = R.rglru_forward_with_state(blk, h, cfg)
    st = R.rec_state_init(2, cfg, "cpu")
    ys = [R.rglru_decode(blk, h[:, t], st, cfg) for t in range(h.shape[1])]
    np.testing.assert_allclose(y_fwd.numpy(), torch.stack(ys, 1).numpy(), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(final.h.numpy(), st.h.numpy(), atol=2e-5, rtol=2e-5)
    np.testing.assert_array_equal(final.conv.numpy(), st.conv.numpy())


def test_rglru_gates_match_reference():
    """log a_t and the gated input: softplus(-lam) as jax defines it (no
    threshold), sqrt(max(1 - a^2, 1e-12)), decays inside (0, 1)."""
    cfg, p, blk = _block()
    x = (3.0 * np.random.default_rng(9).standard_normal((4, 8, cfg.lru_width_))).astype(np.float32)
    log_a, gated = R._gates(blk, torch.from_numpy(x))
    rla, rg = RR._gates(p, jnp.asarray(x))
    np.testing.assert_allclose(log_a.numpy(), np.asarray(rla), rtol=1e-6, atol=1e-7)
    # where a_t is within 1e-3 of 1, 1 - a_t^2 cancels: an ulp of exp's
    # result (6e-8 near 1, jax's and torch's exp may part by it) moves
    # sqrt(1 - a^2) by up to sqrt(6e-8) ~ 2.4e-4 of |i x| <= |x|
    ill = (1.0 - np.exp(2.0 * np.asarray(rla))) <= 1e-3
    tol = 1e-5 * np.abs(np.asarray(rg)) + 1e-6 + np.where(ill, 4e-4 * np.abs(x), 0.0)
    assert (np.abs(gated.numpy() - np.asarray(rg)) <= tol).all()
    assert ill.mean() < 0.25
    a = torch.exp(log_a)
    assert bool(((a > 0) & (a < 1)).all())


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_mlp_matches_reference(act):
    cfg = ref_get_config(ARCH, smoke=True)
    params = RL.mlp_init(jax.random.PRNGKey(3), cfg)
    x = _hidden(11, 2, 5, cfg.d_model)
    want = RL.mlp(params, jnp.asarray(x), act)
    w = [torch.from_numpy(np.array(params[n])) for n in ("w_gate", "w_up", "w_down")]
    got = mlp(*w, torch.from_numpy(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)


# ------------------------------------------------------------- the model
def _models(n_layers=3):
    """The reference's smoke model (3 layers: one group; 5: a group and two
    ``rec`` remainder segments) and the port holding its weights."""
    if n_layers not in _M:
        cfg = ref_get_config(ARCH, smoke=True).replace(n_layers=n_layers)
        params = ref_init_params(jax.random.PRNGKey(0), cfg)
        port = params_from_numpy(jax.tree.map(np.asarray, params),
                                 get_config(ARCH, smoke=True).replace(n_layers=n_layers),
                                 device="cpu")
        _M[n_layers] = (cfg, params, port)
    return _M[n_layers]


def _check_state(got, want):
    """Every cache leaf: a group's dict of RecStates and a KV ring, a
    remainder segment's RecState."""
    assert len(got.caches) == len(want.caches)
    for g, w in zip(got.caches, want.caches):
        if isinstance(w, dict):
            assert g.keys() == w.keys()
            pairs = [(g[k], w[k]) for k in w]
        else:
            pairs = [(g, w)]
        for gg, ww in pairs:
            if isinstance(ww, RR.RecState):
                _check_rec(gg, ww, TOL)
            else:
                np.testing.assert_allclose(gg.k.numpy(), np.asarray(ww.k), **TOL)
                np.testing.assert_allclose(gg.v.numpy(), np.asarray(ww.v), **TOL)
                np.testing.assert_array_equal(gg.slot_pos.numpy(), np.asarray(ww.slot_pos))
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
    np.testing.assert_array_equal(got.last_tok.numpy(), np.asarray(want.last_tok))


@pytest.mark.parametrize("n_layers", [3, 5])
@pytest.mark.parametrize("Sq,steps", [(20, 4), (40, 12)])
def test_hybrid_prefill_and_decode_match_reference(n_layers, Sq, steps):
    """Prompts of 20 tokens (inside the smoke window of 32) and of 40 (past
    it: the group's 32-slot ring wraps during the prefill, and 12 decode
    steps wrap it again), then greedy decode steps, logits and every state
    leaf against the reference's."""
    cfg, params, port = _models(n_layers)
    B, L = 3, 64
    toks = np.random.default_rng(Sq).integers(0, cfg.vocab_size, (B, Sq)).astype(np.int32)
    ref_logits, ref_state = RM.prefill(params, {"tokens": jnp.asarray(toks)}, cfg, L)
    logits, state = prefill(port, torch.from_numpy(toks), L)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    _check_state(state, ref_state)
    assert state.caches[0]["b2"].cache_len == min(L, cfg.local_window) == 32
    nxt = np.asarray(jnp.argmax(ref_logits, -1)).astype(np.int32)
    assert (logits.argmax(-1).numpy() == nxt).all()
    for _ in range(steps):
        ref_logits, ref_state = RM.decode_step(params, ref_state, jnp.asarray(nxt), cfg)
        logits, state = decode_step(port, state, torch.from_numpy(nxt))
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
        nxt = np.asarray(jnp.argmax(ref_logits, -1)).astype(np.int32)
        assert (logits.argmax(-1).numpy() == nxt).all()
    _check_state(state, ref_state)


def test_hybrid_decode_from_carried_reference_state():
    """A decode state carried over from the reference (the group's rec
    states and ring through ``rec_state_from_numpy`` and
    ``kv_cache_from_numpy``) decodes as the reference's does."""
    cfg, params, port = _models(5)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 37)).astype(np.int32)
    ref_logits, ref_state = RM.prefill(params, {"tokens": jnp.asarray(toks)}, cfg, 64)

    def carry(c):
        if isinstance(c, dict):
            return {k: carry(v) for k, v in c.items()}
        if isinstance(c, RR.RecState):
            return rec_state_from_numpy(np.asarray(c.conv), np.asarray(c.h), device="cpu")
        return kv_cache_from_numpy(np.asarray(c.k), np.asarray(c.v), np.asarray(c.slot_pos),
                                   device="cpu")
    from repro_torch.models.model import DecodeState
    state = DecodeState(caches=[carry(c) for c in ref_state.caches],
                        pos=torch.from_numpy(np.asarray(ref_state.pos)),
                        last_tok=torch.from_numpy(np.asarray(ref_state.last_tok)))
    nxt = np.asarray(jnp.argmax(ref_logits, -1)).astype(np.int32)
    for _ in range(3):
        ref_logits, ref_state = RM.decode_step(params, ref_state, jnp.asarray(nxt), cfg)
        logits, state = decode_step(port, state, torch.from_numpy(nxt))
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
        nxt = np.asarray(jnp.argmax(ref_logits, -1)).astype(np.int32)
    _check_state(state, ref_state)


@pytest.mark.parametrize("prec", ["int8", "fp8"])
def test_hybrid_quant_decode_from_carried_reference_state(prec):
    """The reference's prefill state with the group's ring quantized (codes,
    scales and staging buffers carried across with ``kv_cache_from_numpy``,
    fp8 through its bytes): the port's decode steps read the same codes,
    so the logits agree within the native tolerance, and every written
    ring row agrees up to one code rounding the other way."""
    cfg, params, port = _models()
    qcfg = cfg.replace(kv_precision=prec)
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 37)).astype(np.int32)
    ref_logits, ref_state = RM.prefill(params, {"tokens": jnp.asarray(toks)}, qcfg, 64)

    def carry(c):
        if isinstance(c, dict):
            return {k: carry(v) for k, v in c.items()}
        if isinstance(c, RR.RecState):
            return rec_state_from_numpy(np.asarray(c.conv), np.asarray(c.h), device="cpu")
        return kv_cache_from_numpy(**{n: None if a is None else np.asarray(a)
                                      for n, a in c._asdict().items()}, device="cpu")
    from repro_torch.models.model import DecodeState
    state = DecodeState(caches=[carry(c) for c in ref_state.caches],
                        pos=torch.from_numpy(np.asarray(ref_state.pos)),
                        last_tok=torch.from_numpy(np.asarray(ref_state.last_tok)))
    ring = state.caches[0]["b2"]
    assert ring.k.dtype == (torch.int8 if prec == "int8" else torch.float8_e4m3fn)
    nxt = np.asarray(jnp.argmax(ref_logits, -1)).astype(np.int32)
    for _ in range(3):   # the port's decode follows the ring's own leaves
        ref_logits, ref_state = RM.decode_step(params, ref_state, jnp.asarray(nxt), qcfg)
        logits, state = decode_step(port, state, torch.from_numpy(nxt))
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
        nxt = np.asarray(jnp.argmax(ref_logits, -1)).astype(np.int32)
    got, want = state.caches[0]["b2"], ref_state.caches[0]["b2"]
    np.testing.assert_array_equal(got.slot_pos.numpy(), np.asarray(want.slot_pos))
    flips = (got.k.view(torch.uint8).numpy() != np.asarray(want.k).view(np.uint8)).any(-1)
    assert flips.sum() <= 2
    np.testing.assert_allclose(got.k_scale.numpy(), np.asarray(want.k_scale), rtol=1e-5, atol=0)


def test_hybrid_refuses_ragged_prefill_like_reference():
    _, _, port = _models()
    with pytest.raises(ValueError, match="ragged prefill is not supported for 'group' blocks"):
        prefill(port, torch.zeros((2, 16), dtype=torch.int32), 64,
                prompt_lens=torch.tensor([16, 5], dtype=torch.int32))


def test_init_params_draws_the_rglru_leaves_at_the_reference_scales():
    cfg = ref_get_config(ARCH, smoke=True).replace(n_layers=5)
    want = RR.rglru_init(jax.random.PRNGKey(0), cfg)
    model = init_params(get_config(ARCH, smoke=True).replace(n_layers=5), seed=0, device="cpu")
    recs = [m for m in model.modules() if isinstance(m, R.RGLRU)]
    assert len(recs) == 4   # the group's two and the two remainder layers
    bs = cfg.lru_width_ // cfg.lru_heads
    for p in recs:
        for name in ("conv_b", "b_a", "b_x"):
            assert not p.get_parameter(name).any(), name
        np.testing.assert_allclose(p.lam.numpy(), np.asarray(want["lam"]), rtol=1e-6, atol=0)
        assert abs(p.conv_w.std().item() - 0.1) < 0.02
        for name in ("w_a", "w_x"):
            assert abs(p.get_parameter(name).std().item() - bs ** -0.5) < 0.1 * bs ** -0.5
        assert abs(p.in_x.std().item() - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    assert model.stack[0][0].b2_attn.w_gate.dtype == torch.float32


# ------------------------------------------------------------ the engine
class PaddedQuantComparator(QuantMarginComparator):
    """The margin comparator over a quantized ring for a stack the engine
    prefills over the full padded bucket (ROADMAP R7): the reference's
    top-2 gap after the padded prompt's prefill into its quantized ring and
    the decode steps up to the parting token."""

    def __init__(self, params, cfg, cache_len, margin, prec, prompt_len):
        super().__init__(params, cfg, cache_len, margin, prec)
        self.prompt_len = prompt_len

    def _ref_gap(self, prompt, generated):
        toks = np.asarray(prompt[:self.prompt_len], np.int32)
        padded = np.concatenate([toks, np.full(self.prompt_len - len(toks), PAD_ID, np.int32)])
        return super()._ref_gap(padded, generated)


def _engine_case(mode, prec=""):
    """Prompts of 5-40 tokens in a bucket of 40, right-padded (the bucket
    passes the window of 32: the ring wraps at admission), on the dense
    engine at ``prec``: the serve trace, the counters and the greedy
    streams equal the reference's."""
    cfg, params, port = _models()
    kw = dict(batch_slots=4, prompt_len=40, cache_len=64, kv_precision=prec)
    src_kw = dict(vocab_size=cfg.vocab_size, prompt_len=40, raw_rate=5, max_new_tokens=4,
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
    reqs = ours.finished + [r for r in ours.active if r is not None and r.generated]
    got = {r.rid: list(r.generated) for r in reqs}
    want = {r.rid: list(r.generated) for r in ref.finished + [r for r in ref.active
                                                             if r is not None and r.generated]}
    assert sum(map(len, got.values())) > 0
    if prec:
        PaddedQuantComparator(params, cfg, 64, MARGIN, prec, 40).check(
            got, want, {r.rid: r.tokens for r in reqs})
    else:
        PaddedPromptComparator(params, cfg, 64, MARGIN, 40).check(
            got, want, {r.rid: r.tokens for r in reqs})
    return ours


@pytest.mark.parametrize("mode", ["fused", "legacy", "sync"])
def test_engine_trace_and_streams_match_reference(mode):
    """``_engine_case`` at native precision on each loop."""
    _engine_case(mode)


@pytest.mark.parametrize("prec", ["int8", "fp8"])
@pytest.mark.parametrize("mode", ["fused", "legacy", "sync"])
def test_quant_engine_trace_and_streams_match_reference(mode, prec):
    """``_engine_case`` with the group's local-attention ring quantized
    (codes with per-token-per-head scales, read through K2q's plain
    version at the smoke head dim); the gap of the margin comparator is
    the reference's own on its quantized ring."""
    ours = _engine_case(mode, prec)
    ring = ours.state.caches[0]["b2"]
    assert ring.k.dtype == (torch.int8 if prec == "int8" else torch.float8_e4m3fn)
    assert ring.k_scale is not None and ring.stage_k is not None


def test_engine_splices_nested_group_state_rows():
    """A batch-1 admission spliced into row 2 leaves the other rows' group
    states (two RecStates and the ring) as they were and gives row 2 the
    batch-1 prefill's, leaf by leaf; the state tensors keep their identity."""
    from repro_torch.runtime.engine import PAD_ID, _leaves
    _, _, port = _models(5)
    eng = Engine(port, EngineConfig(batch_slots=4, prompt_len=40, cache_len=64))
    leaves = _leaves(eng.state.caches)
    assert len(leaves) == 2 * 2 + 3 + 2 * 2   # b0, b1 (conv, h), b2 (k, v, slot_pos), 2 rec
    before = [t.clone() for t in leaves]
    src = RequestSource(vocab_size=port.cfg.vocab_size, prompt_len=40, raw_rate=1, seed=3)
    req = src.poll(0, 1.0)[0]
    eng._admit_one(req, 2, 0)
    toks = np.asarray(req.tokens[:40], np.int32)
    toks = np.concatenate([toks, np.full(40 - len(toks), PAD_ID, np.int32)])
    _, one = prefill(port, torch.from_numpy(toks[None]), 64)
    after = _leaves(eng.state.caches)
    assert [t.data_ptr() for t in after] == [t.data_ptr() for t in leaves]
    for a, b, o in zip(after, before, _leaves(one.caches)):
        for r in (0, 1, 3):
            assert torch.equal(a[:, r], b[:, r])
        assert torch.equal(a[:, 2], o[:, 0])
    assert int(eng.state.pos[2]) == 40


def test_sampled_fused_serve_matches_reference():
    """Sampled and greedy requests (the SAMPLING_PRESETS cycle) on the
    fused loop; prompts fill the bucket (a recurrent stack integrates pads,
    R7)."""
    cfg, params, port = _models()
    reqs, schedule = make_workload(seed=47, n_reqs=8, min_prompt=16, sampling=True)
    _match(RefEngine(cfg, params, RefEngineConfig(batch_slots=4, prompt_len=16, cache_len=64)),
           Engine(port, EngineConfig(batch_slots=4, prompt_len=16, cache_len=64)), "fused",
           reqs, schedule, params, cfg)


def test_sampled_quant_fused_serve_matches_reference():
    """The sampled fused serve over an int8 ring."""
    cfg, params, port = _models()
    reqs, schedule = make_workload(seed=47, n_reqs=8, min_prompt=16, sampling=True)
    kw = dict(batch_slots=4, prompt_len=16, cache_len=64, kv_precision="int8")
    _match(RefEngine(cfg, params, RefEngineConfig(**kw)), Engine(port, EngineConfig(**kw)),
           "fused", reqs, schedule, params, cfg.replace(kv_precision="int8"))


# ----------------------------------------------------------- the launcher
@pytest.mark.parametrize("flags", [(), ("--legacy-loop",), ("--sync-free",),
                                   ("--kv-precision", "int8")])
def test_launcher_lines_match_reference(flags):
    """The summary and latency lines of ``--arch recurrentgemma-2b``; the
    reference's sync-free line with its early consume off (ROADMAP R5)."""
    ours = _launch("repro_torch.launch.serve", "--arch", ARCH, "--device", "cpu", *flags)
    launch_ref = _launch_late if "--sync-free" in flags else _launch
    theirs = launch_ref("repro.launch.serve", "--arch", ARCH, *flags)
    assert ours[:2] == theirs[:2]
    assert ours[0].startswith("policy=adaptive served=")


@pytest.mark.parametrize("flags,message", [
    (("--chunked", "--policy", "token-aware"),
     "recurrentgemma-2b-smoke: chunked prefill needs a dense-attention stack and no sliding "
     "window"),
    (("--paged", "--policy", "memory-aware"),
     "recurrentgemma-2b-smoke: paged decode needs an all-attention stack"),
])
def test_launcher_refuses_chunked_and_paged_like_reference(flags, message):
    from repro_torch.launch import serve as launcher
    with pytest.raises(ValueError) as exc:
        launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--horizon", "12", *flags])
    assert str(exc.value) == message
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "repro.launch.serve", "--arch", ARCH,
                          "--smoke", "--horizon", "12", *flags], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert out.stderr.strip().splitlines()[-1] == f"ValueError: {message}"
