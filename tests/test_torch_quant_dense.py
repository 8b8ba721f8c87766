"""The port's dense quantized ring cache (int8 and fp8 codes with
per-token-per-head scales) against the reference's: the plain quantized
prefill attention (K1q/K1rq's plain version) against the reference's
``flash_attention(k_scale=)`` in its XLA and Pallas-interpret forms, the
plain quantized ring decode (K2q's plain version) against the reference's
dequantize-then-decode, the quantized prefill writes, the prefill caches
and decode steps with the reference's weights carried across, the chunked
staging regression, the dense engine on the fused, legacy, sync-free and
chunked loops, and the launcher's lines."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache.precision import parse_kv_precision as ref_parse
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro.kernels.quant import dequantize_kv as ref_dequantize
from repro.kernels.quant import quantize_kv as ref_quantize
from repro.models import attention as RA
from repro.models import model as RM
from repro.runtime import AdaptiveScheduler as RefAdaptive
from repro.runtime import Engine as RefEngine
from repro.runtime import EngineConfig as RefEngineConfig
from repro.runtime import RequestSource as RefSource
from repro.runtime import serve as ref_serve
from repro_torch.cache import parse_kv_precision
from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention as k_decode
from repro_torch.kernels import flash_attention as k_flash
from repro_torch.kernels import ops
from repro_torch.kernels.quant import quantize_kv
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models.convert import _torch as _t
from repro_torch.models.convert import kv_cache_from_numpy
from repro_torch.runtime import (AdaptiveScheduler, Engine, EngineConfig, Request,
                                 RequestSource, serve)
from test_differential import drive, make_workload
from test_torch_chunked import _launch_late, late_consume
from test_torch_engine import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    COLUMNS, MARGIN, MarginComparator, _launch, _streams, _weights, one_torch_thread)
from test_torch_kernels_gpu import _ring
from test_torch_paged import TOL
from test_torch_quant import _codes

PRECS = ("int8", "fp8")
# per unit of max(1, max |out|), float32 on both sides over the same
# dequantized values: the softmaxes differ only in summation order. Measured
# here: <= 2.8e-7 against the reference's XLA form, and against its Pallas
# kernel in interpret mode <= 2.7e-7, or 1.4e-5 under the extreme spread
# (where that kernel also misses its own oracle by more, ROADMAP R3)
ATOL = 2e-5


def _quant_kv(rng, shape, prec, extreme):
    """Seeded K and V quantized by the reference; ``extreme`` spreads the KV
    heads over scales 1e-2..1e2 (tests/test_quant.py's sweep)."""
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    if extreme:
        spread = np.logspace(-2, 2, shape[2]).astype(np.float32)[None, None, :, None]
        k, v = k * spread, v * spread
    qk, ks = ref_quantize(jnp.asarray(k), ref_parse(prec))
    qv, vs = ref_quantize(jnp.asarray(v), ref_parse(prec))
    return qk, qv, ks, vs


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=rtol * max(1.0, float(np.abs(want).max())),
                               rtol=0)


# ---------------------------------------------------------------- K1q plain
@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("B,S,H,KVH,hd,blk", [(2, 64, 4, 2, 32, 32), (1, 128, 4, 1, 64, 64)])
def test_flash_attention_quant_matches_reference(B, S, H, KVH, hd, blk, extreme, prec):
    """``ops.flash_attention(k_scale=, v_scale=)`` on the CPU against the
    reference's entry in its XLA form and through its Pallas kernel in
    interpret mode, dense and ragged, with and without the extreme scale
    spread; ragged pad rows are zeros."""
    rng = np.random.default_rng(S + hd)
    qk, qv, ks, vs = _quant_kv(rng, (B, S, KVH, hd), prec, extreme)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    lens = np.asarray([S, S // 2][:B], np.int32)
    for seq_lens in (None, lens):
        got = ops.flash_attention(_t(q), _t(qk), _t(qv),
                                  None if seq_lens is None else torch.from_numpy(seq_lens),
                                  k_scale=_t(ks), v_scale=_t(vs)).numpy()
        sl = None if seq_lens is None else jnp.asarray(seq_lens)
        xla = ref_ops.flash_attention(q, qk, qv, sl, k_scale=ks, v_scale=vs, impl="xla")
        itp = ref_ops.flash_attention(q, qk, qv, sl, k_scale=ks, v_scale=vs,
                                      impl="interpret", block_q=blk, block_k=blk)
        _close(got, xla, ATOL)
        _close(got, itp, ATOL)
        if seq_lens is not None:
            for b, n in enumerate(seq_lens):
                assert not got[b, n:].any()


@pytest.mark.parametrize("prec", PRECS)
def test_flash_attention_quant_window_matches_reference(prec):
    """A sliding window of 9 over int8/fp8 codes, ragged, against the
    reference's XLA form and its Pallas kernel in interpret mode."""
    rng = np.random.default_rng(5)
    B, S, H, KVH, hd = 2, 64, 4, 2, 32
    qk, qv, ks, vs = _quant_kv(rng, (B, S, KVH, hd), prec, False)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    lens = np.asarray([S, 37], np.int32)
    got = ops.flash_attention(_t(q), _t(qk), _t(qv), torch.from_numpy(lens), k_scale=_t(ks),
                              v_scale=_t(vs), window=9).numpy()
    for impl in ("xla", "interpret"):
        want = ref_ops.flash_attention(q, qk, qv, jnp.asarray(lens), k_scale=ks, v_scale=vs,
                                       window=9, impl=impl, block_q=32, block_k=32)
        _close(got, want, ATOL)


# ---------------------------------------------------------------- K2q plain
@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("window", [None, 11])
def test_decode_attention_quant_matches_reference(prec, window):
    """``ops.decode_attention(k_scale=, v_scale=)`` on the CPU (K2q's plain
    version) against the reference's quantized ``attn_decode`` read:
    ``dequantize_kv`` of the whole ring, then ``decode_attention_ref``; a
    ring with empty slots, rows before and after the wrap, and a window."""
    rng = np.random.default_rng(17)
    B, L, H, KVH, hd = 3, 32, 8, 2, 32
    qk, qv, ks, vs = _quant_kv(rng, (B, L, KVH, hd), prec, False)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    pos = np.asarray([12, 40, 75], np.int32)
    sp = _ring(B, L, pos)
    got = ops.decode_attention(_t(q), _t(qk), _t(qv), torch.from_numpy(sp),
                               torch.from_numpy(pos), k_scale=_t(ks), v_scale=_t(vs),
                               window=window).numpy()
    want = ref_oracles.decode_attention_ref(
        q, ref_dequantize(qk, ks, jnp.float32), ref_dequantize(qv, vs, jnp.float32),
        jnp.asarray(sp), jnp.asarray(pos), window=window)
    _close(got, want, ATOL)


def test_quant_kernel_wrappers_refuse_cpu_tensors():
    """K1q's and K2q's wrappers take CUDA tensors only: on the CPU the
    entry points in ``ops`` go to the plain versions instead."""
    rng = np.random.default_rng(0)
    qk, qv, ks, vs = (_t(a) for a in _quant_kv(rng, (1, 16, 2, 32), "int8", False))
    with pytest.raises(ValueError, match="CUDA"):
        k_flash.flash_attention_quant(torch.zeros(1, 16, 4, 32), qk, qv, ks, vs)
    sp = torch.arange(16, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="CUDA"):
        k_decode.decode_attention_quant(torch.zeros(1, 4, 32), qk, qv, ks, vs, sp,
                                        torch.tensor([15], dtype=torch.int32))


# ------------------------------------------------------- the prefill writes
def _port_cfg(prec):
    return get_config("granite-3-2b", smoke=True).replace(kv_precision=prec)


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("S,L", [(16, 32), (16, 8)])
def test_attn_prefill_quant_writes_match_reference(monkeypatch, prec, S, L):
    """The quantized prefill write, bit for bit: codes, scales, slot_pos and
    staging of the reference's ``attn_prefill`` on the same K/V, a ragged
    batch into a ring longer than the prompt and into one it wraps. To give
    both sides the same K/V exactly the input rows are one-hot (each
    projection then selects a weight row, exactly in any summation order)
    and RoPE is the identity in both; the model-level test below holds the
    real path to the reference within the frameworks' matmul noise."""
    monkeypatch.setattr(RA, "apply_rope", lambda x, positions, theta: x)
    monkeypatch.setattr(A, "apply_rope", lambda x, positions, theta: x)
    w = _weights()
    B, D = 3, w["cfg"].d_model
    rng = np.random.default_rng(S + L)
    x = np.zeros((B, S, D), np.float32)
    np.put_along_axis(x, rng.integers(0, D, (B, S, 1)), 1.0, axis=2)
    lens = np.asarray([S, 5, 9], np.int32)
    p_ref = jax.tree.map(lambda a: a[0], w["params"]["stack"][0]["attn"])
    _, rc = RA.attn_prefill(p_ref, jnp.asarray(x), w["cfg"].replace(kv_precision=prec), L,
                            seq_lens=jnp.asarray(lens))
    cfg = _port_cfg(prec)
    cache = A.kv_cache_init(B, L, cfg, "cpu")
    A.attn_prefill(w["port"].stack[0][0].attn, torch.from_numpy(x), cfg, cache,
                   seq_lens=torch.from_numpy(lens))
    np.testing.assert_array_equal(_codes(cache.k), _codes(rc.k))
    np.testing.assert_array_equal(_codes(cache.v), _codes(rc.v))
    np.testing.assert_array_equal(cache.k_scale.numpy(), np.asarray(rc.k_scale))
    np.testing.assert_array_equal(cache.v_scale.numpy(), np.asarray(rc.v_scale))
    np.testing.assert_array_equal(cache.slot_pos.numpy(), np.asarray(rc.slot_pos))
    np.testing.assert_array_equal(cache.stage_k.numpy(), np.asarray(rc.stage_k))
    np.testing.assert_array_equal(cache.stage_v.numpy(), np.asarray(rc.stage_v))
    pad = cache.slot_pos < 0     # pad rows and empty slots: zero codes and scales
    assert pad.any() and not _codes(cache.k)[pad.numpy()].any()
    assert not cache.k_scale[pad].any() and not cache.stage_k[pad].any()


# --------------------------------------------------------- model prefill/decode
def _prompts(seed, B=3, S=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    return toks, np.asarray([S, 5, 9][:B], np.int32)


@pytest.mark.parametrize("prec", PRECS)
def test_prefill_quant_cache_matches_reference(prec):
    """With the reference's weights carried across, ``prefill`` into a
    quantized ring: slot_pos equal, the staging buffers within the native
    model tolerance (TOL), and codes and scales as close as K/V rows that
    differ by ~1e-6 allow: at most one code per leaf rounds the other way,
    and scales agree to 1e-5. Inside the port the ring is exactly the
    quantization of the native prefill's K/V and staging exactly that K/V."""
    w = _weights()
    toks, lens = _prompts(0)
    _, rs = RM.prefill(w["params"], {"tokens": jnp.asarray(toks)},
                       w["cfg"].replace(kv_precision=prec), 32, prompt_lens=jnp.asarray(lens))
    _, qs = M.prefill(w["port"], torch.from_numpy(toks), 32, prompt_lens=torch.from_numpy(lens),
                      kv_precision=prec)
    _, ns = M.prefill(w["port"], torch.from_numpy(toks), 32, prompt_lens=torch.from_numpy(lens))
    rc, qc, nc = rs.caches[0], qs.caches[0], ns.caches[0]
    np.testing.assert_array_equal(qc.slot_pos.numpy(), np.asarray(rc.slot_pos))
    np.testing.assert_allclose(qc.stage_k.numpy(), np.asarray(rc.stage_k), **TOL)
    np.testing.assert_allclose(qc.stage_v.numpy(), np.asarray(rc.stage_v), **TOL)
    for name in ("k", "v"):
        assert (_codes(getattr(qc, name)) != _codes(getattr(rc, name))).sum() <= 1
        np.testing.assert_allclose(getattr(qc, f"{name}_scale").numpy(),
                                   np.asarray(getattr(rc, f"{name}_scale")), rtol=1e-5, atol=0)
        native = getattr(nc, name)
        assert torch.equal(getattr(qc, f"stage_{name}"), native)
        codes, scale = quantize_kv(native, parse_kv_precision(prec))
        live = (nc.slot_pos >= 0)[..., None]
        assert np.array_equal(_codes(getattr(qc, name)), _codes(codes) * live[..., None].numpy())
        assert torch.equal(getattr(qc, f"{name}_scale"), torch.where(live, scale, 0.0))


def _clone_state(state: M.DecodeState) -> M.DecodeState:
    caches = [type(c)(*(None if t is None else t.clone() for t in c)) for c in state.caches]
    return M.DecodeState(caches, state.pos.clone(), state.last_tok.clone())


def _one_flip_logit_change(port, state, nxt) -> float:
    """What one code that rounds the other way does to a decode step's
    logits: the live K code of largest scale moved by one step."""
    base = M.decode_step(port, _clone_state(state), nxt)[0]
    flipped = _clone_state(state)
    c = flipped.caches[0]
    live = (c.slot_pos >= 0)[..., None].expand_as(c.k_scale)
    i = torch.where(live, c.k_scale, -1.0).flatten().argmax()
    idx = np.unravel_index(int(i), c.k_scale.shape)
    raw = c.k.view(torch.uint8)[idx]
    if c.k.dtype == torch.int8:
        code = c.k[idx]
        code[0] = code[0] + (1 if code[0] < 127 else -1)
    else:    # fp8: the neighbouring code
        raw[0] = raw[0] ^ 1
    return float((M.decode_step(port, flipped, nxt)[0] - base).abs().max())


@pytest.mark.parametrize("prec", PRECS)
def test_decode_step_quant_matches_reference(prec):
    """Both packages start from one quantized ring (the reference's prefill
    carried across with ``kv_cache_from_numpy``) and take four decode steps
    on the reference's tokens, one row wrapping the ring: the logits agree
    within the native model tolerance plus what one code rounding the other
    way moves them, the written codes differ in at most one, and the scales
    agree to 1e-5."""
    w = _weights()
    qcfg = w["cfg"].replace(kv_precision=prec)
    toks, lens = _prompts(1)
    L = 16   # row 0 fills the ring at prefill, so its decode writes wrap
    logits, rs = RM.prefill(w["params"], {"tokens": jnp.asarray(toks)}, qcfg, L,
                            prompt_lens=jnp.asarray(lens))
    leaves = {n: (None if a is None else np.asarray(a)) for n, a in rs.caches[0]._asdict().items()}
    state = M.DecodeState([kv_cache_from_numpy(**leaves, device="cpu")],
                          torch.from_numpy(np.array(rs.pos)),
                          torch.from_numpy(np.array(rs.last_tok)))
    nxt = torch.from_numpy(np.asarray(jnp.argmax(logits, -1)).astype(np.int32))
    tol = TOL["atol"] + _one_flip_logit_change(w["port"], state, nxt)
    for _ in range(4):
        ref_logits, rs = RM.decode_step(w["params"], rs, jnp.asarray(nxt), qcfg)
        got, state = M.decode_step(w["port"], state, nxt)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref_logits), atol=tol, rtol=0)
        nxt = torch.from_numpy(np.asarray(jnp.argmax(ref_logits, -1)).astype(np.int32))
    c, rc = state.caches[0], rs.caches[0]
    np.testing.assert_array_equal(c.slot_pos.numpy(), np.asarray(rc.slot_pos))
    for name in ("k", "v"):
        assert (_codes(getattr(c, name)) != _codes(getattr(rc, name))).sum() <= 1
        np.testing.assert_allclose(getattr(c, f"{name}_scale").numpy(),
                                   np.asarray(getattr(rc, f"{name}_scale")), rtol=1e-5, atol=0)


@pytest.mark.parametrize("prec", PRECS)
def test_native_staging_regression(prec):
    """tests/test_quant.py's staging check on the port: a quantized chunked
    engine's staging buffers hold bit for bit the K/V a native engine
    writes for the same prompt (chunk N re-reads chunk N-1 through staging,
    never through the rounded ring), so the first generated token is the
    native one."""
    port = _weights()["port"]
    prompt = np.random.default_rng(9).integers(0, 256, 13, dtype=np.int32)

    def run(kv_precision):
        eng = Engine(port, EngineConfig(batch_slots=2, prompt_len=16, cache_len=64,
                                        chunk_size=4, kv_precision=kv_precision))
        eng.submit([Request(rid=0, arrival_slot=0, tokens=prompt.copy(), max_new_tokens=4)])
        t = 0
        while len(eng.finished) < 1 and t < 40:
            eng.step_slot_chunked(t, n_steps=2)
            t += 1
        eng.drain()
        assert len(eng.finished) == 1
        return eng

    nat, qnt = run(""), run(prec)
    n = len(prompt)
    cn, cq = nat.state.caches[0], qnt.state.caches[0]
    assert cn.stage_k is None and cq.stage_k is not None
    assert torch.equal(cq.stage_k[:, 0, :n], cn.k[:, 0, :n])
    assert torch.equal(cq.stage_v[:, 0, :n], cn.v[:, 0, :n])
    assert cq.k.dtype == (torch.int8 if prec == "int8" else torch.float8_e4m3fn)
    assert nat.finished[0].generated[0] == qnt.finished[0].generated[0]


# ------------------------------------------------------------------ engines
class QuantMarginComparator(MarginComparator):
    """``MarginComparator`` whose gap is the reference's own on its
    quantized ring: the prompt prefilled into it, then decoded on the
    reference's stream up to the token where the streams part."""

    def __init__(self, params, cfg, cache_len, margin, prec):
        super().__init__(params, cfg.replace(kv_precision=prec), cache_len, margin)

    def _ref_gap(self, prompt, generated):
        logits, st = RM.prefill(self.params, {"tokens": jnp.asarray(prompt)[None]}, self.cfg,
                                self.cache_len)
        for tok in generated:
            logits, st = RM.decode_step(self.params, st, jnp.asarray([tok], jnp.int32),
                                        self.cfg)
        top = np.sort(np.asarray(logits[0]))[-2:]
        return float(top[1] - top[0])


@pytest.mark.parametrize("fused,prec", [(True, "int8"), (False, "int8"), (True, "fp8")])
def test_dense_quant_serve_matches_reference(fused, prec):
    """The fused and legacy loops over a quantized ring against the
    reference's dense engine with the same ``kv_precision``: the trace
    columns, the counters, and the greedy streams (margin-aware)."""
    w = _weights()
    kw = dict(batch_slots=4, prompt_len=16, cache_len=64, kv_precision=prec)
    src_kw = dict(prompt_len=16, raw_rate=5, max_new_tokens=4, min_prompt_len=5)
    rates = tuple(float(f) for f in range(1, 6))
    ref_engine = RefEngine(w["cfg"], w["params"], RefEngineConfig(**kw))
    ref_tr = ref_serve(ref_engine, RefAdaptive(rates=rates, V=20.0, capacity=32),
                       RefSource(vocab_size=w["cfg"].vocab_size, **src_kw),
                       horizon=12, steps_per_slot=2, fused=fused)
    engine = Engine(w["port"], EngineConfig(**kw))
    tr = serve(engine, AdaptiveScheduler(rates=rates, V=20.0, capacity=32),
               RequestSource(vocab_size=w["cfg"].vocab_size, **src_kw),
               horizon=12, steps_per_slot=2, fused=fused)
    for col in COLUMNS:
        np.testing.assert_array_equal(tr[col], ref_tr[col], err_msg=col)
    assert engine.counters() == ref_engine.counters()
    got, prompts = _streams(engine)
    want, _ = _streams(ref_engine)
    assert sum(map(len, got.values())) > 0
    QuantMarginComparator(w["params"], w["cfg"], 64, MARGIN, prec).check(got, want, prompts)


@pytest.mark.parametrize("mode,prec", [("sync", "int8"), ("chunked", "int8"), ("chunked", "fp8")])
def test_dense_quant_engine_matches_reference(mode, prec):
    """The sync-free and chunked loops over a quantized ring on the seeded
    bursty workload of tests/test_differential.py, against the reference's
    (its early consume off, ROADMAP R5): streams (margin-aware), retirement,
    per-slot served counts, dispatches, and no blocking sync."""
    w = _weights()
    reqs, schedule = make_workload(seed=0)
    ecfg = dict(batch_slots=4, prompt_len=16, cache_len=64, kv_precision=prec,
                chunk_size=4 if mode == "chunked" else 0)
    ours = Engine(w["port"], EngineConfig(**ecfg))
    ref = late_consume(RefEngine(w["cfg"], w["params"], RefEngineConfig(**ecfg)))
    streams, retired, (served, finished) = drive(ours, mode, copy.deepcopy(reqs), schedule)
    want = drive(ref, mode, copy.deepcopy(reqs), schedule)
    assert served == finished == len(reqs)
    assert retired == want[1]
    assert ours.served_history == ref.served_history
    assert ours.decode_dispatches == ref.decode_dispatches
    assert ours.prefill_dispatches == ref.prefill_dispatches
    assert ours.blocking_syncs == 0
    QuantMarginComparator(w["params"], w["cfg"], 64, MARGIN, prec).check(
        {k: list(v) for k, v in streams.items()}, {k: list(v) for k, v in want[0].items()},
        {r.rid: r.tokens for r in reqs})


# ------------------------------------------------------------------ launcher
@pytest.mark.parametrize("extra", [
    ("--kv-precision", "int8"),
    ("--kv-precision", "fp8"),
    ("--kv-precision", "int8", "--sync-free"),
    ("--kv-precision", "int8", "--legacy-loop"),
    ("--kv-precision", "int8", "--chunked", "--policy", "token-aware"),
    ("--kv-precision", "int8", "--arch", "mamba2-130m"),
])
def test_launcher_dense_quant_lines_match_reference(extra):
    """``--kv-precision`` without ``--paged`` on every dense loop, and on a
    Mamba-2 stack (no KV cache to quantize): the summary and latency lines
    of ``python -m repro.launch.serve`` with the same flags (its early
    consume off, R5), and no ``quant:`` line, as the reference prints none
    without ``--paged``."""
    ours = _launch("repro_torch.launch.serve", *extra, "--device", "cpu")
    ref = _launch_late("repro.launch.serve", *extra)
    assert ours == ref
    assert len(ours) == 2 and ours[0].startswith("policy=")
