"""The port's Mamba-2 (mamba2-130m) path against the reference's: the plain
SSD scan (K6's plain version) and its sequential oracle against the
reference's functions and its Pallas kernel in interpret mode, the SSM
block and the smoke model with the reference's weights carried across,
``init_params``' constant leaves, the dense engine's token streams and the
launcher's summary lines."""
import copy
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro.models import init_params as ref_init_params
from repro.models import model as RM
from repro.models import ssm as RS
from repro.runtime import AdaptiveScheduler as RefAdaptive
from repro.runtime import Engine as RefEngine
from repro.runtime import EngineConfig as RefEngineConfig
from repro.runtime import RequestSource as RefSource
from repro.runtime import serve as ref_serve
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.models import ssm as S
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime import AdaptiveScheduler, Engine, EngineConfig, RequestSource, serve
from repro_torch.runtime.engine import PAD_ID
from test_torch_chunked import _launch_late, late_consume
from test_torch_engine import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    COLUMNS, MARGIN, SRC, MarginComparator, _launch, one_torch_thread)

ARCH = "mamba2-130m"
# float32 on both sides. The scans differ in summation order (einsum
# contractions, the cumulative sum of dt*A), which leaves up to ~2e-6 of the
# output's scale (measured 1.6e-6 at S 256, P 64, N 128); 2e-5 of the scale
# keeps a margin and stays far below any real fault.
SCAN_RTOL = 2e-5
# the model tolerance of tests/test_torch_model.py: after two layers the
# logits and states differ by ~1e-6 (measured 6e-7 and 2e-6 here)
TOL = dict(atol=1e-4, rtol=1e-4)
# the reference's own block contracts (tests/test_recurrent.py)
BLOCK_TOL = dict(atol=3e-5, rtol=3e-5)
_M = {}


def _scan_case(seed, B, S, H, P, N, init=False):
    """Inputs as the model hands them to the scan: dt post-softplus, A
    negative, numpy float32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(np.linspace(0.0, 1.0, H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    st = (0.5 * rng.standard_normal((B, H, P, N))).astype(np.float32) if init else None
    return x, dt, A, Bm, Cm, st


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=SCAN_RTOL * max(1.0, float(np.abs(want).max())))


SCANS = [  # (B, S, H, P, N, chunk, init): tests/test_kernels.py's shapes, tails
    (2, 128, 2, 32, 32, 32, False),
    (1, 256, 3, 64, 128, 64, False),
    (2, 19, 2, 32, 32, 16, False),
    (2, 40, 2, 32, 32, 16, False),
    (2, 40, 2, 32, 32, 16, True),
    (1, 256, 3, 64, 128, 64, True),
]


@pytest.mark.parametrize("B,S,H,P,N,chunk,init", SCANS)
def test_plain_ssd_chunked_matches_reference(B, S, H, P, N, chunk, init):
    x, dt, A, Bm, Cm, st = _scan_case(S + chunk, B, S, H, P, N, init)
    y, fin = ops.ssd(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)), chunk=chunk,
                     init_state=None if st is None else torch.from_numpy(st))
    ry, rfin = RS.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk,
                              None if st is None else jnp.asarray(st))
    _close(y.numpy(), ry)
    _close(fin.numpy(), rfin)
    if S % chunk == 0 and not init:   # the Pallas kernel's domain
        py, pfin = ref_ops.ssd(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk=chunk,
                               impl="interpret")
        _close(y.numpy(), py)
        _close(fin.numpy(), pfin)


@pytest.mark.parametrize("B,S,H,P,N,chunk,init", SCANS)
def test_plain_ssd_phases_compose_to_reference(B, S, H, P, N, chunk, init):
    """K6's three phases in their plain versions (chunk states, state
    passing, chunk outputs), composed by hand, against the reference's
    ssd_chunked and, in the Pallas kernel's domain, the kernel in interpret
    mode; the state entering chunk c is the reference scan's final state
    over the first c chunks."""
    x, dt, A, Bm, Cm, st = _scan_case(S + chunk, B, S, H, P, N, init)
    tx, tdt, tA, tB, tC = (torch.from_numpy(a) for a in (x, dt, A, Bm, Cm))
    contrib, decay = ref.ssd_chunk_states_ref(tx, tdt, tA, tB, chunk)
    entering, fin = ref.ssd_state_passing_ref(contrib, decay,
                                              None if st is None else torch.from_numpy(st))
    y = ref.ssd_chunk_outputs_ref(tx, tdt, tA, tB, tC, entering, chunk)
    nc = -(-S // chunk)
    assert contrib.shape == entering.shape == (B, nc, H, P, N) and decay.shape == (B, nc, H)
    jx, jdt, jA, jB, jC = (jnp.asarray(a) for a in (x, dt, A, Bm, Cm))
    jst = None if st is None else jnp.asarray(st)
    ry, rfin = RS.ssd_chunked(jx, jdt, jA, jB, jC, chunk, jst)
    _close(y.numpy(), ry)
    _close(fin.numpy(), rfin)
    if S % chunk == 0 and not init:   # the Pallas kernel's domain
        py, pfin = ref_ops.ssd(jx, jdt, jA, jB, jC, chunk=chunk, impl="interpret")
        _close(y.numpy(), py)
        _close(fin.numpy(), pfin)
    assert torch.equal(entering[:, 0], torch.zeros_like(entering[:, 0]) if st is None
                       else torch.from_numpy(st))
    for c in range(1, nc):
        a = c * chunk
        _, rst = RS.ssd_chunked(jx[:, :a], jdt[:, :a], jA, jB[:, :a], jC[:, :a], chunk, jst)
        _close(entering[:, c].numpy(), rst)


@pytest.mark.parametrize("B,S,H,P,N", [(2, 40, 2, 32, 32), (1, 19, 3, 64, 128),
                                       (2, 64, 2, 32, 32)])
def test_ssd_ref_matches_reference(B, S, H, P, N):
    x, dt, A, Bm, Cm, _ = _scan_case(S, B, S, H, P, N)
    y, fin = ref.ssd_ref(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)))
    ry, rfin = ref_oracles.ssd_ref(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)))
    _close(y.numpy(), ry)
    _close(fin.numpy(), rfin)
    # and the chunked scan computes the recurrence (over several chunks and a tail)
    cy, cfin = ref.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)), 16)
    _close(cy.numpy(), y.numpy())
    _close(cfin.numpy(), fin.numpy())


# ------------------------------------------------------------- the block
def _block():
    """The reference's block parameters (``ssm_init``) and the port's SSM
    module holding the same values."""
    if "block" not in _M:
        cfg = ref_get_config(ARCH, smoke=True)
        p = RS.ssm_init(jax.random.PRNGKey(1), cfg)
        blk = S.SSM(get_config(ARCH, smoke=True), "cpu")
        with torch.no_grad():
            for name, t in blk.named_parameters():
                t.copy_(torch.from_numpy(np.array(p[name])))
        _M["block"] = (cfg, p, blk)
    return _M["block"]


def _hidden(seed, B, Sq, D):
    return (0.5 * np.random.default_rng(seed).standard_normal((B, Sq, D))).astype(np.float32)


def test_ssm_block_forward_and_decode_match_reference():
    cfg, p, blk = _block()
    pcfg = get_config(ARCH, smoke=True)
    h = _hidden(0, 2, 40, cfg.d_model)
    out, st = S.ssm_forward_with_state(blk, torch.from_numpy(h), pcfg)
    rout, rst = RS.ssm_forward_with_state(p, jnp.asarray(h), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), **BLOCK_TOL)
    np.testing.assert_allclose(st.conv.numpy(), np.asarray(rst.conv), **BLOCK_TOL)
    np.testing.assert_allclose(st.ssd.numpy(), np.asarray(rst.ssd), **BLOCK_TOL)
    # from a carried state, then three decode steps
    h2 = _hidden(1, 2, 21, cfg.d_model)
    out, st = S.ssm_forward_with_state(blk, torch.from_numpy(h2), pcfg, init=st)
    rout, rst = RS.ssm_forward_with_state(p, jnp.asarray(h2), cfg, init=rst)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), **BLOCK_TOL)
    for t in range(3):
        ht = _hidden(2 + t, 2, 1, cfg.d_model)[:, 0]
        conv_id = st.conv.data_ptr()
        y = S.ssm_decode(blk, torch.from_numpy(ht), st, pcfg)
        ry, rst = RS.ssm_decode(p, jnp.asarray(ht), rst, cfg)
        assert st.conv.data_ptr() == conv_id    # written in place
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), **BLOCK_TOL)
        np.testing.assert_allclose(st.conv.numpy(), np.asarray(rst.conv), **BLOCK_TOL)
        np.testing.assert_allclose(st.ssd.numpy(), np.asarray(rst.ssd), **BLOCK_TOL)


def test_ssm_prefill_state_handoff():
    """A sequence in two parts, the second from the first's state, equals
    the whole (tests/test_recurrent.py's contract, on the port)."""
    _, _, blk = _block()
    cfg = get_config(ARCH, smoke=True)
    h = torch.from_numpy(_hidden(3, 2, 40, cfg.d_model))
    full, fst = S.ssm_forward_with_state(blk, h, cfg)
    y1, st = S.ssm_forward_with_state(blk, h[:, :23], cfg)
    y2, st2 = S.ssm_forward_with_state(blk, h[:, 23:], cfg, init=st)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), full.numpy(), **BLOCK_TOL)
    np.testing.assert_allclose(st2.ssd.numpy(), fst.ssd.numpy(), **BLOCK_TOL)
    np.testing.assert_allclose(st2.conv.numpy(), fst.conv.numpy(), **BLOCK_TOL)


def test_ssm_forward_matches_stepwise_decode():
    """The chunked forward (several chunks and a tail) equals the
    one-token recurrence step by step (tests/test_recurrent.py's contract)."""
    _, _, blk = _block()
    cfg = get_config(ARCH, smoke=True)
    h = torch.from_numpy(_hidden(4, 1, 40, cfg.d_model))
    y_fwd, final = S.ssm_forward_with_state(blk, h, cfg)
    st = S.ssm_state_init(1, cfg, "cpu")
    ys = [S.ssm_decode(blk, h[:, t], st, cfg) for t in range(h.shape[1])]
    np.testing.assert_allclose(y_fwd.numpy(), torch.stack(ys, 1).numpy(), **BLOCK_TOL)
    np.testing.assert_allclose(final.ssd.numpy(), st.ssd.numpy(), **BLOCK_TOL)
    np.testing.assert_allclose(final.conv.numpy(), st.conv.numpy(), **BLOCK_TOL)


# ------------------------------------------------------------- the model
def _models():
    if "model" not in _M:
        cfg = ref_get_config(ARCH, smoke=True)
        params = ref_init_params(jax.random.PRNGKey(0), cfg)
        port = params_from_numpy(jax.tree.map(np.asarray, params),
                                 get_config(ARCH, smoke=True), device="cpu")
        _M["model"] = (cfg, params, port)
    return _M["model"]


def _check_state(got, want):
    assert len(got.caches) == len(want.caches)
    for g, w in zip(got.caches, want.caches):
        np.testing.assert_allclose(g.conv.numpy(), np.asarray(w.conv), **TOL)
        np.testing.assert_allclose(g.ssd.numpy(), np.asarray(w.ssd), **TOL)
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
    np.testing.assert_array_equal(got.last_tok.numpy(), np.asarray(want.last_tok))


def test_mamba2_prefill_and_decode_match_reference():
    """S = 40 at the smoke chunk of 16: two whole chunks and a tail."""
    cfg, params, port = _models()
    B, Sq = 4, 40
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, Sq)).astype(np.int32)
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


def test_mamba2_ragged_prefill_raises():
    _, _, port = _models()
    toks = torch.zeros((2, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="ragged prefill is not supported for 'ssm' blocks"):
        prefill(port, toks, 64, prompt_lens=torch.tensor([16, 5], dtype=torch.int32))


def test_init_params_gives_the_reference_ssm_constants():
    cfg = ref_get_config(ARCH, smoke=True)
    want = RS.ssm_init(jax.random.PRNGKey(0), cfg)
    model = init_params(get_config(ARCH, smoke=True), seed=0, device="cpu")
    for seg in model.stack:
        for blk in seg:
            p = blk.ssm
            # A_log rounded once from float64; the reference's float32 linspace
            # and log may sit an ulp away
            np.testing.assert_allclose(p.A_log.numpy(), np.asarray(want["A_log"]),
                                       rtol=2e-7, atol=0)
            for name in ("D", "dt_bias", "norm", "conv_b"):
                np.testing.assert_array_equal(p.get_parameter(name).detach().numpy(),
                                              np.asarray(want[name]), err_msg=name)
            assert abs(p.conv_w.std().item() - 0.1) < 0.01
            assert abs(p.in_proj.std().item() - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
            assert torch.equal(blk.ln1, torch.ones(cfg.d_model))


# ------------------------------------------------------------ the engine
class PaddedPromptComparator(MarginComparator):
    """The margin comparator for a stack the engine prefills over the full
    padded bucket: the reference's top-2 gap is taken after the padded
    prompt (ROADMAP R7), as the engine predicted the token."""

    def __init__(self, params, cfg, cache_len, margin, prompt_len):
        super().__init__(params, cfg, cache_len, margin)
        self.prompt_len = prompt_len

    def _ref_gap(self, prompt, generated):
        toks = np.asarray(prompt[:self.prompt_len], np.int32)
        padded = np.concatenate([toks, np.full(self.prompt_len - len(toks), PAD_ID, np.int32)])
        return super()._ref_gap(padded, generated)


@pytest.mark.parametrize("mode", ["fused", "legacy", "sync"])
def test_engine_trace_and_streams_match_reference(mode):
    """Prompts of 5-40 tokens in a bucket of 40 (two chunks of 16 and a
    tail), right-padded: the serve trace, the counters and the greedy
    streams equal the reference's."""
    cfg, params, port = _models()
    kw = dict(batch_slots=4, prompt_len=40, cache_len=64)
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
    # the reference counts its wall-clock overlap misses; the port's CPU copies land at once
    assert ours.counters() == {**ref.counters(), "readback_waits": 0}
    reqs = ours.finished + [r for r in ours.active if r is not None and r.generated]
    got = {r.rid: list(r.generated) for r in reqs}
    want = {r.rid: list(r.generated) for r in ref.finished + [r for r in ref.active
                                                             if r is not None and r.generated]}
    assert sum(map(len, got.values())) > 0
    PaddedPromptComparator(params, cfg, 64, MARGIN, 40).check(
        got, want, {r.rid: r.tokens for r in reqs})


def test_engine_splices_recurrent_state_rows():
    """A batch-1 admission spliced into row 2 leaves the other rows'
    states as they were and gives row 2 the batch-1 prefill's state."""
    _, _, port = _models()
    eng = Engine(port, EngineConfig(batch_slots=4, prompt_len=40, cache_len=64))
    before = [(c.conv.clone(), c.ssd.clone()) for c in eng.state.caches]
    src = RequestSource(vocab_size=port.cfg.vocab_size, prompt_len=40, raw_rate=1, seed=3)
    req = src.poll(0, 1.0)[0]
    eng._admit_one(req, 2, 0)
    toks = np.asarray(req.tokens[:40], np.int32)
    toks = np.concatenate([toks, np.full(40 - len(toks), PAD_ID, np.int32)])
    _, one = prefill(port, torch.from_numpy(toks[None]), 64)
    for c, (conv, ssd), o in zip(eng.state.caches, before, one.caches):
        for r in (0, 1, 3):
            assert torch.equal(c.conv[:, r], conv[:, r]) and torch.equal(c.ssd[:, r], ssd[:, r])
        assert torch.equal(c.conv[:, 2], o.conv[:, 0]) and torch.equal(c.ssd[:, 2], o.ssd[:, 0])
    assert int(eng.state.pos[2]) == 40


# ----------------------------------------------------------- the launcher
@pytest.mark.parametrize("flags", [(), ("--legacy-loop",), ("--sync-free",)])
def test_launcher_lines_match_reference(flags):
    """The summary and latency lines of ``--arch mamba2-130m``; the
    reference's sync-free line with its early consume off (ROADMAP R5)."""
    ours = _launch("repro_torch.launch.serve", "--arch", ARCH, "--device", "cpu", *flags)
    launch_ref = _launch_late if "--sync-free" in flags else _launch
    theirs = launch_ref("repro.launch.serve", "--arch", ARCH, *flags)
    assert ours[:2] == theirs[:2]
    if not flags:
        assert ours[0] == ("policy=adaptive served=24 dropped=0 tail_backlog=5.6 mean_rate=2.67 "
                           "dispatches_per_slot=1.50 blocking_syncs_per_slot=1.50")


@pytest.mark.parametrize("flags,message", [
    (("--chunked", "--policy", "token-aware"),
     "mamba2-130m-smoke: chunked prefill needs a dense-attention stack and no sliding window"),
    (("--paged", "--policy", "memory-aware"),
     "mamba2-130m-smoke: paged decode needs an all-attention stack"),
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


def test_engine_keeps_the_state_tensors():
    """The fused, legacy and sync-free slots write the recurrent state in
    place: the decode state's tensors keep their identity across slots."""
    _, _, port = _models()
    eng = Engine(port, EngineConfig(batch_slots=2, prompt_len=40, cache_len=64))
    ptrs = [(c.conv.data_ptr(), c.ssd.data_ptr()) for c in eng.state.caches]
    src = RequestSource(vocab_size=port.cfg.vocab_size, prompt_len=40, raw_rate=2, seed=4)
    eng.submit(copy.deepcopy(src.poll(0, 2.0)))
    eng.step_slot(0, n_steps=2)
    eng.step(1)
    eng.submit(copy.deepcopy(src.poll(2, 2.0)))
    eng.step_slot_sync(2, n_steps=2)
    eng.drain()
    assert [(c.conv.data_ptr(), c.ssd.data_ptr()) for c in eng.state.caches] == ptrs
