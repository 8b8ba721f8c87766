"""The port's encoder-decoder (seamless-m4t-large-v2) against the
reference's, at model level: K1's plain version without the causal mask
against the Pallas kernel (``causal=False``, interpret mode) at Sq = Sk and
Sq != Sk, one cross-attention decode, the smoke model's prefill with audio
frames (bridged from the reference's ``audio_frame_embeddings`` as numpy)
and the decode steps after it, and the engines and launcher refusing it,
as the reference's engine cannot serve it (ROADMAP R12)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import attention as RA
from repro.models import init_params as ref_init_params
from repro.models import model as RM
from repro.models.frontends import audio_frame_embeddings as ref_frames
from repro_torch.configs import get_config
from repro_torch.kernels import ref
from repro_torch.models import attention as A
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.frontends import audio_frame_embeddings
from repro_torch.runtime import Engine, EngineConfig, PagedEngine, PagedEngineConfig
from test_torch_engine import one_torch_thread  # noqa: F401  (autouse fixture)

ARCH = "seamless-m4t-large-v2"
# float32 on both sides; the two sum the keys in other orders (the Pallas
# kernel tile by tile with an online softmax, the plain version over the
# whole row): ~1e-6 of the outputs
ATTN_TOL = dict(atol=1e-5, rtol=1e-5)
# the model tolerance of tests/test_torch_model.py
TOL = dict(atol=1e-4, rtol=1e-4)
_M = {}


@pytest.mark.parametrize("Sq,Sk,block", [(64, 64, 32), (24, 40, 8), (16, 100, 16)])
def test_plain_non_causal_attention_matches_pallas(Sq, Sk, block):
    """Every key visible to every query: an encoder's self-attention (Sq =
    Sk) and a decoder's cross-attention (Sq != Sk, Sk not a multiple of
    64), K1's plain version against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(Sq + Sk)
    q = rng.standard_normal((2, Sq, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, Sk, 2, 16)).astype(np.float32) for _ in range(2))
    want = pallas_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=False, block_q=block,
                        block_k=Sk if Sk % block else block, interpret=True)
    got = ref.attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


def _models():
    if not _M:
        cfg = ref_get_config(ARCH, smoke=True)
        params = ref_init_params(jax.random.PRNGKey(0), cfg)
        port = params_from_numpy(jax.tree.map(np.asarray, params),
                                 get_config(ARCH, smoke=True), device="cpu")
        _M.update(cfg=cfg, params=params, port=port)
    return _M["cfg"], _M["params"], _M["port"]


def test_cross_attention_decode_matches_reference():
    """One token's cross-attention over a fixed encoder cache: the port
    reads it as a fully valid ring (K2's plain version at pos Se - 1)."""
    cfg, params, port = _models()
    p = jax.tree.map(lambda a: a[0], params["stack"][0]["xattn"])
    rng = np.random.default_rng(0)
    enc = rng.standard_normal((3, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((3, cfg.d_model)).astype(np.float32)
    xc = RA.cross_attn_cache(p, jnp.asarray(enc))
    want = RA.cross_attn_decode(p, jnp.asarray(x), xc, cfg)
    blk = port.stack[0][0].xattn
    cache = A.cross_attn_cache_init(3, cfg.enc_seq, port.cfg, "cpu")
    A.cross_attn_cache(blk, torch.from_numpy(enc), cache)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(xc["k"]), **TOL)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(xc["v"]), **TOL)
    assert torch.equal(cache.slot_pos, torch.arange(cfg.enc_seq, dtype=torch.int32).expand(3, -1))
    got = A.cross_attn_decode(blk, torch.from_numpy(x), cache, port.cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _check_state(got, want):
    for g, w in zip(got.caches, want.caches, strict=True):
        s, x = g["self"], g["cross"]
        np.testing.assert_allclose(s.k.numpy(), np.asarray(w["self"].k), **TOL)
        np.testing.assert_allclose(s.v.numpy(), np.asarray(w["self"].v), **TOL)
        np.testing.assert_array_equal(s.slot_pos.numpy(), np.asarray(w["self"].slot_pos))
        np.testing.assert_allclose(x.k.numpy(), np.asarray(w["cross"]["k"]), **TOL)
        np.testing.assert_allclose(x.v.numpy(), np.asarray(w["cross"]["v"]), **TOL)
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
    np.testing.assert_array_equal(got.last_tok.numpy(), np.asarray(want.last_tok))


@pytest.mark.parametrize("S,cache_len,n_frames", [(16, 32, None), (12, 8, 20)])
def test_prefill_with_frames_and_decode_match_reference(S, cache_len, n_frames):
    """The smoke model's prefill over audio frames (the config's 32, and 20)
    and S tokens (a ring of 8 keeps only the prompt's tail), then 4 greedy
    decode steps: logits and every state leaf (self ring, cross K/V) within
    TOL, the tokens equal."""
    cfg, params, port = _models()
    B = 3
    toks = np.random.default_rng(S).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = ref_frames(jax.random.PRNGKey(2), B, cfg, n_frames)
    ref_logits, ref_state = RM.prefill(params, {"tokens": jnp.asarray(toks), "frames": frames},
                                       cfg, cache_len)
    logits, state = prefill(port, torch.from_numpy(toks), cache_len,
                            frames=torch.from_numpy(np.array(frames)))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    _check_state(state, ref_state)
    assert state.caches[0]["cross"].cache_len == (n_frames or cfg.enc_seq)
    nxt = np.asarray(jnp.argmax(ref_logits, -1)).astype(np.int32)
    for _ in range(4):
        assert (logits.argmax(-1).numpy() == nxt).all()
        ref_logits, ref_state = RM.decode_step(params, ref_state, jnp.asarray(nxt), cfg)
        logits, state = decode_step(port, state, torch.from_numpy(nxt))
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
        nxt = np.asarray(jnp.argmax(ref_logits, -1)).astype(np.int32)
    _check_state(state, ref_state)


def test_encoder_output_matches_reference():
    cfg, params, port = _models()
    frames = ref_frames(jax.random.PRNGKey(3), 2, cfg)
    from repro_torch.models.model import encode
    got = encode(port, torch.from_numpy(np.array(frames)))
    np.testing.assert_allclose(got.numpy(), np.asarray(RM._encode(params, frames, cfg)), **TOL)


def test_prefill_needs_frames_and_init_params_fills_the_encoder():
    _, _, port = _models()
    with pytest.raises(ValueError, match="needs frames"):
        prefill(port, torch.zeros((2, 8), dtype=torch.int32), 16)
    cfg = get_config(ARCH, smoke=True)
    model = init_params(cfg, seed=1, device="cpu")
    assert torch.equal(model.encoder.ln_f, torch.ones(cfg.d_model))
    assert torch.equal(model.stack[0][0].lnx, torch.ones(cfg.d_model))
    assert not hasattr(model.stack[0][0].xattn, "q_norm")
    frames = audio_frame_embeddings(2, cfg, seed=4, device="cpu")
    assert frames.shape == (2, cfg.enc_seq, cfg.d_model)
    assert abs(frames.std().item() - 0.02) < 0.002
    logits, state = prefill(model, torch.zeros((2, 8), dtype=torch.int32), 16, frames=frames)
    assert torch.isfinite(logits).all() and int(state.pos[0]) == 8


def test_engines_and_launcher_refuse_it_naming_r12():
    _, _, port = _models()
    for mk in (lambda: Engine(port, EngineConfig(batch_slots=2, prompt_len=8, cache_len=16)),
               lambda: PagedEngine(port, PagedEngineConfig(batch_slots=2, prompt_len=8,
                                                           cache_len=16))):
        with pytest.raises(NotImplementedError, match="R12.*ROADMAP.md queue 1 item 11"):
            mk()
    from repro_torch.launch import serve as launcher
    with pytest.raises(NotImplementedError, match="R12.*ROADMAP.md queue 1 item 11"):
        launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--horizon", "2"])
