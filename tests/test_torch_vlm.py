"""The port's VLM (paligemma-3b) against the reference's: K1's plain version
with the prefix-LM mask against the reference's ``chunked_attention``, the
smoke model's prefill with image patches (bridged from the reference's
``vision_patch_embeddings`` as numpy) and the decode steps after it, the
text-only serve on every loop the reference's launcher runs for it, and
the ``--paged`` and ``--chunked`` refusals."""
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
from repro.models.attention import chunked_attention
from repro.models.frontends import vision_patch_embeddings as ref_patches
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import decode_step, prefill
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.frontends import vision_patch_embeddings
from test_torch_chunked import _launch_late
from test_torch_engine import SRC, _launch, one_torch_thread  # noqa: F401  (autouse fixture)

ARCH = "paligemma-3b"
# float32 on both sides; the attention sums in other orders (the reference
# in 512-key blocks, the plain version over the whole row): ~1e-6 of the
# outputs, kept well below 1e-5
ATTN_TOL = dict(atol=1e-5, rtol=1e-5)
# the model tolerance of tests/test_torch_model.py
TOL = dict(atol=1e-4, rtol=1e-4)
_M = {}


def _qkv(seed, B, S, H, KVH, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, n, hd)).astype(np.float32) for n in (H, KVH, KVH)]


@pytest.mark.parametrize("S,prefix,window", [(40, 16, None), (40, 16, 8), (33, 30, 5),
                                             (24, 1, None), (24, 24, None)])
def test_plain_prefix_attention_matches_reference(S, prefix, window):
    """K1's plain version with ``prefix_len`` against the reference's rule,
    ``(k <= q and k > q - window) or k < prefix_len``, with and without a
    window, a prefix of one key and one as long as the sequence."""
    q, k, v = _qkv(S, 2, S, 4, 2, 16)
    want = chunked_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=True, window=window,
                             prefix_len=prefix, block_q=16, block_k=16)
    got = ref.attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                            window=window, prefix_len=prefix)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


def test_prefix_refuses_ragged_codes_and_non_causal():
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 2, 8, 2, 1, 16))
    lens = torch.tensor([8, 5], dtype=torch.int32)
    with pytest.raises(ValueError, match="seq_lens"):
        ops.flash_attention(q, k, v, lens, prefix_len=4)
    with pytest.raises(ValueError, match="causal"):
        ops.flash_attention(q, k, v, causal=False, prefix_len=4)
    codes = k.to(torch.int8)
    scale = torch.ones(2, 8, 1)
    with pytest.raises(ValueError, match="quantized"):
        ops.flash_attention(q, codes, codes, k_scale=scale, v_scale=scale, prefix_len=4)
    assert torch.equal(ops.flash_attention(q, k, v, prefix_len=0),
                       ops.flash_attention(q, k, v))


def _models():
    if not _M:
        cfg = ref_get_config(ARCH, smoke=True)
        params = ref_init_params(jax.random.PRNGKey(0), cfg)
        port = params_from_numpy(jax.tree.map(np.asarray, params),
                                 get_config(ARCH, smoke=True), device="cpu")
        _M.update(cfg=cfg, params=params, port=port)
    return _M["cfg"], _M["params"], _M["port"]


def _check_state(got, want):
    for g, w in zip(got.caches, want.caches, strict=True):
        np.testing.assert_allclose(g.k.numpy(), np.asarray(w.k), **TOL)
        np.testing.assert_allclose(g.v.numpy(), np.asarray(w.v), **TOL)
        np.testing.assert_array_equal(g.slot_pos.numpy(), np.asarray(w.slot_pos))
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
    np.testing.assert_array_equal(got.last_tok.numpy(), np.asarray(want.last_tok))


@pytest.mark.parametrize("S,cache_len,patches", [(16, 48, True), (12, 16, True),
                                                 (16, 48, False)])
def test_prefill_with_patches_and_decode_match_reference(S, cache_len, patches):
    """The smoke model's prefill over 16 patches and S tokens (patches
    bridged from the reference's draw; a ring of 16 keeps only the tail of
    the 28 positions), then 4 greedy decode steps: logits and every state
    leaf within TOL, the tokens equal; and text-only, as the engine
    prefills."""
    cfg, params, port = _models()
    B = 3
    toks = np.random.default_rng(S).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks)}
    kw = {}
    if patches:
        batch["patches"] = ref_patches(jax.random.PRNGKey(1), B, cfg)
        kw["patches"] = torch.from_numpy(np.array(batch["patches"]))
    ref_logits, ref_state = RM.prefill(params, batch, cfg, cache_len)
    logits, state = prefill(port, torch.from_numpy(toks), cache_len, **kw)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    _check_state(state, ref_state)
    assert int(state.pos[0]) == S + (cfg.num_prefix_tokens if patches else 0)
    nxt = np.asarray(jnp.argmax(ref_logits, -1)).astype(np.int32)
    for _ in range(4):
        assert (logits.argmax(-1).numpy() == nxt).all()
        ref_logits, ref_state = RM.decode_step(params, ref_state, jnp.asarray(nxt), cfg)
        logits, state = decode_step(port, state, torch.from_numpy(nxt))
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
        nxt = np.asarray(jnp.argmax(ref_logits, -1)).astype(np.int32)
    _check_state(state, ref_state)


def test_patch_stand_in_is_seeded_and_scaled():
    cfg = get_config(ARCH, smoke=True)
    a = vision_patch_embeddings(64, cfg, seed=3, device="cpu")
    assert a.shape == (64, cfg.num_prefix_tokens, cfg.d_model) and a.dtype == torch.float32
    assert torch.equal(a, vision_patch_embeddings(64, cfg, seed=3, device="cpu"))
    assert abs(a.std().item() - 0.02) < 0.001


def test_ragged_prefill_refuses_patches():
    _, _, port = _models()
    toks = torch.zeros((2, 8), dtype=torch.int32)
    patches = vision_patch_embeddings(2, port.cfg, device="cpu")
    with pytest.raises(ValueError, match="ragged prefill takes no patches"):
        prefill(port, toks, 32, prompt_lens=torch.tensor([8, 4]), patches=patches)


# ----------------------------------------------------------- the launcher
@pytest.mark.parametrize("flags", [(), ("--legacy-loop",), ("--sync-free",),
                                   ("--kv-precision", "int8")])
def test_launcher_lines_match_reference(flags):
    """The summary and latency lines of ``--arch paligemma-3b`` (text-only,
    a padded admission whose first logits are the last padded position's,
    R7); the reference's sync-free line with its early consume off (R5)."""
    ours = _launch("repro_torch.launch.serve", "--arch", ARCH, "--device", "cpu", *flags)
    launch_ref = _launch_late if "--sync-free" in flags else _launch
    theirs = launch_ref("repro.launch.serve", "--arch", ARCH, *flags)
    assert ours[:2] == theirs[:2]
    assert ours[0].startswith("policy=adaptive served=")


@pytest.mark.parametrize("flags,message", [
    (("--chunked", "--policy", "token-aware"),
     "paligemma-3b-smoke: chunked prefill needs a dense-attention stack and no sliding window"),
    (("--paged", "--policy", "memory-aware"),
     "paligemma-3b-smoke: paged decode needs an all-attention stack"),
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
