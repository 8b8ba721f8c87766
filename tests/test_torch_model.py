"""The port's model against the reference's, with the reference's weights
carried across (``convert.params_from_numpy``): prefill logits and every
decode-state leaf, then greedy decode steps, for padded and ragged buckets."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import init_params as ref_init_params
from repro.models import model as RM
from repro_torch.configs import get_config
from repro_torch.models import decode_step, prefill
from repro_torch.models.convert import params_from_numpy
from test_torch_engine import one_torch_thread  # noqa: F401  (autouse fixture)

# Both sides run in float32. They differ in summation order (matmuls,
# softmax) and in the transcendental functions (rope's cos/sin, exp), which
# after two layers leaves ~1e-5 on the logits; 1e-4 keeps margin while
# staying far below the logit gaps that decide the greedy tokens.
TOL = dict(atol=1e-4, rtol=1e-4)
_MODELS = {}


def _models(arch):
    if arch not in _MODELS:
        cfg = ref_get_config(arch, smoke=True)
        params = ref_init_params(jax.random.PRNGKey(0), cfg)
        tree = jax.tree.map(np.asarray, params)
        port = params_from_numpy(tree, get_config(arch, smoke=True), device="cpu")
        _MODELS[arch] = (cfg, params, port)
    return _MODELS[arch]


def _check_state(got, want):
    assert len(got.caches) == len(want.caches)
    for g, w in zip(got.caches, want.caches):
        np.testing.assert_allclose(g.k.numpy(), np.asarray(w.k), **TOL)
        np.testing.assert_allclose(g.v.numpy(), np.asarray(w.v), **TOL)
        np.testing.assert_array_equal(g.slot_pos.numpy(), np.asarray(w.slot_pos))
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
    np.testing.assert_array_equal(got.last_tok.numpy(), np.asarray(want.last_tok))


CASES = [  # (arch, S, cache_len, lens, shape_window)
    ("granite-3-2b", 16, 64, None, None),             # padded bucket
    ("granite-3-2b", 16, 64, [1, 16, 9, 5], None),    # ragged bucket
    ("granite-3-2b", 16, 8, [16, 3, 12, 8], None),    # ring shorter than the prompt
    ("granite-3-2b", 16, 64, [2, 16, 7, 11], 5),      # windowed attention
    ("qwen3-8b", 8, 32, [8, 1, 5, 6], None),          # qk-norm
]


@pytest.mark.parametrize("arch,S,cache_len,lens,window", CASES)
def test_prefill_and_decode_match_reference(arch, S, cache_len, lens, window):
    cfg, params, port = _models(arch)
    B = 4
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lens_np = None if lens is None else np.asarray(lens, np.int32)
    ref_logits, ref_state = RM.prefill(
        params, {"tokens": jnp.asarray(toks)}, cfg, cache_len, shape_window=window,
        prompt_lens=None if lens_np is None else jnp.asarray(lens_np))
    logits, state = prefill(port, torch.from_numpy(toks), cache_len, shape_window=window,
                            prompt_lens=None if lens_np is None else torch.from_numpy(lens_np))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    _check_state(state, ref_state)

    nxt = np.asarray(jnp.argmax(ref_logits, -1)).astype(np.int32)
    assert (logits.argmax(-1).numpy() == nxt).all()
    for _ in range(4):  # past the ring's end when cache_len < S
        ref_logits, ref_state = RM.decode_step(params, ref_state, jnp.asarray(nxt), cfg,
                                               shape_window=window)
        logits, state = decode_step(port, state, torch.from_numpy(nxt), shape_window=window)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
        nxt = np.asarray(jnp.argmax(ref_logits, -1)).astype(np.int32)
        assert (logits.argmax(-1).numpy() == nxt).all()
    _check_state(state, ref_state)


def test_init_params_is_seeded_and_scaled():
    cfg = get_config("granite-3-2b", smoke=True)
    from repro_torch.models import init_params
    a, b = init_params(cfg, seed=3, device="cpu"), init_params(cfg, seed=3, device="cpu")
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    blk = a.stack[0][0]
    assert torch.equal(blk.ln1, torch.ones(cfg.d_model))
    assert abs(blk.attn.wq.std().item() - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    assert abs(a.tok.std().item() - 0.02) < 0.002


def test_unported_archs_raise_not_implemented():
    from repro_torch.models import Model
    for arch in ("olmoe-1b-7b", "recurrentgemma-2b"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
            Model(get_config(arch, smoke=True), device="cpu")
    cfg = get_config("granite-3-2b", smoke=True).replace(kv_precision="int8")
    with pytest.raises(NotImplementedError, match="item 9"):
        Model(cfg, device="cpu")
