"""The port's legacy unscaled KV storage casts against the reference's: the
cast rule (``attention.cast_to_storage``, XLA's NaN past float8_e4m3fn's
range where torch saturates), the ring and page writes of prefill,
decode, chunk, splice and fork bit for bit (values past 464 included),
the plain cast reads against the reference's ``astype(q.dtype)``, the
model's decode under ``cache_dtype="float8_e4m3fn"``
(tests/test_perf_knobs.py's check), the dense engine's fused, legacy,
sync-free, chunked and sampled loops and the paged engine's fused,
sync-free and chunked loops with prefix sharing under a cast, the
deprecation warning, and the refusal of a cast dtype the port does not
serve."""
import copy
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as RA
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.models import model as RM
from repro.runtime import Engine as RefEngine
from repro.runtime import EngineConfig as RefEngineConfig
from repro.runtime import PagedEngine as RefPagedEngine
from repro.runtime import PagedEngineConfig as RefPagedEngineConfig
from repro_torch.cache import precision as P
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import ref as plain
from repro_torch.models import Model
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models.convert import kv_cache_from_numpy, params_from_numpy
from repro_torch.runtime import Engine, EngineConfig, PagedEngine, PagedEngineConfig
from test_differential import drive, make_shared_workload, make_workload
from test_torch_chunked import late_consume
from test_torch_engine import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    MARGIN, _weights, one_torch_thread)
from test_torch_quant_dense import QuantMarginComparator
from test_torch_sampling import _match

CASTS = ("float16", "bfloat16", "float8_e4m3fn")
# finite values on both sides of float8_e4m3fn's rounding limit (a tie at
# 464 rounds to 448, anything past it is NaN in XLA), infinities, NaNs of
# both signs, subnormals of each format and values fp16 and bf16 round apart
EDGES = np.array([500, -1000, 70000, 3e38, 447.9, 464, 464.01, -464.01, 448, -448, 0.3, 1e-4,
                  np.inf, -np.inf, np.nan, -np.nan, 65504, 65520, -65520, 1e-7, 6e-8, 2e-3,
                  1 + 2 ** -9, 1 + 3 * 2 ** -11, 0.0, -0.0], np.float32)


def _with_cast(cfg, cast: str):
    """``cfg`` under the unscaled cast to ``cast``: float8_e4m3fn through the
    legacy ``cache_dtype`` (the reference benchmarks' knob; as a
    ``kv_precision`` string it names the scaled fp8 codes), the others
    through ``kv_precision``."""
    if cast == "float8_e4m3fn":
        return cfg.replace(cache_dtype=cast)
    return cfg.replace(kv_precision=cast)


def _bytes(a) -> np.ndarray:
    """Raw bytes of a torch tensor or a JAX/numpy array, flattened."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy().reshape(-1)
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8).reshape(-1)


def _same_bits(x: jax.Array) -> torch.Tensor:
    """A JAX array as a CPU tensor with the same bits (bf16 and fp8 through
    their bytes)."""
    a = np.asarray(x)
    if a.dtype.name in ("bfloat16", "float8_e4m3fn"):
        dt = getattr(torch, a.dtype.name)
        return torch.from_numpy(a.view(np.uint8).copy()).view(dt)
    return torch.from_numpy(a.copy())


# ---------------------------------------------------------------- the rule
@pytest.mark.parametrize("src", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", CASTS + ("float32",))
def test_cast_to_storage_matches_xla(src, dtype):
    """``cast_to_storage`` gives the bytes of XLA's ``astype`` for edge
    values and a seeded spread up to 1e3; for float8_e4m3fn torch's own
    cast differs (it saturates to +-448 where XLA gives NaN). A NaN input
    cast to a 2- or 4-byte float is NaN on both sides, with the payload
    each framework picks (no finite value becomes NaN in those casts)."""
    rng = np.random.default_rng(5)
    vals = np.concatenate([EDGES, (rng.standard_normal(256) * 300).astype(np.float32)])
    x = jnp.asarray(vals).astype(src)
    want = x.astype(dtype)
    got = A.cast_to_storage(_same_bits(x), getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float8_e4m3fn":
        np.testing.assert_array_equal(_bytes(got), _bytes(want))
    else:
        nan = np.isnan(vals)
        np.testing.assert_array_equal(torch.isnan(got.float()).numpy(), nan)
        np.testing.assert_array_equal(_bytes(got[torch.from_numpy(~nan)]),
                                      _bytes(np.asarray(want)[~nan]))
    if dtype == "float8_e4m3fn":
        assert (_bytes(_same_bits(x).to(torch.float8_e4m3fn)) != _bytes(want)).sum() >= 10


def test_unserved_cast_dtype_raises():
    cfg = get_config("granite-3-2b", smoke=True)
    for bad in ("float64", "float8_e5m2"):
        with pytest.raises(ValueError, match=bad):
            Model(cfg.replace(kv_precision=bad), device="cpu")
    for dt in CASTS + ("float32",):
        model = Model(_with_cast(cfg, dt), device="cpu")
        assert A.kv_cache_init(1, 4, model.cfg, "cpu").k.dtype == getattr(torch, dt)


def test_cache_dtype_warns_once_per_dtype(monkeypatch):
    """The deprecated ``cache_dtype`` resolves to the cast and warns once
    per dtype, across engines, as the reference's ``resolve_kv_precision``."""
    monkeypatch.setattr(P, "_warned", set())
    port = _weights()["port"]
    kw = dict(batch_slots=2, prompt_len=8, cache_len=16)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        for dt in ("float16", "float16", "bfloat16"):
            model = copy.copy(port)
            model.cfg = port.cfg.replace(cache_dtype=dt)
            eng = Engine(model, EngineConfig(**kw))
            assert eng.kvp == P.KVPrecision(dtype=dt)
            assert eng.state.caches[0].k.dtype == getattr(torch, dt)
    dep = [str(w.message) for w in seen if issubclass(w.category, DeprecationWarning)]
    assert len(dep) == 2 and "'float16'" in dep[0] and "'bfloat16'" in dep[1]


# ------------------------------------------------------------- the writes
def _layer(cfg_dtype, scale_rows):
    """Layer 0's attention of the smoke model in both packages, at
    ``cfg_dtype`` compute, with wk and wv rows below ``scale_rows`` scaled by
    1e2 .. 1e5: one-hot inputs then give K/V rows holding the weights
    exactly, many past float8_e4m3fn's range (none past float16's)."""
    w = _weights()
    leaves = {n: np.array(w["params"]["stack"][0]["attn"][n][0], np.float32)
              for n in ("wq", "wk", "wv", "wo")}
    for n in ("wk", "wv"):
        leaves[n][:scale_rows] *= np.logspace(2, 5, scale_rows, dtype=np.float32)[:, None, None]
    rcfg = w["cfg"].replace(dtype=cfg_dtype)
    cfg = w["port"].cfg.replace(dtype=cfg_dtype)
    p_ref = {n: jnp.asarray(a).astype(cfg_dtype) for n, a in leaves.items()}
    attn = A.Attention(cfg, "cpu")
    for n, a in leaves.items():
        getattr(attn, n).data.copy_(torch.from_numpy(a).to(getattr(torch, cfg_dtype)))
    return rcfg, cfg, p_ref, attn


def _one_hot(rng, shape, D, dtype):
    """One-hot rows, every other one on a scaled weight row of ``_layer``."""
    x = np.zeros((*shape, D), np.float32)
    idx = rng.integers(0, D, (*shape, 1))
    idx[..., ::2, :] %= 24
    np.put_along_axis(x, idx, 1.0, axis=-1)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _check_cache(cache, rc):
    for name in ("k", "v", "slot_pos", "stage_k", "stage_v"):
        np.testing.assert_array_equal(_bytes(getattr(cache, name)), _bytes(getattr(rc, name)),
                                      err_msg=name)


WRITE_CASES = [(c, "float32") for c in CASTS] + [("float16", "bfloat16"),
                                                 ("float8_e4m3fn", "bfloat16")]


@pytest.mark.parametrize("cast,compute", WRITE_CASES)
def test_ring_writes_match_reference(monkeypatch, cast, compute):
    """A cast ring written by a ragged prefill that wraps it, two decode
    steps and a chunk, on one-hot inputs with RoPE the identity in both
    packages (so both write the same K/V exactly): k, v, slot_pos and the
    staging buffers bit for bit after each, NaN bytes past 464 included."""
    monkeypatch.setattr(RA, "apply_rope", lambda x, positions, theta: x)
    monkeypatch.setattr(A, "apply_rope", lambda x, positions, theta: x)
    rcfg, cfg, p_ref, attn = _layer(compute, 24)
    rcfg, cfg = _with_cast(rcfg, cast), _with_cast(cfg, cast)
    rng = np.random.default_rng(11)
    B, S, L, D = 3, 16, 12, cfg.d_model
    xj, xt = _one_hot(rng, (B, S), D, compute)
    lens = np.asarray([S, 5, 9], np.int32)
    _, rc = RA.attn_prefill(p_ref, xj, rcfg, L, seq_lens=jnp.asarray(lens))
    cache = A.kv_cache_init(B, L, cfg, "cpu")
    A.attn_prefill(attn, xt, cfg, cache, seq_lens=torch.from_numpy(lens))
    assert cache.k.dtype == getattr(torch, cast)
    _check_cache(cache, rc)
    pos = lens.copy()
    for _ in range(2):
        xj, xt = _one_hot(rng, (B,), D, compute)
        _, rc = RA.attn_decode(p_ref, xj, rc, jnp.asarray(pos), rcfg)
        A.attn_decode(attn, xt, cache, torch.from_numpy(pos), cfg)
        _check_cache(cache, rc)
        pos += 1
    C = 5
    pos0, valid = np.asarray([pos[0], pos[1], 0], np.int32), np.asarray([3, 5, 0], np.int32)
    xj, xt = _one_hot(rng, (B, C), D, compute)
    _, rc = RA.attn_chunk(p_ref, xj, rc, jnp.asarray(pos0), jnp.asarray(valid), rcfg)
    tp0, tv = torch.from_numpy(pos0), torch.from_numpy(valid)
    A.attn_chunk(attn, xt, cache, tp0, tv, cfg, A.chunk_write_targets(tp0, tv, C, L))
    _check_cache(cache, rc)
    if cast == "float8_e4m3fn":
        codes = _bytes(cache.k)
        assert ((codes & 0x7F) == 0x7F).sum() > 0   # NaN past the limit, as XLA
    else:
        assert torch.isfinite(cache.k.float()).all()


N, PS, MP = 12, 4, 5


@pytest.mark.parametrize("cast,compute", WRITE_CASES)
def test_page_writes_match_reference(monkeypatch, cast, compute):
    """A cast pool written by a splice of a cast prefill, a decode step, a
    chunk (with the staging buffers) and a fork, one-hot inputs and RoPE the
    identity: every page bit for bit against the reference's pool."""
    monkeypatch.setattr(RA, "apply_rope", lambda x, positions, theta: x)
    monkeypatch.setattr(A, "apply_rope", lambda x, positions, theta: x)
    rcfg, cfg, p_ref, attn = _layer(compute, 24)
    rcfg, cfg = _with_cast(rcfg, cast), _with_cast(cfg, cast)
    rng = np.random.default_rng(12)
    B, S, D = 2, 8, cfg.d_model
    ref_pool = RA.paged_pool_init(N, PS, rcfg, stage_rows=B, stage_len=16)
    pool = A.paged_pool_init(N, PS, cfg, "cpu", stage_rows=B, stage_len=16)
    assert pool.k.dtype == getattr(torch, cast) and pool.qk is None
    xj, xt = _one_hot(rng, (B, S), D, compute)
    _, rc = RA.attn_prefill(p_ref, xj, rcfg, S)
    cache = A.kv_cache_init(B, S, cfg, "cpu")
    A.attn_prefill(attn, xt, cfg, cache)
    page_idx = np.asarray([[3, 7], [0, N]], np.int32)   # row 1's second block dropped
    ref_pool = RA.paged_splice_prompt(ref_pool, rc, jnp.asarray(page_idx))
    A.paged_splice_prompt(pool, cache, torch.from_numpy(page_idx))
    bt = np.asarray([[3, 7, 5, -1, -1], [0, 9, -1, -1, -1]], np.int32)
    pos = np.asarray([8, 5], np.int32)
    xj, xt = _one_hot(rng, (B,), D, compute)
    _, ref_pool = RA.attn_decode_paged(p_ref, xj, ref_pool, jnp.asarray(bt), jnp.asarray(pos),
                                       rcfg)
    A.attn_decode_paged(attn, xt, pool, torch.from_numpy(bt), torch.from_numpy(pos), cfg)
    C = 4
    pos0, valid, base = (np.asarray(a, np.int32) for a in ([9, 6], [3, 2], [4, 0]))
    xj, xt = _one_hot(rng, (B, C), D, compute)
    _, ref_pool = RA.attn_chunk_paged(p_ref, xj, ref_pool, jnp.asarray(bt), jnp.asarray(pos0),
                                      jnp.asarray(valid), rcfg, base=jnp.asarray(base))
    tb, tp0, tv = map(torch.from_numpy, (bt, pos0, valid))
    A.attn_chunk_paged(attn, xt, pool, tb, tp0, tv, cfg, A.paged_chunk_targets(tb, tp0, tv, pool, C),
                       torch.from_numpy(base))
    src, dst = np.asarray([3, 7, 0], np.int32), np.asarray([10, 11, N], np.int32)
    ref_pool = RA.fork_pages(ref_pool, jnp.asarray(src), jnp.asarray(dst))
    A.fork_pages(pool, torch.from_numpy(src).long(), torch.from_numpy(dst).long())
    kn, vn = pool.regions()[:2]
    np.testing.assert_array_equal(_bytes(kn), _bytes(ref_pool.k))
    np.testing.assert_array_equal(_bytes(vn), _bytes(ref_pool.v))
    np.testing.assert_array_equal(_bytes(pool.stage_k[:, :16]), _bytes(ref_pool.stage_k))


# -------------------------------------------------------------- the reads
@pytest.mark.parametrize("cast,compute", [(c, "float32") for c in CASTS]
                         + [(c, "bfloat16") for c in ("float16", "float32", "float8_e4m3fn")])
def test_plain_cast_reads_match_reference(cast, compute):
    """K2q's, K3q's and K4p's unscaled plain versions (through ``ops``) on
    a cast ring and a cast pool against the reference's attention over the
    same stored values: each value rounded to the compute dtype
    (``astype(q.dtype)``), then the native einsum softmax. A float16 store
    under bf16 compute rounds twice."""
    rng = np.random.default_rng(3)
    B, L, KVH, G, hd = 3, 24, 2, 2, 32
    kf = (rng.standard_normal((B, L, KVH, hd)) * 4).astype(np.float32)
    vf = rng.standard_normal((B, L, KVH, hd)).astype(np.float32)
    k, v = jnp.asarray(kf).astype(cast), jnp.asarray(vf).astype(cast)
    q = jnp.asarray(rng.standard_normal((B, KVH * G, hd)).astype(np.float32)).astype(compute)
    pos = np.asarray([5, 23, 40], np.int32)
    sp = np.stack([np.where(np.arange(L) <= p % L, np.arange(L), -1) for p in pos[:2]]
                  + [40 - ((40 - np.arange(L)) % L)]).astype(np.int32)
    got = ops.decode_attention(_same_bits(q), _same_bits(k), _same_bits(v), torch.from_numpy(sp),
                               torch.from_numpy(pos))
    want = plain.decode_attention_ref(_same_bits(q), _same_bits(k.astype(compute)),
                                      _same_bits(v.astype(compute)), torch.from_numpy(sp),
                                      torch.from_numpy(pos))
    assert torch.equal(got, want)
    # the reference's attn_decode arithmetic on the same ring
    qg = q.reshape(B, KVH, G, hd)
    s = jnp.einsum("bkgh,blkh->bkgl", qg, k.astype(compute),
                   preferred_element_type=jnp.float32) * hd ** -0.5
    ok = (jnp.asarray(sp) >= 0) & (jnp.asarray(sp) <= jnp.asarray(pos)[:, None])
    p = jax.nn.softmax(jnp.where(ok[:, None, None], s, -1e30), axis=-1)
    rout = jnp.einsum("bkgl,blkh->bkgh", p.astype(compute), v.astype(compute)).reshape(q.shape)
    tol = 2e-6 if compute == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), np.asarray(rout, np.float32), atol=tol,
                               rtol=tol)
    # a cast pool: paged decode and the paged chunk read
    pages_k, pages_v = (t.reshape(B * L // 4, 4, KVH, hd) for t in (k, v))
    bt = np.arange(B * L // 4, dtype=np.int32).reshape(B, L // 4)
    pp = np.asarray([5, 23, 11], np.int32)
    got = ops.paged_decode_attention(_same_bits(q), _same_bits(pages_k), _same_bits(pages_v),
                                     torch.from_numpy(bt), torch.from_numpy(pp))
    want = ops.paged_decode_attention(_same_bits(q), _same_bits(pages_k.astype(compute)),
                                      _same_bits(pages_v.astype(compute)), torch.from_numpy(bt),
                                      torch.from_numpy(pp))
    assert torch.equal(got, want)
    C = 4
    qc = _same_bits(jnp.asarray(rng.standard_normal((B, C, KVH * G, hd)),
                                np.float32).astype(compute))
    p0, nv = torch.tensor([0, 8, 20], dtype=torch.int32), torch.tensor([4, 3, 0], dtype=torch.int32)
    got = ops.paged_chunk_attention(qc, _same_bits(pages_k), _same_bits(pages_v), None, None,
                                    None, None, torch.from_numpy(bt), p0, nv)
    want = ops.paged_chunk_attention(qc, _same_bits(pages_k.astype(compute)),
                                      _same_bits(pages_v.astype(compute)), None, None, None, None,
                                      torch.from_numpy(bt), p0, nv)
    assert torch.equal(got, want)


# -------------------------------------------------------------- the model
def test_f8_cache_decode_close():
    """tests/test_perf_knobs.py's check on the port: with
    ``cache_dtype="float8_e4m3fn"`` the ring holds fp8 and decoding a
    prompt token by token stays within 0.5 of the full forward's logits
    (quantization-level, not divergence), and within the same of the
    reference's own cast decode."""
    cfg = ref_get_config("granite-3-2b", smoke=True).replace(cache_dtype="float8_e4m3fn")
    params = ref_init_params(jax.random.PRNGKey(0), cfg)
    port = params_from_numpy(jax.tree.map(np.asarray, params),
                             get_config("granite-3-2b", smoke=True)
                             .replace(cache_dtype="float8_e4m3fn"), device="cpu")
    B, S, S0 = 2, 24, 16
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (B, S), 0, cfg.vocab_size),
                      np.int32)
    full, _ = ref_forward(params, {"tokens": jnp.asarray(toks)}, cfg)
    _, rs = RM.prefill(params, {"tokens": jnp.asarray(toks[:, :S0])}, cfg, cache_len=64)
    _, st = M.prefill(port, torch.from_numpy(toks[:, :S0]), 64)
    assert st.caches[0].k.dtype == torch.float8_e4m3fn
    errs, gaps = [], []
    for t in range(S0, S):
        rl, rs = RM.decode_step(params, rs, jnp.asarray(toks[:, t]), cfg)
        lg, st = M.decode_step(port, st, torch.from_numpy(toks[:, t]))
        errs.append(float((lg - torch.from_numpy(np.asarray(full[:, t]))).abs().max()))
        gaps.append(float(np.abs(lg.numpy() - np.asarray(rl)).max()))
    assert max(errs) < 0.5 and max(gaps) < 0.5
    assert not torch.isnan(st.caches[0].k.float()).any()


def test_decode_from_carried_cast_ring_matches_reference():
    """Both packages start from the reference's float16 ring (carried
    across with ``kv_cache_from_numpy``) and take four decode steps, one row
    wrapping the ring: logits within the native model tolerance, and the
    rows each step wrote equal as the two frameworks' K/V allow (a float16
    rounding apart at most)."""
    w = _weights()
    cfg = w["cfg"].replace(kv_precision="float16")
    toks = np.random.default_rng(1).integers(0, 256, (3, 16)).astype(np.int32)
    lens = np.asarray([16, 5, 9], np.int32)
    logits, rs = RM.prefill(w["params"], {"tokens": jnp.asarray(toks)}, cfg, 16,
                            prompt_lens=jnp.asarray(lens))
    leaves = {n: (None if a is None else np.asarray(a)) for n, a in rs.caches[0]._asdict().items()}
    state = M.DecodeState([kv_cache_from_numpy(**leaves, device="cpu")],
                          torch.from_numpy(np.array(rs.pos)),
                          torch.from_numpy(np.array(rs.last_tok)))
    assert state.caches[0].k.dtype == torch.float16
    nxt = torch.from_numpy(np.asarray(jnp.argmax(logits, -1)).astype(np.int32))
    for _ in range(4):
        rl, rs = RM.decode_step(w["params"], rs, jnp.asarray(nxt), cfg)
        got, state = M.decode_step(w["port"], state, nxt)
        np.testing.assert_allclose(got.numpy(), np.asarray(rl), atol=1e-4, rtol=1e-4)
        nxt = torch.from_numpy(np.asarray(jnp.argmax(rl, -1)).astype(np.int32))
    c, rc = state.caches[0], rs.caches[0]
    np.testing.assert_array_equal(c.slot_pos.numpy(), np.asarray(rc.slot_pos))
    np.testing.assert_allclose(c.k.float().numpy(), np.asarray(rc.k, np.float32), rtol=2 ** -10,
                               atol=0)


# ------------------------------------------------------------ the engines
def _cast_model(port, cast: str):
    """The port's model under the cast (a shallow copy with the cast config)."""
    model = copy.copy(port)
    model.cfg = _with_cast(port.cfg, cast)
    return model


def _dense(w, cast, **kw):
    base = dict(batch_slots=4, prompt_len=16, cache_len=64, **kw)
    return (Engine(_cast_model(w["port"], cast), EngineConfig(**base)),
            late_consume(RefEngine(_with_cast(w["cfg"], cast), w["params"],
                                   RefEngineConfig(**base))))


def _paged(w, cast, **kw):
    base = dict(prompt_len=16, cache_len=64, page_size=8, num_pages=32, max_active=6, **kw)
    return (PagedEngine(_cast_model(w["port"], cast), PagedEngineConfig(**base)),
            late_consume(RefPagedEngine(_with_cast(w["cfg"], cast), w["params"],
                                        RefPagedEngineConfig(**base))))


def _check(w, ours, ref, mode, cast, reqs, schedule):
    streams, retired, (served, finished) = drive(ours, mode, copy.deepcopy(reqs), schedule)
    want = drive(ref, mode, copy.deepcopy(reqs), schedule)
    assert served == finished == len(reqs)
    assert retired == want[1]
    assert ours.served_history == ref.served_history
    assert ours.decode_dispatches == ref.decode_dispatches
    assert ours.prefill_dispatches == ref.prefill_dispatches
    if mode in ("sync", "chunked"):
        assert ours.blocking_syncs == 0
    cmp = QuantMarginComparator(w["params"], w["cfg"], 64, MARGIN, "")
    cmp.cfg = _with_cast(w["cfg"], cast)   # the gap of the reference's own cast ring
    cmp.check({k: list(v) for k, v in streams.items()}, {k: list(v) for k, v in want[0].items()},
              {r.rid: r.tokens for r in reqs})
    return ours


@pytest.mark.parametrize("mode,prec", [("fused", "float16"), ("step", "float8_e4m3fn"),
                                       ("sync", "bfloat16"), ("chunked", "float8_e4m3fn"),
                                       ("fused", "float8_e4m3fn")])
def test_dense_cast_engine_matches_reference(mode, prec):
    """The dense engine's fused, legacy (``step``), sync-free and chunked
    loops over a cast ring on tests/test_differential.py's bursty workload,
    against the reference's (its early consume off, ROADMAP R5): streams
    (margin-aware, the gap the reference's own cast ring gives),
    retirement, per-slot served counts and dispatches."""
    w = _weights()
    reqs, schedule = make_workload(seed=0)
    ours, ref = _dense(w, prec, chunk_size=4 if mode == "chunked" else 0)
    ours = _check(w, ours, ref, mode, prec, reqs, schedule)
    c = ours.state.caches[0]
    assert c.k.dtype == getattr(torch, prec) and c.stage_k is not None


@pytest.mark.parametrize("mode,prec,shared", [("fused", "float16", True),
                                              ("sync", "float8_e4m3fn", False),
                                              ("chunked", "float16", True),
                                              ("chunked", "float8_e4m3fn", True)])
def test_paged_cast_engine_matches_reference(mode, prec, shared):
    """The paged engine's fused, sync-free and chunked loops over a cast
    pool (prefix sharing on the shared-prefix workload): streams,
    retirement, served counts, dispatches and the allocator's and prefix
    index's counters equal the reference's."""
    w = _weights()
    if shared:
        reqs, schedule = make_shared_workload(seed=23)
    else:
        reqs, schedule = make_workload(seed=0)
    ours, ref = _paged(w, prec, chunk_size=4 if mode == "chunked" else 0,
                       prefix_sharing=shared)
    ours = _check(w, ours, ref, mode, prec, reqs, schedule)
    c, rc = ours.counters(), ref.counters()
    del c["readback_waits"], rc["readback_waits"]
    assert c == rc
    if shared:
        assert c["prefix_hit_tokens"] > 0
    assert ours.pools[0].k.dtype == getattr(torch, prec) and ours.pools[0].qk is None
    ours.allocator.check()


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_sampled_cast_engine_matches_reference(kind):
    """Sampled and greedy requests (the SAMPLING_PRESETS cycle) on the
    fused loop over a float16 ring and a float16 pool."""
    w = _weights()
    reqs, schedule = make_workload(seed=41, sampling=True)
    mk = _dense if kind == "dense" else _paged
    ours, ref = mk(w, "float16")
    _match(ref, ours, "fused", reqs, schedule, w["params"], _with_cast(w["cfg"], "float16"))
