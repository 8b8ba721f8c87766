"""Per-request sampling in the port (``repro_torch.runtime.sampling``)
against the reference's (``repro.runtime.sampling``).

The port computes JAX's threefry-2x32 itself (``runtime/threefry.py``), so
keys and random bits must equal ``jax.random``'s exactly; the Gumbel noise
is two logs of those bits, each within an ulp of XLA's. ``sample_rows``
must give the reference's tokens on the same logits, tables, ages and
history, except at a near-tie: where the reference's top-2 perturbed
scores lie within ``SCORE_TIE`` of each other, or the top-p boundary's
``cum - probs`` within ``BOUNDARY_TIE`` of ``top_p``. Then the reference's
own contracts (tests/test_sampling.py) on the port, and the engines: a
mixed batch of sampled and greedy requests served by every loop of both
engines against the reference's engines on the same weights, streams under
a margin-aware comparator, and the launcher's lines with sampling flags."""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import init_params as ref_init_params
from repro.models import model as RM
from repro.runtime import Engine as RefEngine
from repro.runtime import EngineConfig as RefEngineConfig
from repro.runtime import PagedEngine as RefPagedEngine
from repro.runtime import PagedEngineConfig as RefPagedEngineConfig
from repro.runtime import sampling as RS
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime import (Engine, EngineConfig, PagedEngine, PagedEngineConfig, Request,
                                 SamplingParams)
from repro_torch.runtime import sampling as S
from repro_torch.runtime import threefry as tf
from test_differential import drive, make_workload
from test_torch_chunked import _launch_late, late_consume
from test_torch_engine import _weights, one_torch_thread  # noqa: F401  (autouse fixture)

SCORE_TIE, BOUNDARY_TIE = 1e-5, 1e-6
# engine streams: the port's logits leave the reference's by float32 noise
# (test_torch_engine's MARGIN), so a draw may part where the reference's
# perturbed scores or top-p boundary lie within it
STREAM_TIE = 1e-4
TINY = np.finfo(np.float32).tiny
V_FULL = 49155   # granite-3-2b's vocabulary


def _ref_keys(seeds, rids, ages):
    key = jax.vmap(lambda s, r, a: jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(s), r), a))(
        jnp.asarray(seeds, jnp.uint32), jnp.asarray(rids, jnp.int32),
        jnp.asarray(ages, jnp.int32))
    return key


def _port_keys(seeds, rids, ages):
    return tf.fold_in(tf.fold_in(tf.seed(torch.as_tensor(np.asarray(seeds, np.int64))),
                                 torch.as_tensor(np.asarray(rids, np.int64))),
                      torch.as_tensor(np.asarray(ages, np.int64)))


GRID = [(s, r, a) for s in (0, 7, 2**31 + 5, 2**32 - 1) for r in (0, 1, 977, 2**31 - 1)
        for a in (0, 1, 63, 4095)]


# ----------------------------------------------------------------- threefry
def test_installed_jax_draws_the_partitionable_threefry_bits():
    """The port implements the bits of jax_threefry_partitionable=True, the
    default of this jax; if the installed flag ever differs, every sampled
    comparison below would be against other bits."""
    assert bool(jax.config.jax_threefry_partitionable) is tf.PARTITIONABLE


def test_threefry_keys_and_bits_equal_jax_random():
    seeds, rids, ages = (np.asarray(x) for x in zip(*GRID))
    want = np.asarray(_ref_keys(seeds, rids, ages)).astype(np.int64)
    k1, k2 = _port_keys(seeds, rids, ages)
    np.testing.assert_array_equal(np.stack([k1.numpy(), k2.numpy()], 1), want)
    bits = jax.vmap(lambda k: jax.random.bits(k, (V_FULL,), jnp.uint32))(
        _ref_keys(seeds, rids, ages))
    np.testing.assert_array_equal(tf.random_bits((k1, k2), V_FULL).numpy(),
                                  np.asarray(bits).astype(np.int64))
    # the hash itself on words that reach every carry: the key schedule's
    # parity word and counters near 2**32
    x = torch.tensor([0, 1, 2**32 - 1, 0x1BD11BDA, 2**31], dtype=torch.int64)
    from jax._src import prng as jprng
    a, b = jprng.threefry_2x32(jnp.asarray([0xFFFFFFFF, 0x12345678], jnp.uint32),
                               jnp.asarray(np.concatenate([x.numpy(), x.numpy()[::-1]]),
                                           jnp.uint32)).reshape(2, -1)
    got = tf.threefry_2x32(torch.tensor(0xFFFFFFFF), torch.tensor(0x12345678), x, x.flip(0))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(a).astype(np.int64))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(b).astype(np.int64))


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_gumbel_noise_within_an_ulp_of_jax_random():
    """The uniform equals jax's bit for bit; each of the noise's two logs
    lies within an ulp of XLA's on the same input, so the noise lies within
    2 ulps of max(|g|, 1) of jax.random.gumbel's."""
    seeds, rids, ages = (np.asarray(x) for x in zip(*GRID[::5]))
    keys = _ref_keys(seeds, rids, ages)
    port = _port_keys(seeds, rids, ages)
    u = tf.uniform(port, V_FULL).numpy()
    want_u = jax.vmap(lambda k: jax.random.uniform(k, (V_FULL,), jnp.float32, minval=TINY,
                                                   maxval=1.0))(keys)
    np.testing.assert_array_equal(u, np.asarray(want_u))
    x = (-torch.log(torch.from_numpy(u))).numpy()
    assert _ulps(x, np.asarray(-jnp.log(u))).max() <= 1
    g = (-torch.log(torch.from_numpy(x))).numpy()
    assert _ulps(g, np.asarray(-jnp.log(x))).max() <= 1
    np.testing.assert_array_equal(g, tf.gumbel(port, V_FULL).numpy())
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (V_FULL,), jnp.float32))(keys))
    assert (np.abs(g - want) / np.spacing(np.maximum(np.abs(want), np.float32(1)))).max() <= 2


# -------------------------------------------------------------- sample_rows
def _params(rng, V):
    return dict(temperature=float(rng.choice([0.0, 1e-9, 0.5, 0.8, 1.0, 1.4])),
                top_k=int(rng.choice([0, 1, 5, 50, V + 3])),
                top_p=float(rng.choice([1.0, 0.95, 0.8, 0.5])),
                repetition_penalty=float(rng.choice([1.0, 1.1, 2.0])),
                presence_penalty=float(rng.choice([0.0, 0.5])),
                frequency_penalty=float(rng.choice([0.0, 0.3])),
                seed=int(rng.choice([1, 7, 2**32 - 3])))


def _ref_ties(logits, samp, ages, gen=None, gen_len=None, score_tie=SCORE_TIE,
              boundary_tie=BOUNDARY_TIE):
    """Rows where the reference's draw is a near-tie: its own steps
    (``RS.sample_rows``) up to the perturbed scores, a row marked when its
    top-2 scores (penalized logits on a greedy row) lie within
    ``score_tie`` or, under top-p, a prefix's ``cum - probs`` within
    ``boundary_tie`` of top_p."""
    B, V = logits.shape
    lg = jnp.asarray(logits, jnp.float32)
    if gen is not None:
        lg = RS._penalize(lg, samp, jnp.asarray(gen), jnp.asarray(gen_len))
    t = lg / jnp.maximum(samp.temp, RS.GREEDY_TEMP)[:, None]
    order = jnp.argsort(t, axis=-1, descending=True, stable=True)
    ranks = jnp.argsort(order, axis=-1)
    probs = jax.nn.softmax(jnp.take_along_axis(t, order, axis=-1), axis=-1)
    below = jnp.cumsum(probs, axis=-1) - probs
    p_cnt = jnp.where(samp.top_p >= 1.0, V, jnp.sum(below < samp.top_p[:, None], axis=-1))
    k_eff = jnp.where(samp.top_k > 0, jnp.minimum(samp.top_k, V), V)
    n_keep = jnp.maximum(jnp.minimum(k_eff, p_cnt), 1)
    t = jnp.where(ranks < n_keep[:, None], t, -1e30)
    noise = jax.vmap(lambda s, r, a: jax.random.gumbel(
        jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(s), r), a), (V,),
        jnp.float32))(samp.seed, samp.rid, jnp.asarray(ages, jnp.int32))
    scores = np.asarray(jnp.where(samp.greedy[:, None], lg, noise + t), np.float64)
    top2 = -np.sort(-scores, axis=-1)[:, :2]
    boundary = np.asarray((jnp.abs(below - samp.top_p[:, None]) < boundary_tie).any(-1)
                          & (samp.top_p < 1.0) & ~samp.greedy)
    return (top2[:, 0] - top2[:, 1] < score_tie) | boundary


def _both_tables(entries, default_seed=5):
    ref = RS.row_tables([None if e is None else (RS.SamplingParams(**e[0]), e[1])
                         for e in entries], default_seed)
    ours = S.row_tables([None if e is None else (S.SamplingParams(**e[0]), e[1])
                         for e in entries], default_seed).to("cpu")
    return ref, ours


@pytest.mark.parametrize("V,seed", [(512, 0), (512, 1), (4099, 2)])
@pytest.mark.parametrize("history", [False, True])
def test_sample_rows_matches_reference(V, seed, history):
    rng = np.random.default_rng(seed)
    B, cap = 96, 12
    entries = [None if i % 6 == 0 else (_params(rng, V), int(rng.integers(0, 2**31 - 1)))
               for i in range(B)]
    ref_samp, samp = _both_tables(entries)
    logits = (rng.standard_normal((B, V)) * rng.choice([1.0, 4.0])).astype(np.float32)
    logits[::7, 3] = logits[::7, 5]   # exact logit ties in some rows
    ages = rng.integers(0, cap + 1, B).astype(np.int32)
    gen = rng.integers(0, V, (B, cap)).astype(np.int32) if history else None
    args = (torch.from_numpy(gen), torch.from_numpy(ages)) if history else ()
    got = S.sample_rows(torch.from_numpy(logits), samp, torch.from_numpy(ages), *args).numpy()
    rargs = (jnp.asarray(gen), jnp.asarray(ages)) if history else ()
    want = np.asarray(RS.sample_rows(jnp.asarray(logits), ref_samp, jnp.asarray(ages), *rargs))
    ties = _ref_ties(logits, ref_samp, ages, gen, ages if history else None)
    differ = got != want
    assert not (differ & ~ties).any(), (np.nonzero(differ & ~ties), ties.sum())
    assert (~differ).sum() >= B - 2   # near-ties are rare
    assert got.dtype == np.int32


# ------------------------------------------- the reference's own contracts
@pytest.mark.parametrize("kw,msg", [
    (dict(temperature=-0.5), "temperature must be >= 0"),
    (dict(temperature=float("nan")), "temperature must be >= 0"),
    (dict(top_k=-1), "top_k must be >= 0"),
    (dict(top_p=0.0), "top_p must be in"),
    (dict(top_p=1.5), "top_p must be in"),
    (dict(repetition_penalty=0.0), "repetition_penalty must be > 0"),
])
def test_bad_params_rejected_at_construction(kw, msg):
    with pytest.raises(ValueError, match=msg):
        SamplingParams(**kw)


@pytest.mark.parametrize("temp", [0.0, 1e-9])
def test_temperature_zero_is_exact_greedy(temp):
    rng = np.random.default_rng(0)
    logits = torch.from_numpy((rng.normal(size=(3, 97)) * 1e4).astype(np.float32))
    p = SamplingParams(temperature=temp, seed=1)
    samp = S.row_tables([(p, r) for r in (5, 6, 7)], 0).to("cpu")
    out = S.sample_rows(logits, samp, torch.zeros(3, dtype=torch.int32))
    assert torch.equal(out, torch.argmax(logits, dim=-1).to(torch.int32))


def _draw_support(row, p, rid=9, n=300):
    samp = S.row_tables([(p, rid)] * n, 0).to("cpu")
    lg = torch.from_numpy(np.asarray(row, np.float32)).expand(n, len(row))
    return set(S.sample_rows(lg, samp, torch.arange(n, dtype=torch.int32)).tolist())


def test_topk_tied_logits_keeps_exactly_k():
    row = np.array([1, 1, 1, 1, 0, 0, 0, 0], np.float32)
    assert _draw_support(row, SamplingParams(temperature=1.0, top_k=2, seed=3)) == {0, 1}
    assert _draw_support(row, SamplingParams(temperature=1.0, top_k=5, seed=3)) == \
        {0, 1, 2, 3, 4}


def test_topk_tied_logits_batch():
    row = np.array([2, 2, 2, 0, 0, 0], np.float32)
    ks, reps = [1, 2, 4, 6], 200
    samp = S.row_tables([(SamplingParams(temperature=1.0, top_k=k, seed=7), 50 + i)
                         for i, k in enumerate(ks) for _ in range(reps)], 0).to("cpu")
    lg = torch.from_numpy(row).expand(len(ks) * reps, len(row))
    ages = torch.arange(reps, dtype=torch.int32).repeat(len(ks))
    out = S.sample_rows(lg, samp, ages).reshape(len(ks), reps)
    assert [set(r.tolist()) for r in out] == [{0}, {0, 1}, {0, 1, 2, 3}, set(range(6))]


def test_topk_beyond_vocab_clamps_to_full_vocab():
    row = np.random.default_rng(1).normal(size=32).astype(np.float32)
    lg = torch.from_numpy(row).expand(64, 32)
    ages = torch.arange(64, dtype=torch.int32)
    big = S.row_tables([(SamplingParams(temperature=0.8, top_k=10**6, seed=11), 9)] * 64, 0)
    off = S.row_tables([(SamplingParams(temperature=0.8, top_k=0, seed=11), 9)] * 64, 0)
    assert torch.equal(S.sample_rows(lg, big.to("cpu"), ages),
                       S.sample_rows(lg, off.to("cpu"), ages))


def test_penalties_read_generated_history():
    logits = np.zeros(16, np.float32)
    logits[5], logits[6] = 3.0, 2.5
    greedy = dict(temperature=0.0)
    assert S.sample_oracle(logits, SamplingParams(**greedy), 1, 0, 0) == 5
    p = SamplingParams(presence_penalty=1.0, **greedy)
    assert S.sample_oracle(logits, p, 1, 0, 1, history=[5]) == 6
    assert S.sample_oracle(logits, p, 1, 0, 1, history=[4]) == 5
    f = SamplingParams(frequency_penalty=0.3, **greedy)
    assert S.sample_oracle(logits, f, 1, 0, 2, history=[5]) == 5
    assert S.sample_oracle(logits, f, 1, 0, 3, history=[5, 5]) == 6
    r = SamplingParams(repetition_penalty=4.0, **greedy)
    assert S.sample_oracle(logits, r, 1, 0, 1, history=[5]) == 6


def test_draw_invariant_to_row_placement():
    rng = np.random.default_rng(2)
    row = rng.normal(size=64).astype(np.float32)
    p = SamplingParams(temperature=0.7, top_k=12, top_p=0.9, seed=13)
    want = S.sample_oracle(row, p, rid=42, default_seed=0, age=3)
    assert want == int(RS.sample_oracle(row, RS.SamplingParams(**dataclasses.asdict(p)),
                                        rid=42, default_seed=0, age=3))
    neighbors = [(SamplingParams(temperature=1.3, seed=1), 7), None,
                 (SamplingParams(temperature=0.0), 8)]
    for pos in range(4):
        resolved = neighbors[:pos] + [(p, 42)] + neighbors[pos:]
        lg = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32))
        lg[pos] = torch.from_numpy(row)
        out = S.sample_rows(lg, S.row_tables(resolved, 0).to("cpu"),
                            torch.full((4,), 3, dtype=torch.int32))
        assert int(out[pos]) == want


# ------------------------------------------------------------- the engines
def _port_request(r) -> Request:
    samp = None if r.sampling is None else SamplingParams(**dataclasses.asdict(r.sampling))
    return Request(rid=r.rid, arrival_slot=r.arrival_slot, tokens=r.tokens,
                   max_new_tokens=r.max_new_tokens, sampling=samp)


def _sampled_req(rid, toks, max_new, **kw):
    return Request(rid=rid, arrival_slot=0, tokens=np.asarray(toks, np.int32),
                   max_new_tokens=max_new, sampling=SamplingParams(**kw))


def _greedy_req(rid, toks, max_new=8):
    return Request(rid=rid, arrival_slot=0, tokens=np.asarray(toks, np.int32),
                   max_new_tokens=max_new)


def _dense(**kw):
    base = dict(batch_slots=4, prompt_len=16, cache_len=64)
    base.update(kw)
    return Engine(_weights()["port"], EngineConfig(**base))


def _run(eng, reqs, mode="sync", max_slots=80):
    eng.submit([copy.deepcopy(r) for r in reqs])
    step = {"sync": eng.step_slot_sync, "fused": eng.step_slot,
            "chunked": eng.step_slot_chunked}[mode]
    t = 0
    while len(eng.finished) < len(reqs) and t < max_slots:
        step(t, n_steps=2)
        t += 1
    if mode in ("sync", "chunked"):
        eng.drain()
    assert len(eng.finished) == len(reqs)
    return {r.rid: tuple(r.generated) for r in eng.finished}


def test_sampled_max_new_exceeds_history_cap_rejected():
    toks = np.arange(16, dtype=np.int32)
    req = _sampled_req(900, toks, max_new=9, temperature=0.8, seed=1)
    eng = _dense(gen_buf_len=8)
    eng.submit([copy.deepcopy(req)])
    with pytest.raises(ValueError, match="history capacity"):
        eng.step_slot(0)
    assert eng.pending and not eng.finished   # refused before it was popped
    paged = PagedEngine(_weights()["port"], PagedEngineConfig(
        prompt_len=16, cache_len=64, page_size=16, num_pages=16, max_active=4, gen_buf_len=8))
    paged.submit([copy.deepcopy(req)])
    with pytest.raises(ValueError, match="history capacity"):
        paged.step_slot(0)


def test_requests_sampled_counter():
    rng = np.random.default_rng(3)
    toks = lambda: rng.integers(0, 512, 16, dtype=np.int32)
    reqs = [_sampled_req(1, toks(), 4, temperature=0.8, seed=1), _greedy_req(2, toks(), 4),
            _sampled_req(3, toks(), 4, temperature=0.0)]   # temperature 0: greedy
    eng = _dense()
    _run(eng, reqs, mode="fused")
    assert eng.counters()["requests_sampled"] == 1
    assert "fused+s" in eng._graphs


def test_sampled_stream_survives_disruption():
    """One seeded sampled request gives one stream solo at row 0, packed at
    another row among greedy neighbors, and preempted and recomputed on a
    page-starved paged engine (its longer run extends the solo stream)."""
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, 512, 16, dtype=np.int32)
    skw = dict(temperature=0.9, top_k=8, seed=21)
    target = lambda max_new=12: _sampled_req(777, prompt, max_new, **skw)
    filler = lambda rid: _greedy_req(rid, rng.integers(0, 512, 16, dtype=np.int32), 12)

    ref = _run(_dense(), [target()], mode="sync")[777]
    assert len(ref) == 12
    eng = _dense()
    eng.submit([filler(1), filler(2), copy.deepcopy(target())])
    eng.step_slot_sync(0, n_steps=1)
    assert [r.rid if r is not None else None for r in eng.active].index(777) == 2
    t = 1
    while len(eng.finished) < 3 and t < 80:
        eng.step_slot_sync(t, n_steps=2)
        t += 1
    eng.drain()
    assert {r.rid: tuple(r.generated) for r in eng.finished}[777] == ref

    ref20 = _run(_dense(batch_slots=2), [target(20)], mode="fused")[777]
    assert ref20[:12] == ref
    comp = _sampled_req(778, rng.integers(0, 512, 16, dtype=np.int32), 20,
                        temperature=1.1, top_p=0.8, seed=4)
    for mode in ("fused", "chunked"):
        paged = PagedEngine(_weights()["port"], PagedEngineConfig(
            prompt_len=16, cache_len=64, page_size=16, num_pages=5, max_active=2,
            max_pages_per_req=3))
        got = _run(paged, [target(20), comp], mode=mode, max_slots=120)
        assert paged.preemptions > 0, mode
        assert got[777] == ref20, mode


class SampledComparator:
    """Sampled and greedy streams must be equal, except that they may part
    at a token where the reference's own draw was a near-tie: its
    perturbed scores (its logits at a full-sequence prefill over the prompt
    and the tokens before, the request's key at that age and its history)
    within ``tie`` of each other, or its top-p boundary within ``tie``."""

    def __init__(self, params, cfg, cache_len, tie, seed=0, default=None):
        self.params, self.cfg, self.cache_len, self.tie = params, cfg, cache_len, tie
        self.seed, self.default = seed, default

    def _near_tie(self, req, stream, d) -> bool:
        seq = np.concatenate([req.tokens, np.asarray(stream[:d], np.int32)])[None]
        logits, _ = RM.prefill(self.params, {"tokens": jnp.asarray(seq)}, self.cfg,
                               self.cache_len)
        p = req.sampling if req.sampling is not None else self.default
        entry = None if p is None or p.is_pure_greedy else (p, req.rid)
        samp = RS.row_tables([entry], self.seed)
        hist = np.asarray([stream[:d]], np.int32) if d else None
        return bool(_ref_ties(np.asarray(logits), samp, np.asarray([d], np.int32), hist,
                              np.asarray([d], np.int32) if d else None,
                              self.tie, self.tie)[0])

    def check(self, got: dict, want: dict, reqs: dict):
        assert got.keys() == want.keys()
        for rid, w in want.items():
            h = got[rid]
            d = next((i for i, (a, b) in enumerate(zip(h, w)) if a != b), None)
            if d is None:
                assert len(h) == len(w), rid
                continue
            assert self._near_tie(reqs[rid], w, d), (rid, d, h, w)


def _ref_engine(kind, mode, cfg, params, **kw):
    chunk = dict(chunk_size=4) if mode == "chunked" else {}
    if kind == "dense":
        eng = RefEngine(cfg, params, RefEngineConfig(batch_slots=4, prompt_len=16,
                                                     cache_len=64, **chunk, **kw))
    else:
        eng = RefPagedEngine(cfg, params, RefPagedEngineConfig(
            prompt_len=16, cache_len=64, page_size=8, num_pages=32, max_active=6, **chunk,
            **kw))
    return late_consume(eng)


def _port_engine(kind, mode, port, **kw):
    chunk = dict(chunk_size=4) if mode == "chunked" else {}
    if kind == "dense":
        return Engine(port, EngineConfig(batch_slots=4, prompt_len=16, cache_len=64, **chunk,
                                         **kw))
    return PagedEngine(port, PagedEngineConfig(prompt_len=16, cache_len=64, page_size=8,
                                               num_pages=32, max_active=6, **chunk, **kw))


def _match(ref_eng, eng, mode, ref_reqs, schedule, params, cfg, default=None):
    want, want_retired, _ = drive(ref_eng, mode, ref_reqs, schedule)
    port_schedule = [(t, [_port_request(r) for r in batch]) for t, batch in schedule]
    got, retired, (served, finished) = drive(eng, mode, [_port_request(r) for r in ref_reqs],
                                             port_schedule)
    assert served == finished == len(ref_reqs)
    assert retired == want_retired
    assert eng.served_history == ref_eng.served_history   # the trace, slot by slot
    assert eng.counters()["requests_sampled"] == ref_eng.counters()["requests_sampled"] > 0
    assert eng.decode_dispatches == ref_eng.decode_dispatches
    SampledComparator(params, cfg, 64, STREAM_TIE, default=default).check(
        got, want, {r.rid: r for r in ref_reqs})
    return got


@pytest.mark.parametrize("kind", ["dense", "paged"])
@pytest.mark.parametrize("mode", ["fused", "sync", "chunked"])
def test_sampled_engines_match_reference(kind, mode):
    """SAMPLING_PRESETS (temperature, top-k, top-p, the three penalties, a
    temperature-0 row) cycled by rid beside engine-default greedy rows, on a
    bursty ragged workload."""
    w = _weights()
    reqs, schedule = make_workload(seed=41, sampling=True)
    eng = _port_engine(kind, mode, w["port"])
    _match(_ref_engine(kind, mode, w["cfg"], w["params"]), eng, mode, reqs, schedule,
           w["params"], w["cfg"])
    # a batch mixing sampled and greedy rows ran the sampled graph of its mode
    sampled_mode = {"fused": "fused+s", "sync": "sync+s", "chunked": "chunk+s"}[mode]
    assert sampled_mode in eng._graphs
    if mode != "fused":
        assert eng.blocking_syncs == 0


def test_engine_default_sampling_matches_reference():
    """The engine-default SamplingParams (the launcher's flags) on the
    chunked loop: every request without its own params samples."""
    w = _weights()
    reqs, schedule = make_workload(seed=5)
    kw = dict(temperature=0.8, top_k=20, top_p=0.9, repetition_penalty=1.1, seed=7)
    eng = _port_engine("dense", "chunked", w["port"], sampling=SamplingParams(**kw))
    ref = _ref_engine("dense", "chunked", w["cfg"], w["params"],
                      sampling=RS.SamplingParams(**kw))
    _match(ref, eng, "chunked", reqs, schedule, w["params"], w["cfg"],
           default=RS.SamplingParams(**kw))
    assert set(eng._graphs) == {"chunk+s", "sync+s"}


def test_a_pure_greedy_engine_default_keeps_the_argmax_graphs():
    """An engine default that is pure greedy (temperature 0) resolves to no
    sampler, so its traffic runs the argmax graphs and counts no sampled
    request, as with no default at all."""
    reqs, schedule = make_workload(seed=9, n_reqs=6)
    port_reqs = [_port_request(r) for r in reqs]
    port_schedule = [(t, [_port_request(r) for r in b]) for t, b in schedule]
    engines = [_dense(sampling=SamplingParams(temperature=0.0, top_k=8)), _dense()]
    assert engines[0]._default_samp is None
    got = [drive(e, "sync", port_reqs, port_schedule)[0] for e in engines]
    assert got[0] == got[1]
    assert engines[0].requests_sampled == 0 and set(engines[0]._graphs) == {"sync"}


def test_mamba2_sampled_fused_matches_reference():
    arch = "mamba2-130m"
    cfg = ref_get_config(arch, smoke=True)
    params = ref_init_params(jax.random.PRNGKey(0), cfg)
    port = params_from_numpy(jax.tree.map(np.asarray, params), get_config(arch, smoke=True),
                             device="cpu")
    # prompts of the full bucket: a recurrent stack integrates pads (R7)
    reqs, schedule = make_workload(seed=43, n_reqs=8, min_prompt=16, sampling=True)
    _match(RefEngine(cfg, params, RefEngineConfig(batch_slots=4, prompt_len=16, cache_len=64)),
           Engine(port, EngineConfig(batch_slots=4, prompt_len=16, cache_len=64)), "fused",
           reqs, schedule, params, cfg)


def test_launcher_sampling_lines_match_reference():
    flags = ("--temperature", "0.8", "--top-k", "20", "--sampling-seed", "7")
    ours = _launch_late("repro_torch.launch.serve", "--device", "cpu", *flags)
    ref = _launch_late("repro.launch.serve", *flags)
    assert ours == ref
    assert ours[1] == ("sampling: temperature=0.8 top_k=20 top_p=1.0 rep_penalty=1.0 "
                       "seed=7 requests_sampled=24")
