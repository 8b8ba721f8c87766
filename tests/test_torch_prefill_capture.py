"""The admission at a fixed shape, as its CUDA graph needs it (one graph
per loop and prompt bucket). The splice into the dense ring
(``engine._splice_many``: every prefill row gathered, selected where
admitted and scattered back to a distinct engine row) and into the page
pool (``attention.paged_splice_prompt``: every block written, the dropped
ones onto the scratch pages) must equal the host-listed writes the engine
made before bit for bit, in every leaf; the padded sync-free admission
(``_sync_admit`` over all B rows) and the padded sampling tables must equal
the k-row forms bit for bit; and every engine's admission must run as one
dispatch through the graph of its loop and bucket."""
import copy
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import attention as A
from repro_torch.models import init_params
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.runtime import (Engine, EngineConfig, PagedEngine, PagedEngineConfig,
                                 Request, SamplingParams, row_tables)
from repro_torch.runtime import engine as E
from test_torch_engine import one_torch_thread  # noqa: F401  (autouse fixture)

B, P, L = 4, 16, 32
_MODELS = {}


def _model(arch: str):
    if arch not in _MODELS:
        _MODELS[arch] = init_params(get_config(arch, smoke=True), seed=0, device="cpu")
    return _MODELS[arch]


def _table(slots, budgets=None):
    """The engine's (3, B) admission table for ``slots`` (``Engine._admission_table``)."""
    fake = types.SimpleNamespace(active=[None] * B)
    budgets = budgets if budgets is not None else [3] * len(slots)
    return torch.from_numpy(Engine._admission_table(fake, list(slots), list(budgets)))


# ------------------------------------------------------------ dense splice
def _listed_splice(state, new, slots: np.ndarray):
    """The splice the fixed shape replaced, op for op: the admitted rows
    listed on the host (pad rows carry the out-of-range slot B), one index
    copy, a scatter of the list."""
    rows = np.nonzero(slots < B)[0]
    idx = torch.from_numpy(np.stack([rows, slots[rows]]).astype(np.int64))
    src, dst = idx[0], idx[1]
    for big, nw in zip(state.caches, new.caches, strict=True):
        for a, b in zip(big, nw, strict=True):
            if a is not None:
                A.as_bytes(a)[:, dst] = A.as_bytes(b)[:, src]
    state.pos[dst] = new.pos[src]
    state.last_tok[dst] = new.last_tok[src]
    return state


def _leaves_equal(a_state, b_state):
    for ca, cb in zip(a_state.caches, b_state.caches, strict=True):
        for name, a, b in zip(type(ca)._fields, ca, cb, strict=True):
            if a is None:
                assert b is None, name
                continue
            assert torch.equal(A.as_bytes(a), A.as_bytes(b)), name
    assert torch.equal(a_state.pos, b_state.pos)
    assert torch.equal(a_state.last_tok, b_state.last_tok)


@pytest.mark.parametrize("slots", [[2], [3, 0], [1, 3, 0, 2]], ids=["k1", "k2", "kB"])
@pytest.mark.parametrize("arch,kv", [("granite-3-2b", "native"), ("granite-3-2b", "int8"),
                                     ("granite-3-2b", "fp8"), ("mamba2-130m", None)])
def test_fixed_splice_equals_listed(arch, kv, slots):
    model = _model(arch)
    rng = np.random.default_rng(len(slots))
    V = model.cfg.vocab_size
    ragged = arch != "mamba2-130m"
    kw = dict(kv_precision=kv) if kv else {}
    _, state = M.prefill(model, torch.from_numpy(rng.integers(0, V, (B, P), dtype=np.int32)), L,
                         **kw)
    lens = torch.from_numpy(rng.integers(1, P + 1, B).astype(np.int32))
    _, new = M.prefill(model, torch.from_numpy(rng.integers(0, V, (B, P), dtype=np.int32)), L,
                       prompt_lens=lens if ragged else None, **kw)
    k = len(slots)
    host = np.full(B, B, np.int32)
    host[:k] = slots
    want = _listed_splice(copy.deepcopy(state), new, host)
    adm = _table(slots)
    got = E._splice_many(copy.deepcopy(state), new, adm[0], adm[2] > 0)
    _leaves_equal(got, want)
    # the admitted rows changed, the others kept the boot state's bytes
    for row in range(B):
        same = torch.equal(got.caches[0][0][:, row], state.caches[0][0][:, row])
        assert same == (row not in slots), row


def test_admission_table_targets_every_row_once():
    adm = _table([3, 1], [5, 2]).numpy()
    assert adm[0].tolist() == [3, 1, 0, 2]
    assert adm[1].tolist() == [5, 2, 0, 0] and adm[2].tolist() == [1, 1, 0, 0]
    assert sorted(_table([]).numpy()[0].tolist()) == list(range(B))


# ------------------------------------------------------------ paged splice
def _listed_paged_splice(pool, cache, page_idx: np.ndarray):
    """``paged_splice_prompt`` as it was: each region's listed blocks found
    with np.nonzero on the host, copied through an index list."""
    npp = page_idx.shape[1]
    ps = cache.k.shape[-3] // npp
    nn = pool.native_pages
    k_blocks = cache.k.unflatten(-3, (npp, ps))
    v_blocks = cache.v.unflatten(-3, (npp, ps))
    for quant, lo, hi in ((False, 0, nn), (True, nn, pool.num_pages)):
        rows, cols = np.nonzero((page_idx >= lo) & (page_idx < hi))
        if not len(rows):
            continue
        idx = torch.from_numpy(np.stack([rows, cols, page_idx[rows, cols] - lo]).astype(np.int64))
        kb = k_blocks[..., idx[0], idx[1], :, :, :]
        vb = v_blocks[..., idx[0], idx[1], :, :, :]
        if not quant:
            pool.k[..., idx[2], :, :, :] = kb.to(pool.k.dtype)
            pool.v[..., idx[2], :, :, :] = vb.to(pool.v.dtype)
        else:
            A._quant_write(A._pool_codes(pool), (slice(None),) * (pool.qk.dim() - 4) + (idx[2],),
                           kb, vb)


def _garbage(pools, rng):
    """Every leaf of the pools filled with random bytes of its dtype (finite
    floats), so a write to the wrong page shows."""
    for pool in pools:
        for t in pool:
            if t is None:
                continue
            if t.dtype in (torch.float32, torch.bfloat16):
                t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
            else:
                A.as_bytes(t).copy_(torch.from_numpy(rng.integers(0, 100, t.shape, dtype=np.uint8)
                                                     .astype(np.int64)).to(A.as_bytes(t).dtype))
    return pools


@pytest.mark.parametrize("prec,native_pages", [("native", None), ("int8", None), ("fp8", None),
                                               ("int8", 4)],
                         ids=["native", "int8", "fp8", "mixed"])
def test_fixed_paged_splice_equals_listed(prec, native_pages):
    model = _model("granite-3-2b")
    rng = np.random.default_rng(7)
    N, ps = 8, 4
    cfg = model.cfg.replace(kv_precision=prec)
    lens = np.asarray([7, 16, 12, 16], np.int32)
    _, dense = M.prefill(model, torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, P),
                                                              dtype=np.int32)), P,
                         prompt_lens=torch.from_numpy(lens))
    # row 0: blocks past its prompt; row 1: a pad row; row 2: its first
    # block held by a shared prefix page; row 3: pages of both regions of a
    # mixed pool
    page_idx = np.asarray([[5, 1, N, N], [N, N, N, N], [N, 7, 3, N], [0, 2, 6, 4]], np.int32)
    pools = _garbage(T.paged_pools_init(cfg, N, ps, "cpu", native_pages=native_pages), rng)
    want = copy.deepcopy(pools)
    for pool, cache in zip(want, dense.caches, strict=True):
        _listed_paged_splice(pool, cache, page_idx)
    got = M.paged_splice_prompt(copy.deepcopy(pools), dense.caches, torch.from_numpy(page_idx))
    for g, w in zip(got, want, strict=True):
        for a, b in zip(g.regions(), w.regions(), strict=True):
            if a is None:
                assert b is None
                continue
            assert torch.equal(A.as_bytes(a), A.as_bytes(b))
    # a host array gives the same pools
    again = M.paged_splice_prompt(copy.deepcopy(pools), dense.caches, page_idx)
    for g, h in zip(got, again, strict=True):
        assert all(a is None or torch.equal(A.as_bytes(a), A.as_bytes(b))
                   for a, b in zip(g, h, strict=True))


# --------------------------------------------------------- sync admission
def _k_row_admit(sync, logits, rows, budgets, eos, samp):
    """``_sync_admit`` as it was: the k admitted rows' logits and an index
    put per leaf."""
    first, fin = E._first_tokens(logits, budgets, eos, samp)
    return E.SyncState(
        cur_tok=sync.cur_tok.index_put((rows,), first),
        age=sync.age.index_put((rows,), torch.ones_like(first)),
        budget=sync.budget.index_put((rows,), budgets),
        done=sync.done.index_put((rows,), fin),
        gen_buf=sync.gen_buf.index_put((rows, torch.zeros_like(rows)), first))


PRESETS = (SamplingParams(temperature=0.7, top_k=8, seed=101),
           SamplingParams(temperature=1.2, top_p=0.85, seed=102),
           None,
           SamplingParams(temperature=0.9, top_k=12, repetition_penalty=1.3, seed=103))


def _tables(entries, rows):
    return row_tables(list(entries) + [None] * (rows - len(entries)), 5).to("cpu")


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("slots", [[2], [3, 0], [1, 3, 0, 2]], ids=["k1", "k2", "kB"])
def test_padded_sync_admit_equals_k_rows(slots, sampled):
    rng = np.random.default_rng(len(slots) + 10 * sampled)
    V, cap, k = 64, 6, len(slots)
    logits = torch.from_numpy(rng.standard_normal((B, V)).astype(np.float32))
    sync = E.SyncState(*(torch.from_numpy(a) for a in (
        rng.integers(0, V, B).astype(np.int32), rng.integers(0, 5, B).astype(np.int32),
        rng.integers(0, 5, B).astype(np.int32), rng.random(B) < 0.5,
        rng.integers(0, V, (B, cap)).astype(np.int32))))
    budgets = [1, 4, 3, 2][:k]
    eos = int(torch.argmax(logits[1]))   # some first token is EOS
    entries = [(p, 40 + j) if p is not None else None
               for j, p in enumerate(PRESETS[:k])] if sampled else []
    k_samp = _tables(entries, k) if sampled else None
    pad_samp = _tables(entries, B) if sampled else None
    want = _k_row_admit(copy.deepcopy(sync), logits[:k], torch.tensor(slots),
                        torch.tensor(budgets, dtype=torch.int32), eos, k_samp)
    adm = _table(slots, budgets)
    got = E._sync_admit(copy.deepcopy(sync), logits, adm[0], adm[1].to(torch.int32), adm[2] > 0,
                        eos, pad_samp)
    for name, a, b in zip(E.SyncState._fields, got, want, strict=True):
        assert torch.equal(a, b), name
    # the fused loop's first tokens: all B rows drawn, the first k read
    assert torch.equal(E._next_tokens(logits, pad_samp)[:k], E._next_tokens(logits[:k], k_samp))


def test_engine_pads_the_admission_tables_with_inert_rows():
    eng = Engine(_model("granite-3-2b"), EngineConfig(batch_slots=B, prompt_len=P, cache_len=L))
    reqs = [Request(rid=3, arrival_slot=0, tokens=np.arange(5, dtype=np.int32),
                    sampling=PRESETS[0])]
    tables = eng._samp_args(rows=reqs + [None] * (B - 1))
    assert all(len(t) == B for t in tables)
    assert tables[-1].tolist() == [False, True, True, True]   # greedy: the pad rows
    assert eng._samp_args(rows=[Request(rid=4, arrival_slot=0, tokens=np.arange(3))]) == ()
    assert len(eng._samp_args(True, [None] * B)) == len(tables)


# ---------------------------------------------------- one dispatch a bucket
def _count_admissions(eng):
    """Wrap the engine's graphed dispatches; returns the list of the
    admission modes run, one entry per dispatch."""
    modes, graphed = [], eng._graphed

    def counted(mode, key, *a, **kw):
        if "prefill" in mode:
            modes.append(mode)
            assert mode.endswith(f"/{key}")
        return graphed(mode, key, *a, **kw)
    eng._graphed = counted
    return modes


def _requests(seed, n, sampled=False):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, arrival_slot=0, tokens=rng.integers(0, 256, int(rng.integers(1, P + 1)),
                                                               dtype=np.int32),
                    max_new_tokens=int(rng.integers(1, 6)),
                    sampling=PRESETS[i % 2] if sampled and i % 3 == 0 else None)
            for i in range(n)]


@pytest.mark.parametrize("kind,step,prefix", [
    ("dense", "step_slot", "prefill"), ("dense", "step_slot_sync", "sync-prefill"),
    ("paged", "step_slot", "prefill"), ("paged", "step_slot_sync", "sync-prefill"),
    ("ssm", "step_slot", "prefill"), ("ssm", "step_slot_sync", "sync-prefill")])
def test_each_admission_is_one_dispatch_of_its_bucket_graph(kind, step, prefix):
    if kind == "paged":
        eng = PagedEngine(_model("granite-3-2b"), PagedEngineConfig(
            prompt_len=P, cache_len=64, page_size=4, num_pages=40, max_active=B))
    else:
        arch = "mamba2-130m" if kind == "ssm" else "granite-3-2b"
        eng = Engine(_model(arch), EngineConfig(batch_slots=B, prompt_len=P, cache_len=L))
    modes = _count_admissions(eng)
    reqs = _requests(3, 10, sampled=True)
    eng.submit(reqs)
    t = 0
    while len(eng.finished) < len(reqs) and t < 60:
        getattr(eng, step)(t, n_steps=2)
        t += 1
    if step == "step_slot_sync":
        eng.drain()
    assert len(eng.finished) == len(reqs)
    assert len(modes) == eng.prefill_dispatches > 1
    buckets = {int(m.split("/")[1]) for m in modes}
    assert {m.split("/")[0] for m in modes} <= {prefix, prefix + "+s"}
    assert prefix + "+s" in {m.split("/")[0] for m in modes}   # a sampled admission
    if kind == "ssm":
        assert buckets == {P}   # a recurrent stack prefills the whole prompt
    else:
        assert buckets <= set(eng._buckets) and len(buckets) > 1
