"""The dense chunk writes at a fixed shape, as the chunked loops' CUDA
graph needs them: every (row, column) pair of the chunk gathered, the new
K/V selected where the column is valid and the whole block scattered back
(``attention.chunk_write_targets``/``_masked_put``). They must equal the
host-listed writes the engine made before (the valid pairs listed on the
host, one pinned copy, a scatter of the list) bit for bit, in every leaf
of the ring and in ``chunk_step``'s logits; and the engines' chunked loops
must run their mixed dispatch through the "chunk" graph and a slot with no
chunk through the "sync" graph."""
import copy
from typing import NamedTuple

import numpy as np
import pytest
import torch

from repro_torch import kernels  # noqa: F401  (the ops the attention calls)
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import init_params
from repro_torch.models import model as M
from repro_torch.runtime import (Engine, EngineConfig, PagedEngine, PagedEngineConfig,
                                 RequestSource)
from test_torch_engine import one_torch_thread  # noqa: F401  (autouse fixture)

B, P, L, C = 4, 16, 32, 8
# (pos0, valid, reset) per chunk over four rows: row 0 a prompt in three
# full chunks; row 1 one partial chunk, then idle (valid 0); row 2 idle,
# then a new tenant over the boot prefill's ring (reset) in partial chunks;
# row 3 a chunk that wraps the ring (positions 28..35 of a 32-slot ring)
CHUNKS = [([0, 0, 0, 28], [8, 5, 0, 8], [1, 1, 0, 0]),
          ([8, 5, 0, 36], [8, 0, 7, 3], [0, 0, 1, 0]),
          ([16, 5, 7, 39], [8, 0, 6, 0], [0, 0, 0, 0])]
# chunks of 40 columns, wider than the 32-slot ring: row 0 a prompt of 32
# in one chunk, row 1 one that wraps (positions 20..51), row 2 idle, row 3
# a new tenant in two partial chunks
WIDE = [([0, 20, 0, 0], [32, 32, 0, 7], [1, 0, 0, 1]),
        ([32, 52, 0, 7], [0, 0, 0, 9], [0, 0, 0, 0])]


class _Listed(NamedTuple):
    rows: torch.Tensor
    cols: torch.Tensor
    slots: torch.Tensor
    pos: torch.Tensor


def _listed_targets(pos0, valid, C, cache_len):
    """The valid (row, column) pairs listed on the host, as the engine
    listed them before the writes took a fixed shape."""
    valid = valid.numpy().astype(np.int64)
    rows = np.repeat(np.arange(len(valid)), valid)
    cols = np.arange(len(rows)) - np.repeat(np.cumsum(valid) - valid, valid)
    pos = pos0.numpy().astype(np.int64)[rows] + cols
    idx = torch.from_numpy(np.stack([rows, cols, pos % cache_len, pos]))
    return _Listed(idx[0], idx[1], idx[2], idx[3].to(torch.int32))


def _listed_attn_chunk(p, x, cache, pos0, valid, cfg, writes, *, reset=None):
    """``attn_chunk`` with the host-listed writes: the code the fixed-shape
    form replaced, op for op."""
    Bx, Cx, _ = x.shape
    q, k, v = p.qkv(x, cfg)
    pos = pos0[:, None] + torch.arange(Cx, device=x.device)[None, :]
    q = A.apply_rope(q, pos, cfg.rope_theta)
    k = A.apply_rope(k, pos, cfg.rope_theta)
    if reset is not None:
        cache.slot_pos.masked_fill_(reset[:, None], -1)
    kc, vc = k[writes.rows, writes.cols], v[writes.rows, writes.cols]
    if cache.k_scale is not None:
        A._quant_write(A._ring_codes(cache), (writes.rows, writes.slots), kc, vc)
    else:
        cache.k[writes.rows, writes.slots] = kc.to(cache.k.dtype)
        cache.v[writes.rows, writes.slots] = vc.to(cache.v.dtype)
    cache.slot_pos[writes.rows, writes.slots] = writes.pos
    if cache.stage_k is None:
        return p.out(ops.chunk_attention(q, cache.k, cache.v, cache.slot_pos, pos0, valid))
    cache.stage_k[writes.rows, writes.slots] = kc.to(cache.stage_k.dtype)
    cache.stage_v[writes.rows, writes.slots] = vc.to(cache.stage_v.dtype)
    causal = torch.arange(cache.cache_len, dtype=torch.int32).repeat(Bx, 1)
    return p.out(ops.chunk_attention(q, cache.stage_k, cache.stage_v, causal, pos0, valid))


def _run_chunks(model, state, listed: bool, monkeypatch, chunks=CHUNKS, C=C):
    rng = np.random.default_rng(3)
    out = []
    with monkeypatch.context() as mp:
        if listed:
            mp.setattr(A, "chunk_write_targets", _listed_targets)
            mp.setattr(A, "attn_chunk", _listed_attn_chunk)
        for pos0, valid, reset in chunks:
            toks = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, (B, C), dtype=np.int32))
            logits, state = M.chunk_step(model, state, toks, torch.tensor(pos0, dtype=torch.int32),
                                         torch.tensor(valid, dtype=torch.int32),
                                         torch.tensor(reset, dtype=torch.bool))
            out.append(logits.clone())
    return out, state


def _fixed_and_listed(kv, monkeypatch, chunks=CHUNKS, C=C):
    """The fixed-shape and the host-listed writes over the same chunks;
    asserts they agree bit for bit and returns (state before, state after)."""
    model = init_params(get_config("granite-3-2b", smoke=True), seed=0, device="cpu")
    boot = torch.from_numpy(np.random.default_rng(1).integers(
        0, model.cfg.vocab_size, (B, P), dtype=np.int32))
    _, state = M.prefill(model, boot, L, kv_precision=kv)
    assert (state.caches[0].stage_k is not None) == (kv != "native")
    got, fixed = _run_chunks(model, copy.deepcopy(state), False, monkeypatch, chunks, C)
    want, listed = _run_chunks(model, copy.deepcopy(state), True, monkeypatch, chunks, C)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)
    assert torch.equal(fixed.pos, listed.pos) and torch.equal(fixed.last_tok, listed.last_tok)
    for name, a, b in zip(A.KVCache._fields, fixed.caches[0], listed.caches[0], strict=True):
        if a is None:
            assert b is None, name
            continue
        assert torch.equal(A.as_bytes(a), A.as_bytes(b)), name
    return state, fixed


@pytest.mark.parametrize("kv", ["native", "int8", "fp8"])
def test_fixed_shape_chunk_writes_equal_the_host_listed_writes(kv, monkeypatch):
    state, fixed = _fixed_and_listed(kv, monkeypatch)
    # the chunks wrote something, and the wrapping row reached slot 0 again
    assert not torch.equal(A.as_bytes(fixed.caches[0].k), A.as_bytes(state.caches[0].k))
    assert fixed.caches[0].slot_pos[:, 3, 0].unique().tolist() == [32]


@pytest.mark.parametrize("kv", ["native", "fp8"])
def test_a_chunk_wider_than_the_ring_equals_the_host_listed_writes(kv, monkeypatch):
    """C = 40 over a ring of 32: each row has one target per ring slot, so
    no scatter index repeats, and the valid columns land as listed."""
    _, fixed = _fixed_and_listed(kv, monkeypatch, WIDE, 40)
    # row 1's chunk wrapped: slots 0..19 hold positions 32..51
    assert fixed.caches[0].slot_pos[:, 1, :20].unique(dim=0).tolist() == [list(range(32, 52))]


def test_masked_put_keeps_the_old_values_where_invalid():
    t = torch.arange(12, dtype=torch.float32).reshape(2, 6)
    at = (torch.arange(2)[:, None], torch.tensor([[4, 5, 0], [1, 2, 3]]))
    A._masked_put(t, at, torch.full((2, 3), -1.0), torch.tensor([[1, 1, 0], [0, 1, 0]]) > 0)
    assert t.tolist() == [[0, 1, 2, 3, -1, -1], [6, 7, -1, 9, 10, 11]]
    codes = torch.zeros(1, 4, dtype=torch.float8_e4m3fn)
    A._masked_put(codes, (torch.zeros(1, 2, dtype=torch.long), torch.tensor([[1, 3]])),
                  torch.full((1, 2), 2.0).to(torch.float8_e4m3fn), torch.tensor([[True, False]]))
    assert codes.float().tolist() == [[0.0, 2.0, 0.0, 0.0]]


@pytest.mark.parametrize("paged", [False, True])
def test_chunked_loop_runs_its_chunk_and_decode_graphs(paged):
    """On the CPU the graphs run their bodies eagerly: a slot with chunks
    goes through the "chunk" graph and a slot without one through the
    "sync" graph; warm_decode has nothing to capture here."""
    cfg = get_config("granite-3-2b", smoke=True)
    model = init_params(cfg, seed=0, device="cpu")
    if paged:
        eng = PagedEngine(model, PagedEngineConfig(prompt_len=16, cache_len=64, page_size=8,
                                                   num_pages=24, max_active=4))
    else:
        eng = Engine(model, EngineConfig(batch_slots=4, prompt_len=16, cache_len=64))
    eng.warm_decode(2, chunked=True)
    assert not eng._graphs and eng.warmup_dispatches == 0
    eng.submit(RequestSource(vocab_size=cfg.vocab_size, prompt_len=16, raw_rate=3,
                             max_new_tokens=8, seed=2).poll(0, 3.0))
    seen = []
    run = eng._chunk_decode_sync
    eng._chunk_decode_sync = lambda plan, n, **kw: (seen.append(len(plan["plan"])),
                                                    run(plan, n, **kw))[1]
    for t in range(10):
        eng.step_slot_chunked(t, n_steps=2)
    eng.drain()
    assert set(eng._graphs) == {"chunk", "sync"} and eng.graph_replays == 0
    # three prompts of 16 claimed in slot 0, their chunks (4 dense, 8 paged:
    # whole pages) run side by side, one mixed dispatch each
    assert seen == [3] * (16 // eng._chunk)
    assert eng.decode_dispatches > len(seen)
    assert len(eng.finished) == 3
    assert all(len(r.generated) == 8 for r in eng.finished)
