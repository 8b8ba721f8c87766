"""The CUDA kernels against their plain versions on the card.

Every test here is marked ``gpu`` and skips without a card (the kernels
have no CPU mode). This file imports no JAX, so it runs where only PyTorch
is installed:

  PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest`` because tests/conftest.py imports JAX to clear its caches).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import chunk_attention as k_chunk
from repro_torch.kernels import decode_attention as k_decode
from repro_torch.kernels import flash_attention as k_flash
from repro_torch.cache import parse_kv_precision
from repro_torch.kernels import paged_attention as k_paged
from repro_torch.kernels import paged_attention_quant as k_paged_quant
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as k_ssd
from repro_torch.kernels.quant import quantize_kv


def _ring(B, L, pos):
    """slot_pos of a ring cache at positions ``pos``: slot i holds the
    latest position p <= pos with p % L == i; row 0 has empty slots."""
    i = np.arange(L)[None, :]
    p = pos[:, None]
    sp = np.where(i <= p % L, p - p % L + i, p - p % L - L + i)
    sp = np.where(sp < 0, -1, sp).astype(np.int32)
    sp[0, L // 2:] = -1
    return sp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    # full float32 matmuls in the plain versions (this is also the default)
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# max |kernel - plain| per unit of max(1, max |plain|): f32 differs in
# summation order only; bf16 may differ by 2-4 units in the last place of
# the largest outputs (p and the output are rounded at other points)
GPU_TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -6}


def _err_ok(got, want, dtype):
    want = want.float()
    err = (got.float() - want).abs().max().item()
    return err <= GPU_TOL[dtype] * max(1.0, want.abs().max().item())


GPU_PREFILL = [(2, 16, 8, 2, 32), (8, 512, 32, 8, 64), (2, 100, 4, 4, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KVH,hd", GPU_PREFILL)
def test_flash_kernel_matches_plain_on_card(cuda, dtype, B, S, H, KVH, hd):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
               for s in ((B, S, H, hd), (B, S, KVH, hd), (B, S, KVH, hd)))
    lens = torch.randint(1, S + 1, (B,), generator=g, device=cuda, dtype=torch.int32)
    lens[0] = 1
    for seq_lens, window in ((None, None), (None, 37), (lens, None), (lens, 9)):
        got = k_flash.flash_attention(q, k, v, seq_lens, window=window)
        want = ref.attention_ref(q, k, v, window=window, seq_lens=seq_lens)
        torch.cuda.synchronize()
        assert _err_ok(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,H,KVH,hd", [(3, 64, 8, 2, 32), (8, 1024, 32, 8, 64),
                                          (2, 100, 8, 1, 128)])
def test_decode_kernel_matches_plain_on_card(cuda, dtype, B, L, H, KVH, hd):
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
               for s in ((B, H, hd), (B, L, KVH, hd), (B, L, KVH, hd)))
    pos_np = np.asarray([L // 2 - 1] + [L + 5 + 7 * b for b in range(1, B)], np.int32)
    sp = torch.from_numpy(_ring(B, L, pos_np)).to(cuda)
    pos = torch.from_numpy(pos_np).to(cuda)
    for window in (None, 50):
        got = k_decode.decode_attention(q, k, v, sp, pos, window=window)
        want = ref.decode_attention_ref(q, k, v, sp, pos, window=window)
        torch.cuda.synchronize()
        assert _err_ok(got, want, dtype)


def paged_case(rng, B, MP, ps, KVH, hd, pos, holes=False):
    """A pool of B * MP pages and block tables over a random permutation of
    it: row b holds the pages that cover positions 0..pos[b], then -1; a
    row with pos -1 is inactive (all -1). ``holes`` unallocates one page in
    the middle of row 1. Every pool row that no table reaches at or below
    its pos (free pages, rows past pos, the hole) holds garbage of +-1e30,
    as recycled pages would. Returns numpy (k, v, block_tables, pos)."""
    N = B * MP
    perm = rng.permutation(N).astype(np.int32)
    bt = np.full((B, MP), -1, np.int32)
    live = np.zeros((N, ps), bool)
    for b in range(B):
        n = pos[b] // ps + 1 if pos[b] >= 0 else 0
        bt[b, :n] = perm[b * MP: b * MP + n]
        if holes and b == 1 and n > 2:
            bt[b, n // 2] = -1
        for j in range(pos[b] + 1):
            if bt[b, j // ps] >= 0:
                live[bt[b, j // ps], j % ps] = True
    k = rng.standard_normal((N, ps, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((N, ps, KVH, hd)).astype(np.float32)
    junk = np.where(rng.random((N, ps, KVH, hd)) < 0.5, -1e30, 1e30).astype(np.float32)
    k = np.where(live[..., None, None], k, junk)
    v = np.where(live[..., None, None], v, -junk)
    return k, v, bt, np.maximum(pos, 0).astype(np.int32)


# (B, MP, ps, H, KVH, hd): the serving shape at three page sizes, a page
# larger than the kernel's 64-slot tile, a page size that is no power of
# two, and a group of one
GPU_PAGED = [(16, 64, 16, 32, 8, 64), (16, 128, 8, 32, 8, 64), (16, 32, 32, 32, 8, 64),
             (4, 3, 128, 8, 2, 32), (5, 9, 12, 8, 2, 128), (3, 8, 16, 4, 4, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,MP,ps,H,KVH,hd", GPU_PAGED)
def test_paged_kernel_matches_plain_on_card(cuda, dtype, B, MP, ps, H, KVH, hd):
    rng = np.random.default_rng(MP * ps + B)
    pos = rng.integers(min(128, MP * ps // 2), MP * ps, B).astype(np.int32)
    pos[0] = -1                       # an inactive row: all -1, no valid slot
    k, v, bt, pos = paged_case(rng, B, MP, ps, KVH, hd, pos, holes=True)
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32)).to(cuda, dtype)
    k, v = (torch.from_numpy(a).to(cuda, dtype) for a in (k, v))
    bt, pos_t = torch.from_numpy(bt).to(cuda), torch.from_numpy(pos).to(cuda)
    got = k_paged.paged_decode_attention(q, k, v, bt, pos_t)
    want = ref.paged_decode_attention_ref(q, k, v, bt, pos_t)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert not got[0].any()           # no valid slot: the kernel writes zeros
    assert _err_ok(got[1:], want[1:], dtype)


def chunk_case(rng, B, C, L, H, KVH, hd):
    """Rows cycle through: a first chunk (pos0 0), a mid-prompt chunk with
    a hole in its prefix, a partial final chunk (valid < C) and an inactive
    row (valid 0). Each row's cache holds positions 0..pos0+valid-1 in
    order (capped at L); slots beyond the written prefix, and the hole, are
    empty (slot_pos -1) and hold +-1e30 garbage. Numpy arrays."""
    pos0 = np.zeros(B, np.int32)
    valid = np.zeros(B, np.int32)
    sp = np.full((B, L), -1, np.int32)
    for b in range(B):
        kind = b % 4
        n = int(rng.integers(1, C + 1))
        p0 = 0 if kind == 0 else int(rng.integers(0, max(L - C, 0) + 1))
        valid[b] = {0: C, 1: C, 2: min(n, C - 1) if C > 1 else 1, 3: 0}[kind]
        pos0[b] = min(p0, L - max(valid[b], 1))
        end = pos0[b] + valid[b] if valid[b] else pos0[b]
        sp[b, :end] = np.arange(end)
        if kind == 1 and end > 2:
            sp[b, end // 2] = -1
    q = rng.standard_normal((B, C, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, L, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((B, L, KVH, hd)).astype(np.float32)
    junk = np.where(rng.random((B, L, KVH, hd)) < 0.5, -1e30, 1e30).astype(np.float32)
    empty = (sp < 0)[..., None, None]
    return q, np.where(empty, junk, k), np.where(empty, -junk, v), sp, pos0, valid


# (B, C, L, H, KVH, hd): the serving shape, C of 16/64/128 against L of 64
# and 1024, a ragged C, and a group of one
GPU_CHUNK = [(8, 128, 1024, 32, 8, 64), (8, 64, 1024, 32, 8, 64), (8, 16, 1024, 32, 8, 64),
             (4, 16, 64, 8, 2, 32), (4, 64, 64, 8, 2, 128), (5, 40, 100, 4, 4, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,L,H,KVH,hd", GPU_CHUNK)
def test_chunk_kernel_matches_plain_on_card(cuda, dtype, B, C, L, H, KVH, hd):
    rng = np.random.default_rng(C * L + B)
    arrs = chunk_case(rng, B, C, L, H, KVH, hd)
    q, k, v = (torch.from_numpy(a).to(cuda, dtype) for a in arrs[:3])
    sp, pos0, valid = (torch.from_numpy(a).to(cuda) for a in arrs[3:])
    got = k_chunk.chunk_attention(q, k, v, sp, pos0, valid)
    want = ref.chunk_attention_ref(q, k, v, sp, pos0, valid)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    for b, n in enumerate(arrs[5]):
        assert not got[b, n:].any()    # padding rows, and all of an inactive row
    assert _err_ok(got, want, dtype)


def quant_case(rng, B, MP, ps, KVH, hd, pool):
    """``paged_case`` with page-boundary positions (rows 1-3 at ps - 1, ps
    and 2 ps - 1 where the table allows), an inactive row 0, and the pool
    split into regions: ``pool`` "int8" or "fp8" quantizes every page,
    "mixed" keeps the lower half native and quantizes the rest to int8.
    Garbage rows quantize to codes of +-qmax with scales near 1e30 / qmax,
    so a read of one would show. Returns numpy (native k, v or None; codes
    k, v; scales k, v; block tables; pos) and the code precision."""
    pos = rng.integers(min(128, MP * ps // 2), MP * ps, B).astype(np.int32)
    for b, p in zip(range(1, min(B, 4)), (ps - 1, ps, 2 * ps - 1)):
        if p < MP * ps:
            pos[b] = p
    pos[0] = -1
    k, v, bt, pos = paged_case(rng, B, MP, ps, KVH, hd, pos, holes=True)
    prec = parse_kv_precision("fp8" if pool == "fp8" else "int8")
    Nn = k.shape[0] // 2 if pool == "mixed" else 0
    qk, ks = quantize_kv(torch.from_numpy(k[Nn:]), prec)
    qv, vs = quantize_kv(torch.from_numpy(v[Nn:]), prec)
    native = (k[:Nn], v[:Nn]) if Nn else (None, None)
    return (*native, qk, qv, ks, vs, bt, pos)


# (B, MP, ps, H, KVH, hd): the paged serve's shape, a page larger than the
# kernel's 64-slot tile, a page size that is no power of two with hd 128
GPU_QUANT = [(16, 64, 16, 32, 8, 64), (4, 3, 128, 8, 2, 32), (5, 9, 12, 8, 2, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["int8", "fp8", "mixed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,MP,ps,H,KVH,hd", GPU_QUANT)
def test_paged_quant_kernel_matches_plain_on_card(cuda, pool, dtype, B, MP, ps, H, KVH, hd):
    rng = np.random.default_rng(MP * ps + B + len(pool))
    k, v, qk, qv, ks, vs, bt, pos = quant_case(rng, B, MP, ps, KVH, hd, pool)
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32)).to(cuda, dtype)
    if k is not None:
        k, v = (torch.from_numpy(a).to(cuda, dtype) for a in (k, v))
    qk, qv, ks, vs = (t.to(cuda) for t in (qk, qv, ks, vs))
    bt, pos_t = torch.from_numpy(bt).to(cuda), torch.from_numpy(pos).to(cuda)
    got = k_paged_quant.paged_decode_attention_quant(q, k, v, qk, qv, ks, vs, bt, pos_t)
    if k is None:
        want = ref.paged_decode_attention_quant_ref(q, qk, qv, ks, vs, bt, pos_t)
    else:
        want = ref.paged_decode_attention_mixed_ref(q, k, v, qk, qv, ks, vs, bt, pos_t)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert not got[0].any()           # no valid slot: the kernel writes zeros
    assert _err_ok(got[1:], want[1:], dtype)


# K6 against its plain version, element by element, per unit of (env +
# |plain|) where env is the plain version run on |x|, |B|, |C| and |init|
# (the sum of the terms' magnitudes). In f32 the two sum dt*A over a chunk
# in other orders (the kernel in sequence, torch.cumsum by a scan), and exp
# turns the rounding of |LA| ~ 1e2-1e3 into relative errors of ~1e-5
# (chip_smoke.py's SSD_RTOL); bf16 x also because the plain version rounds
# the weights and the carried state's part to bf16 before the sum (2e-3 of
# env on the CPU at the full shape), the kernel only the output. Against the
# sequential ssd_ref the chunked form's f32 cumulative log-decay differs from
# the product of step decays (5e-5 of env between the plain version and
# ssd_ref on the CPU).
SSD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
SSD_REF_RTOL = 2e-4
# (B, S, H, P, N, chunk, init): the full mamba2-130m prefill, the smoke
# shape with a tail, a tail after several chunks from an initial state,
# chunk 32 with N 64
GPU_SSD = [(8, 512, 24, 64, 128, 128, False), (2, 40, 8, 32, 32, 16, False),
           (2, 300, 4, 64, 128, 128, True), (3, 100, 3, 32, 64, 32, True)]


def _ssd_case(cuda, seed, B, S, H, P, N, init):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((B, S, H, P), generator=g, device=cuda)
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=g, device=cuda))
    A = -torch.linspace(1.0, 16.0, H, device=cuda)
    Bm, Cm = (torch.randn((B, S, N), generator=g, device=cuda) for _ in range(2))
    st = 0.5 * torch.randn((B, H, P, N), generator=g, device=cuda) if init else None
    return x, dt, A, Bm, Cm, st


def _ssd_ok(got, want, env, rtol):
    err = (got.float() - want.float()).abs()
    return bool((err <= rtol * (env.float() + want.float().abs())).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N,chunk,init", GPU_SSD)
def test_ssd_kernel_matches_plain_on_card(cuda, dtype, B, S, H, P, N, chunk, init):
    x, dt, A, Bm, Cm, st = _ssd_case(cuda, S + N, B, S, H, P, N, init)
    x = x.to(dtype)
    k_ssd.launches["ssd_scan"] = 0
    y, fin = k_ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, init_state=st)
    ry, rfin = ref.ssd_chunked(x, dt, A, Bm, Cm, chunk, st)
    ey, efin = ref.ssd_chunked(x.abs(), dt, A, Bm.abs(), Cm.abs(), chunk,
                               None if st is None else st.abs())
    torch.cuda.synchronize()
    assert k_ssd.launches["ssd_scan"] == 1
    assert y.dtype == dtype and fin.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(fin).all()
    assert _ssd_ok(y, ry, ey, SSD_RTOL[dtype])
    assert _ssd_ok(fin, rfin, efin, SSD_RTOL[torch.float32])
    if dtype == torch.float32 and not init:
        oy, ofin = ref.ssd_ref(x, dt, A, Bm, Cm)
        torch.cuda.synchronize()
        assert _ssd_ok(y, oy, ey, SSD_REF_RTOL)
        assert _ssd_ok(fin, ofin, efin, SSD_REF_RTOL)


@pytest.mark.gpu
def test_ssd_kernel_refuses_what_it_does_not_take(cuda):
    x, dt, A, Bm, Cm, _ = _ssd_case(cuda, 0, 1, 32, 2, 32, 32, False)
    with pytest.raises(ValueError, match="float32"):
        k_ssd.ssd_scan(x, dt, A, Bm.bfloat16(), Cm, chunk=16)
    with pytest.raises(ValueError, match="chunk"):
        k_ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=48)
    with pytest.raises(ValueError, match="contiguous"):
        k_ssd.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A, Bm, Cm, chunk=16)
    with pytest.raises(RuntimeError, match="cudaError_t"):   # beyond a CTA's shared memory
        k_ssd.ssd_scan(torch.zeros((1, 8, 1, 256), device=cuda), dt[:, :8, :1].contiguous(), A[:1],
                       torch.zeros((1, 8, 256), device=cuda), torch.zeros((1, 8, 256), device=cuda),
                       chunk=128)
