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
from repro_torch.kernels import paged_chunk_attention as k_pchunk
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as k_rglru
from repro_torch.kernels import ssd_scan as k_ssd
from repro_torch.kernels.quant import dequantize_kv, quantize_kv
from repro_torch.models.attention import PagedKVPool, fork_pages


def _ring(B, L, pos, empty_row0=True):
    """slot_pos of a ring cache at positions ``pos``: slot i holds the
    latest position p <= pos with p % L == i (-1: none yet, so a row with
    pos < L has not wrapped); ``empty_row0`` also empties row 0's upper
    half."""
    i = np.arange(L)[None, :]
    p = pos[:, None]
    sp = np.where(i <= p % L, p - p % L + i, p - p % L - L + i)
    sp = np.where(sp < 0, -1, sp).astype(np.int32)
    if empty_row0:
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


# (B, Sq, Sk, H, KVH, hd): the smoke and main-path shapes, hd 128, Sq not a
# multiple of 64 with Sk above it and below it, and olmoe-1b-7b's admission
# (16 query heads on 16 KV heads, hd 128). bf16 runs the wgmma kernel at hd
# 32 and 64 and the wide route at hd 128, f32 the CUDA-core one. The wide
# route's cases: groups of 1 (q-tile pairs), 2 and 4 (head pairs) and 3 (odd:
# q-tile pairs); an odd count of q-tiles (Sq 320: the last pair's second
# tile past Sq); Sq 130, where a head pair and a q-tile pair end mid-tile;
# Sk above and below Sq; qwen3-8b's prefill (32 heads on 8).
GPU_PREFILL = [(2, 16, 16, 8, 2, 32), (8, 512, 512, 32, 8, 64), (2, 100, 100, 4, 4, 128),
               (4, 130, 200, 8, 2, 64), (4, 200, 77, 4, 2, 32), (4, 190, 190, 8, 4, 128),
               (8, 512, 512, 16, 16, 128), (2, 320, 320, 4, 4, 128), (2, 130, 130, 8, 4, 128),
               (2, 130, 200, 4, 4, 128), (2, 200, 77, 8, 2, 128), (2, 130, 130, 6, 2, 128),
               (8, 512, 512, 32, 8, 128)]


def _prefill_cases(cuda, g, B, Sq, Sk):
    """(seq_lens, window) pairs: dense and ragged (random lengths with a row
    of 1, and lengths 1, 63, 64 and 65 around the 64-row tile), without a
    window, with one inside a tile (9, 37) and with one that cuts a tile in
    two (96). A window over Sk < Sq would leave rows that see no key, which
    the kernel and the plain version do not average alike: those shapes run
    without one."""
    lens = torch.randint(1, Sq + 1, (B,), generator=g, device=cuda, dtype=torch.int32)
    lens[0] = 1
    edges = torch.tensor([(1, 63, 64, 65)[b % 4] for b in range(B)], dtype=torch.int32,
                         device=cuda).clamp(max=Sq)
    windows = (None, 37, 96) if Sk >= Sq else (None,)
    return [(sl, w) for sl in (None, lens, edges) for w in windows] + (
        [(lens, 9)] if Sk >= Sq else [])


def _assert_padding_zero(got, seq_lens):
    """Query rows at or beyond their row's length are written as zeros."""
    if seq_lens is not None:
        pad = torch.arange(got.shape[1], device=got.device)[None, :] >= seq_lens[:, None]
        assert not got[pad].any(), seq_lens


def _rising(x):
    """K rows (axis 1) scaled by 1, 2, 3, ... per 64-key tile: each later
    KV tile holds a new row maximum, so every tile rescales the output."""
    f = 1 + torch.arange(x.shape[1], device=x.device) // 64
    return x * f[None, :, None, None].to(x.dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,hd", GPU_PREFILL)
def test_flash_kernel_matches_plain_on_card(cuda, dtype, B, Sq, Sk, H, KVH, hd):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
               for s in ((B, Sq, H, hd), (B, Sk, KVH, hd), (B, Sk, KVH, hd)))
    cases = _prefill_cases(cuda, g, B, Sq, Sk)
    kr = _rising(k.float()).to(dtype)
    for kk, seq_lens, window in ([(k, sl, w) for sl, w in cases]
                                 + [(kr, sl, None) for sl in (None, cases[-1][0])]):
        got = k_flash.flash_attention(q, kk, v, seq_lens, window=window)
        want = ref.attention_ref(q, kk, v, window=window, seq_lens=seq_lens)
        torch.cuda.synchronize()
        assert _err_ok(got, want, dtype), (seq_lens, window, kk is kr)
        _assert_padding_zero(got, seq_lens)
    # deterministic: no atomics, no split across CTAs
    sl, w = cases[-1]
    first = k_flash.flash_attention(q, k, v, sl, window=w)
    assert torch.equal(first, k_flash.flash_attention(q, k, v, sl, window=w))


# (B, L, H, KVH, hd): one tile (seven ranks of the cluster idle), the
# serving shape, a ragged tail, eight tiles a rank (the two-stage ring
# turns), a group of 32 at hd 128, a group of one at hd 32 and olmoe-1b-7b's
# ring (a group of one at hd 128)
GPU_DECODE = [(3, 64, 8, 2, 32), (8, 1024, 32, 8, 64), (2, 100, 8, 1, 128),
              (6, 4096, 8, 2, 64), (3, 1024, 32, 1, 128), (6, 1024, 4, 4, 32),
              (8, 1024, 16, 16, 128)]

# positions where the split across the cluster has an edge: the first and
# second tile, rank 7's last tile and rank 0's second, the last slot of a
# ring of 1024, and of 4096
DECODE_EDGES = (63, 64, 511, 512, 1023, 4095)


def _junk_where_empty(rng, x, sp):
    """``x`` (B, L, KVH, hd) with +-1e30 in the slots that hold no position."""
    junk = np.where(rng.random(x.shape) < 0.5, -1e30, 1e30).astype(np.float32)
    return np.where((sp < 0)[..., None, None], junk, x)


# (B, Sq, Sk, H, KVH, hd) at recurrentgemma-2b's attention (10 query heads
# on one KV head, hd 256): its admission bucket, a ragged tile edge with Sk
# above Sq, and a prompt past its window of 2048; on the wide route also a
# group of 1 over an odd count of q-tiles, a group of 2 at Sq 130, Sk below
# Sq, and a group of 3
GPU_PREFILL_256 = [(8, 512, 512, 10, 1, 256), (2, 130, 200, 10, 1, 256),
                   (2, 2560, 2560, 10, 1, 256), (2, 320, 320, 2, 2, 256),
                   (2, 130, 130, 4, 2, 256), (2, 200, 77, 10, 1, 256), (1, 130, 130, 3, 1, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,hd", GPU_PREFILL_256)
def test_flash_kernel_at_hd256_matches_plain_on_card(cuda, dtype, B, Sq, Sk, H, KVH, hd):
    """K1 and K1r at hd 256 over native K/V: causal, windowed (inside a
    tile, across tiles, and recurrentgemma's 2048) and ragged, rising
    scores; bf16 on the wide route, f32 on the CUDA-core kernel (its tiles
    take 215,296 bytes of shared memory, inside a CTA's 232,448); two
    launches equal."""
    g = torch.Generator(device=cuda).manual_seed(256)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
               for s in ((B, Sq, H, hd), (B, Sk, KVH, hd), (B, Sk, KVH, hd)))
    cases = _prefill_cases(cuda, g, B, Sq, Sk)
    if Sq > 2048:   # past the window: dense, windowed, and ragged under the window
        lens = next(sl for sl, _ in cases if sl is not None)
        cases = [(None, None), (None, 2048), (lens, 2048)]
    kr = _rising(k.float()).to(dtype)
    for kk, seq_lens, window in ([(k, sl, w) for sl, w in cases]
                                 + [(kr, sl, None) for sl in (None, cases[-1][0])]):
        got = k_flash.flash_attention(q, kk, v, seq_lens, window=window)
        want = ref.attention_ref(q, kk, v, window=window, seq_lens=seq_lens)
        torch.cuda.synchronize()
        assert _err_ok(got, want, dtype), (seq_lens, window, kk is kr)
        _assert_padding_zero(got, seq_lens)
    sl, w = cases[-1]
    first = k_flash.flash_attention(q, k, v, sl, window=w)
    assert torch.equal(first, k_flash.flash_attention(q, k, v, sl, window=w))
    with pytest.raises(ValueError, match="hd in"):   # K1q stops at hd 128
        k_flash.flash_attention_quant(q, k.to(torch.int8), v.to(torch.int8),
                                      torch.ones((B, Sk, KVH), device=cuda),
                                      torch.ones((B, Sk, KVH), device=cuda))


@pytest.mark.gpu
def test_flash_route_is_the_one_the_header_states_on_card(cuda):
    """The built library takes, for every (q dtype, hd, quantized K/V), the
    route ``k_flash.route`` states (the table of csrc/flash_attention.cu's
    header), refuses what it refuses, and a launch counts under that
    route's counter."""
    for dtype in (torch.float32, torch.bfloat16):
        for hd in (16, 32, 64, 128, 256, 512):
            for quantized in (False, True):
                try:
                    want = k_flash.route(dtype, hd, quantized)
                except ValueError:
                    want = None
                assert k_flash.library_route(dtype, hd, quantized) == want, (dtype, hd,
                                                                              quantized)
                assert (k_flash.smem_bytes(hd, dtype, quantized) > 0) == (want is not None)
    g = torch.Generator(device=cuda).manual_seed(1)
    for hd, name in ((64, "flash_attention"), (128, "flash_attention_wide"),
                     (256, "flash_attention_wide")):
        q, k, v = (torch.randn((1, 70, 2, hd), generator=g, device=cuda).bfloat16()
                   for _ in range(3))
        lens = torch.tensor([33], dtype=torch.int32, device=cuda)
        for sl, counter in ((None, name), (lens, name + "_ragged")):
            before = dict(k_flash.launches)
            k_flash.flash_attention(q, k, v, sl)
            assert {c: n - before[c] for c, n in k_flash.launches.items()
                    if n != before[c]} == {counter: 1}
            assert k_flash.counter(torch.bfloat16, hd, sl is not None) == counter


# (B, S, H, KVH, hd, prefix_len, window) of K1 with the prefix-LM mask:
# paligemma-3b's admission (256 patches and a 512-token prompt, 8 heads on
# one KV head, hd 256: the wide route's head pairs), a prefix inside one
# q-tile, one past a tile's end, one past most of the sequence, a prefix
# with a window (the visible keys not contiguous), hd 128 with a group of 1
# (q-tile pairs), and hd 64 and 32 (the wgmma kernel; f32 the CUDA cores)
GPU_PREFIX = [(8, 768, 8, 1, 256, 256, None), (2, 200, 8, 1, 256, 40, None),
              (2, 200, 8, 1, 256, 100, 33), (2, 130, 2, 2, 128, 65, None),
              (2, 300, 4, 4, 128, 130, 64), (4, 200, 8, 2, 64, 70, None),
              (4, 200, 8, 2, 64, 190, 50), (2, 96, 4, 1, 32, 1, 9)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KVH,hd,prefix,window", GPU_PREFIX)
def test_flash_prefix_kernel_matches_plain_on_card(cuda, dtype, B, S, H, KVH, hd, prefix,
                                                   window):
    """K1 with ``prefix_len`` on every route (bf16: wide at hd 128 and 256,
    wgmma at 32 and 64; f32: the CUDA cores): key k is visible to query q if
    (k <= q, inside the window) or k < prefix_len; rising scores; its
    launches count under its route's counter; two launches equal."""
    g = torch.Generator(device=cuda).manual_seed(prefix)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
               for s in ((B, S, H, hd), (B, S, KVH, hd), (B, S, KVH, hd)))
    kr = _rising(k.float()).to(dtype)
    counter = k_flash.counter(dtype, hd)
    for kk in (k, kr):
        before = k_flash.launches[counter]
        got = k_flash.flash_attention(q, kk, v, window=window, prefix_len=prefix)
        want = ref.attention_ref(q, kk, v, window=window, prefix_len=prefix)
        torch.cuda.synchronize()
        assert _err_ok(got, want, dtype), (kk is kr,)
        assert k_flash.launches[counter] == before + 1
    # the prefix changes what every row before its end sees
    plain = k_flash.flash_attention(q, k, v, window=window)
    assert not torch.equal(plain[:, :prefix - 1], got[:, :prefix - 1]) or prefix == 1
    assert torch.equal(got, k_flash.flash_attention(q, kr, v, window=window, prefix_len=prefix))


# (B, Sq, Sk, H, KVH, hd) of K1 without the causal mask: seamless-m4t's
# encoder (1,024 frames, 16 heads on 16, hd 64) and its cross prefill (a
# 128-token prompt over the frames), Sk not a multiple of 64 above and
# below Sq, and the wide route (hd 128 and 256, both pairings)
GPU_NONCAUSAL = [(8, 1024, 1024, 16, 16, 64), (8, 128, 1024, 16, 16, 64),
                 (3, 100, 1000, 4, 4, 64), (3, 200, 77, 8, 2, 32), (2, 130, 200, 4, 4, 128),
                 (2, 190, 100, 8, 2, 128), (2, 130, 300, 8, 1, 256), (2, 70, 70, 3, 1, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,hd", GPU_NONCAUSAL)
def test_flash_non_causal_kernel_matches_plain_on_card(cuda, dtype, B, Sq, Sk, H, KVH, hd):
    """K1 with ``causal=False`` on every route, Sq = Sk and Sq != Sk;
    rising scores; its launches count under its route's counter."""
    g = torch.Generator(device=cuda).manual_seed(Sq + Sk)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
               for s in ((B, Sq, H, hd), (B, Sk, KVH, hd), (B, Sk, KVH, hd)))
    counter = k_flash.counter(dtype, hd)
    for kk in (k, _rising(k.float()).to(dtype)):
        before = k_flash.launches[counter]
        got = k_flash.flash_attention(q, kk, v, causal=False)
        want = ref.attention_ref(q, kk, v, causal=False)
        torch.cuda.synchronize()
        assert _err_ok(got, want, dtype)
        assert k_flash.launches[counter] == before + 1
    assert torch.equal(got, k_flash.flash_attention(q, kk, v, causal=False))


@pytest.mark.gpu
def test_flash_prefix_refuses_ragged_codes_and_non_causal_on_card(cuda):
    """The wrapper and the C entry point refuse a prefix with seq_lens or
    without the causal mask; ``ops`` refuses one over codes."""
    from repro_torch.kernels import ops
    q, k, v = (torch.randn((2, 64, 2, 64), device=cuda).bfloat16() for _ in range(3))
    lens = torch.tensor([64, 9], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="seq_lens"):
        k_flash.flash_attention(q, k, v, lens, prefix_len=4)
    with pytest.raises(ValueError, match="causal"):
        k_flash.flash_attention(q, k, v, causal=False, prefix_len=4)
    scale = torch.ones((2, 64, 2), device=cuda)
    with pytest.raises(ValueError, match="quantized"):
        ops.flash_attention(q, k.to(torch.int8), v.to(torch.int8), k_scale=scale,
                            v_scale=scale, prefix_len=4)
    out = torch.empty_like(q)
    for sl, causal in ((lens, 1), (None, 0)):
        err = k_flash._fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            None if sl is None else sl.data_ptr(), out.data_ptr(),
                            2, 64, 64, 2, 2, 64, causal, -1, 4, 1, 0.125,
                            torch.cuda.current_stream().cuda_stream)
        assert err != 0, (sl, causal)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,H,hd", [(8, 1024, 16, 64), (3, 32, 4, 32), (4, 1000, 8, 64)])
def test_decode_kernel_over_a_full_cross_cache_on_card(cuda, dtype, B, L, H, hd):
    """K2 as the encoder-decoder's cross-attention decode: a fixed cache of
    L encoder positions, every slot valid (slot s at position s, pos L - 1,
    no window), a group of one: seamless-m4t's (L 1,024, 16 on 16, hd 64),
    its smoke shape and an L that ends inside a tile."""
    g = torch.Generator(device=cuda).manual_seed(L)
    q = torch.randn((B, H, hd), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((B, L, H, hd), generator=g, device=cuda).to(dtype) for _ in range(2))
    sp = torch.arange(L, dtype=torch.int32, device=cuda).expand(B, L).contiguous()
    pos = torch.full((B,), L - 1, dtype=torch.int32, device=cuda)
    got = k_decode.decode_attention(q, k, v, sp, pos)
    want = torch.softmax(torch.einsum("bhd,blhd->bhl", q.float(), k.float()) * hd ** -0.5,
                         dim=-1).to(dtype).float()
    want = torch.einsum("bhl,blhd->bhd", want, v.float())
    torch.cuda.synchronize()
    assert _err_ok(got, want, dtype)
    assert _err_ok(got, ref.decode_attention_ref(q, k, v, sp, pos), dtype)


# split16's edges at hd 256 (32-slot tiles on 16 ranks): the end of tile 0
# and the start of tile 1, rank 15's first tile's last slot and rank 0's
# second tile's first, a position inside a tile, the last slot of a ring of
# 1024 and of 4096
HD256_EDGES = (31, 32, 511, 512, 530, 1023, 4095)
# (B, L): recurrentgemma-2b's serve ring, a 2,048-slot ring, a ring below
# one tile per rank, 16 tiles (one per rank) and 16 tiles and a slot (rank
# 0's second tile holds one slot)
HD256_RINGS = [(8, 1024), (3, 2048), (5, 100), (8, 512), (8, 513)]


def _hd256_rings(rng, B, L, dtype):
    """(label, pos, slot_pos) of the rings K2 and K2q are held on at hd 256:
    wrapped rows (row 0 half empty), rows at split16's edges, and rows with
    a single valid slot, each the last slot of a rank's last tile (rank 15's
    in row 0), per ``k_decode.route``."""
    rt = k_decode.route(dtype, 256)
    tile, split = rt["tile"], rt["split"]
    wrapped = np.asarray([L // 2 - 1] + [L + 5 + 7 * b for b in range(1, B)], np.int32)
    edges = np.asarray([min(HD256_EDGES[b % len(HD256_EDGES)], L - 1) for b in range(B)],
                       np.int32)
    ntiles = -(-L // tile)
    sp1 = np.full((B, L), -1, np.int32)
    one = np.zeros(B, np.int32)
    for b in range(B):
        rank = (split - 1 - b) % split
        last = [t for t in range(ntiles) if t % split == rank]
        slot = min(last[-1] * tile + tile - 1, L - 1) if last else L - 1
        one[b] = slot + (L if b % 2 else 0)   # odd rows: the ring's second lap
        sp1[b, slot] = one[b]
    yield "wrapped", wrapped, _ring(B, L, wrapped)
    yield "edges", edges, _ring(B, L, edges, empty_row0=False)
    yield "one valid slot", one, sp1


@pytest.mark.gpu
@pytest.mark.parametrize("H", [10, 8])
@pytest.mark.parametrize("B,L", HD256_RINGS)
def test_decode_kernel_at_hd256_matches_plain_on_card(cuda, B, L, H):
    """K2 at hd 256 on one KV head, recurrentgemma-2b's group of 10 and
    paligemma-3b's of 8, in bf16 (split16's warp pairs) and float32 (a warp
    per head): wrapped rings (row 0 half empty, a 2,048-slot ring written
    past its end), rows at split16's edges, rows with a single valid slot
    on a rank's last slot, windows that end inside a 32-slot tile, across
    the ranks' tiles and of 2048, rows with no valid slot (an empty ring,
    later positions only, all before the window: the mean of the ring's V),
    junk in empty slots; two launches equal."""
    KVH, hd = 1, 256
    for dtype in (torch.bfloat16, torch.float32):
        rng = np.random.default_rng(L + B + H)
        q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32)).to(cuda, dtype)
        for label, pos_np, sp_np in _hd256_rings(rng, B, L, dtype):
            k, v = (torch.from_numpy(_junk_where_empty(
                rng, rng.standard_normal((B, L, KVH, hd)).astype(np.float32), sp_np))
                .to(cuda, dtype) for _ in range(2))
            sp, pos = torch.from_numpy(sp_np).to(cuda), torch.from_numpy(pos_np).to(cuda)
            for window in (None, 45, 50, 200, 2048):
                got = k_decode.decode_attention(q, k, v, sp, pos, window=window)
                want = ref.decode_attention_ref(q, k, v, sp, pos, window=window)
                torch.cuda.synchronize()
                assert torch.isfinite(got).all(), (dtype, label, window)
                assert _err_ok(got, want, dtype), (dtype, label, pos_np, window)
            assert torch.equal(got, k_decode.decode_attention(q, k, v, sp, pos, window=window))
        # rows with no valid slot, over clean K/V offset by row
        i = np.arange(L)
        rows = [np.full(L, -1), i + 10, np.where(i <= L // 4, i, -1)]
        sp_np = np.stack([rows[b % 3] for b in range(B)]).astype(np.int32)
        pos_np = np.asarray([(L - 1, 5, L - 1)[b % 3] for b in range(B)], np.int32)
        k, v = (torch.from_numpy(rng.standard_normal((B, L, KVH, hd)).astype(np.float32))
                .to(cuda, dtype) for _ in range(2))
        v = v + torch.arange(B, device=cuda, dtype=dtype)[:, None, None, None]
        sp, pos = torch.from_numpy(sp_np).to(cuda), torch.from_numpy(pos_np).to(cuda)
        got = k_decode.decode_attention(q, k, v, sp, pos, window=50)
        want = ref.decode_attention_ref(q, k, v, sp, pos, window=50)
        torch.cuda.synchronize()
        for b in range(B):
            assert _err_ok(got[b], want[b], dtype), (dtype, b)
            assert _err_ok(got[b], v[b].float().mean(0).repeat_interleave(H // KVH, 0),
                           dtype), (dtype, b)


@pytest.mark.gpu
def test_decode_route_is_the_one_the_header_states_on_card(cuda):
    """The built library's geometry (tile, split, stages) is the one
    ``k_decode.route`` states (csrc/decode_core.cuh's table) at every hd and
    dtype, and it refuses what ``route`` refuses; split16 holds B 8 x one
    KV head in one wave in bf16 at recurrentgemma-2b's and paligemma-3b's
    groups, and at least one cluster in float32; a launch at hd 256 counts
    under K2's counter."""
    for dtype in (torch.float32, torch.bfloat16):
        for hd in (16, 32, 64, 96, 128, 256, 512):
            try:
                rt = k_decode.route(dtype, hd)
                want = {k: rt[k] for k in ("tile", "split", "stages")}
            except ValueError:
                want = None
            assert k_decode.library_route(dtype, hd) == want, (dtype, hd)
            assert (k_decode.smem_bytes(hd, 4, dtype) > 0) == (want is not None)
            assert (k_decode.cta_threads(hd, 4, dtype) > 0) == (want is not None)
    for G in (8, 10):
        assert k_decode.max_clusters(256, G, torch.bfloat16) >= 8, G
        assert k_decode.smem_bytes(256, G, torch.bfloat16) < 232448 // 2 - 1024, G
    for G in (1, 10, 32):
        assert k_decode.max_clusters(256, G, torch.float32) >= 1, G
        assert k_decode.smem_bytes(256, G, torch.float32) <= 232448, G
    g = torch.Generator(device=cuda).manual_seed(3)
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((2, 8, 256), generator=g, device=cuda).to(dtype)
        k, v = (torch.randn((2, 40, 1, 256), generator=g, device=cuda).to(dtype)
                for _ in range(2))
        sp = torch.arange(40, device=cuda, dtype=torch.int32).repeat(2, 1)
        pos = torch.tensor([39, 20], device=cuda, dtype=torch.int32)
        before = dict(k_decode.launches)
        k_decode.decode_attention(q, k, v, sp, pos)
        counter = k_decode.route(dtype, 256)["counter"]
        assert {c: n - before[c] for c, n in k_decode.launches.items()
                if n != before[c]} == {counter: 1}


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,R", [(8, 512, 2560), (2, 1, 128), (3, 77, 100), (1, 2049, 33),
                                   (3, 40, 20), (2, 5, 2560), (1, 512, 2560),
                                   (64, 96, 2560)])
@pytest.mark.parametrize("init", [False, True])
def test_rglru_scan_kernel_matches_plain_on_card(cuda, B, S, R, init):
    """K7 against its plain version, bit for bit: recurrentgemma-2b's
    admission shape, one step, channel counts that are no multiple of a
    CTA's 32 (20: below one CTA's tile), steps that are no multiple of a
    stage's 16 and below the ring's depth (5, 40), one batch row, and 64
    rows (5,120 CTAs: several waves); with and without h0. Both take exp,
    then round each step's product, then its sum; two launches equal."""
    g = torch.Generator(device=cuda).manual_seed(B * S + R)
    sp = torch.log1p(torch.exp(-torch.linspace(2.2, 6.9, R, device=cuda)))
    log_a = -8.0 * torch.rand((B, S, R), generator=g, device=cuda) * sp
    gated = 0.5 * torch.randn((B, S, R), generator=g, device=cuda)
    h0 = torch.randn((B, R), generator=g, device=cuda) if init else None
    got = k_rglru.rglru_scan(log_a, gated, h0)
    want = ref.rglru_scan_ref(log_a, gated, h0)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (got - want).abs().max().item()
    assert torch.equal(got, k_rglru.rglru_scan(log_a, gated, h0))


@pytest.mark.gpu
def test_rglru_scan_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros((2, 8, 64), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        k_rglru.rglru_scan(x.bfloat16(), x.bfloat16())
    with pytest.raises(ValueError, match="one \\(B, S, R\\) shape"):
        k_rglru.rglru_scan(x[:, :4], x)
    with pytest.raises(ValueError, match="h0 must be"):
        k_rglru.rglru_scan(x, x, torch.zeros((2, 32), device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        k_rglru.rglru_scan(x.transpose(1, 2).contiguous().transpose(1, 2), x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        k_rglru.rglru_scan(x.cpu(), x.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,H,KVH,hd", GPU_DECODE)
def test_decode_kernel_matches_plain_on_card(cuda, dtype, B, L, H, KVH, hd):
    """K2 against its plain version over wrapped rows (row 0 half empty)
    and over unwrapped rows at the split's edge positions (empty slots hold
    +-1e30), each without a window, with one inside a tile and with one
    that crosses the ranks' tiles; two launches equal bit for bit."""
    rng = np.random.default_rng(L + hd + H)
    wrapped = np.asarray([L // 2 - 1] + [L + 5 + 7 * b for b in range(1, B)], np.int32)
    edges = np.asarray([min(DECODE_EDGES[b % len(DECODE_EDGES)], L - 1) for b in range(B)],
                       np.int32)
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32)).to(cuda, dtype)
    for pos_np, sp_np in ((wrapped, _ring(B, L, wrapped)),
                          (edges, _ring(B, L, edges, empty_row0=False))):
        k, v = (torch.from_numpy(_junk_where_empty(
            rng, rng.standard_normal((B, L, KVH, hd)).astype(np.float32), sp_np)).to(cuda, dtype)
            for _ in range(2))
        sp, pos = torch.from_numpy(sp_np).to(cuda), torch.from_numpy(pos_np).to(cuda)
        for window in (None, 50, 200):
            got = k_decode.decode_attention(q, k, v, sp, pos, window=window)
            want = ref.decode_attention_ref(q, k, v, sp, pos, window=window)
            torch.cuda.synchronize()
            assert torch.isfinite(got).all()
            assert _err_ok(got, want, dtype), (pos_np, window)
        assert torch.equal(got, k_decode.decode_attention(q, k, v, sp, pos, window=window))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_averages_where_no_slot_is_valid_on_card(cuda, dtype):
    """A row with no valid slot gets from K2 what the plain version gives
    it, the mean of its ring's V (a uniform softmax over masked scores):
    an empty ring, a ring of later positions only, and, under a window of
    50, a row whose positions all lie before the window; V is offset by
    its row, so a mean over another row's ring would show."""
    rng = np.random.default_rng(5)
    B, L, H, KVH, hd = 4, 1024, 32, 8, 64
    i = np.arange(L)
    sp_np = np.stack([np.full(L, -1), i + 10, np.where(i <= 300, i, -1), i]).astype(np.int32)
    pos_np = np.asarray([700, 5, 700, 700], np.int32)
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32)).to(cuda, dtype)
    k, v = (torch.from_numpy(rng.standard_normal((B, L, KVH, hd)).astype(np.float32))
            .to(cuda, dtype) for _ in range(2))
    v = v + torch.arange(B, device=cuda, dtype=dtype)[:, None, None, None]
    sp, pos = torch.from_numpy(sp_np).to(cuda), torch.from_numpy(pos_np).to(cuda)
    for window, empty in ((None, 2), (50, 3)):
        got = k_decode.decode_attention(q, k, v, sp, pos, window=window)
        want = ref.decode_attention_ref(q, k, v, sp, pos, window=window)
        torch.cuda.synchronize()
        for b in range(B):   # each row against its own scale
            assert _err_ok(got[b], want[b], dtype), (window, b)
        assert _err_ok(got[:empty], v[:empty].float().mean(1).repeat_interleave(H // KVH, 1),
                       dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("ps", [8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_equals_dense_decode_on_card(cuda, dtype, ps):
    """The same K/V in a ring that has not wrapped (slot j holds position j,
    later slots empty with +-1e30) and scattered into shuffled pages (pages
    past pos unallocated): K2 and K3 give the same output bit for bit at
    the split's edge positions. Row 0 has no valid slot: K2 averages its
    ring, K3 page 0, as their plain versions do (both garbage here, so only
    held finite; ``test_paged_kernels_average_where_no_slot_is_valid_on_card``
    holds such rows)."""
    rng = np.random.default_rng(ps)
    B, L, H, KVH, hd = 8, 1024, 32, 8, 64
    MP = L // ps
    pos_np = np.asarray([-1, 0, 63, 64, 511, 512, 700, 1023], np.int32)
    sp_np = np.where(np.arange(L)[None, :] <= pos_np[:, None], np.arange(L)[None, :],
                     -1).astype(np.int32)
    k, v = (torch.from_numpy(_junk_where_empty(
        rng, rng.standard_normal((B, L, KVH, hd)).astype(np.float32), sp_np)).to(cuda, dtype)
        for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32)).to(cuda, dtype)
    bt = rng.permutation(B * MP).astype(np.int32).reshape(B, MP)
    pages = torch.from_numpy(bt.reshape(-1)).long().to(cuda)
    kp, vp = (torch.empty((B * MP, ps, KVH, hd), dtype=dtype, device=cuda) for _ in range(2))
    kp[pages] = k.reshape(B * MP, ps, KVH, hd)
    vp[pages] = v.reshape(B * MP, ps, KVH, hd)
    bt[np.arange(MP)[None, :] * ps > pos_np[:, None]] = -1   # pages past pos unallocated
    sp, pos = torch.from_numpy(sp_np).to(cuda), torch.from_numpy(pos_np).to(cuda)
    bt = torch.from_numpy(bt).to(cuda)
    dense = k_decode.decode_attention(q, k, v, sp, pos)
    paged = k_paged.paged_decode_attention(q, kp, vp, bt, pos)
    want = ref.decode_attention_ref(q, k, v, sp, pos)
    torch.cuda.synchronize()
    assert torch.equal(dense[1:], paged[1:])
    assert torch.isfinite(dense).all() and torch.isfinite(paged).all()
    assert _err_ok(dense[1:], want[1:], dtype)
    assert torch.equal(paged, k_paged.paged_decode_attention(q, kp, vp, bt, pos))


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
# two, a group of one, tables of 4,096 slots (eight tiles a rank), a group
# of 32 at hd 128 and olmoe-1b-7b's paged serve (a group of one at hd 128)
GPU_PAGED = [(16, 64, 16, 32, 8, 64), (16, 128, 8, 32, 8, 64), (16, 32, 32, 32, 8, 64),
             (4, 3, 128, 8, 2, 32), (5, 9, 12, 8, 2, 128), (3, 8, 16, 4, 4, 64),
             (6, 256, 16, 8, 2, 64), (3, 64, 16, 32, 1, 128), (16, 64, 16, 16, 16, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,MP,ps,H,KVH,hd", GPU_PAGED)
def test_paged_kernel_matches_plain_on_card(cuda, dtype, B, MP, ps, H, KVH, hd):
    """K3 against its plain version: random positions, the split's edge
    positions from row 2 on, a hole in row 1, an inactive row 0 (the mean
    of page 0, garbage here, so only held finite); two launches equal bit
    for bit."""
    rng = np.random.default_rng(MP * ps + B)
    pos = rng.integers(min(128, MP * ps // 2), MP * ps, B).astype(np.int32)
    edges = [p for p in DECODE_EDGES if p < MP * ps][:max(B - 2, 0)]
    pos[2:2 + len(edges)] = edges
    pos[0] = -1                       # an inactive row: all -1, no valid slot
    k, v, bt, pos = paged_case(rng, B, MP, ps, KVH, hd, pos, holes=True)
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32)).to(cuda, dtype)
    k, v = (torch.from_numpy(a).to(cuda, dtype) for a in (k, v))
    bt, pos_t = torch.from_numpy(bt).to(cuda), torch.from_numpy(pos).to(cuda)
    got = k_paged.paged_decode_attention(q, k, v, bt, pos_t)
    want = ref.paged_decode_attention_ref(q, k, v, bt, pos_t)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert _err_ok(got[1:], want[1:], dtype)
    assert torch.equal(got, k_paged.paged_decode_attention(q, k, v, bt, pos_t))


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["native", "int8", "fp8", "mixed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,MP,ps,H,KVH,hd", [(6, 16, 16, 8, 2, 64), (5, 9, 12, 8, 2, 128),
                                              (16, 64, 16, 16, 16, 128)])
def test_paged_kernels_average_where_no_slot_is_valid_on_card(cuda, pool, dtype, B, MP, ps, H,
                                                              KVH, hd):
    """A row with no valid slot gets from K3 (native pool) and K3q (int8,
    fp8 or mixed) what their plain versions give it, the mean of V over
    every table slot, an unallocated page read as page 0 (of the code
    region when the pool has one): an all -1 table at pos 0, one at a stale
    pos 600, and a table whose first page is a hole at a pos inside it (its
    allocated pages read as themselves). The pool holds no garbage and V is
    offset by its page id, so a mean over another page would show; every
    row, the live ones too, against its own scale."""
    rng = np.random.default_rng(MP * ps + B + len(pool))
    N = B * MP
    bt = rng.permutation(N).astype(np.int32).reshape(B, MP)
    pos = rng.integers(MP * ps // 2, MP * ps, B).astype(np.int32)
    bt[:2] = -1
    pos[:3] = (0, 600, ps // 2)
    bt[2, 0] = -1
    k = rng.standard_normal((N, ps, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((N, ps, KVH, hd)).astype(np.float32)
    v += 4.0 * np.arange(N, dtype=np.float32)[:, None, None, None] / N
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32)).to(cuda, dtype)
    bt_t, pos_t = torch.from_numpy(bt).to(cuda), torch.from_numpy(pos).to(cuda)
    if pool == "native":
        kk, vv = (torch.from_numpy(a).to(cuda, dtype) for a in (k, v))
        got = k_paged.paged_decode_attention(q, kk, vv, bt_t, pos_t)
        want = ref.paged_decode_attention_ref(q, kk, vv, bt_t, pos_t)
    else:
        prec = parse_kv_precision("fp8" if pool == "fp8" else "int8")
        Nn = N // 2 if pool == "mixed" else 0
        qk, ks = quantize_kv(torch.from_numpy(k[Nn:]).to(cuda), prec)
        qv, vs = quantize_kv(torch.from_numpy(v[Nn:]).to(cuda), prec)
        kn = vn = None
        if Nn:
            kn, vn = (torch.from_numpy(a[:Nn]).to(cuda, dtype) for a in (k, v))
        got = k_paged_quant.paged_decode_attention_quant(q, kn, vn, qk, qv, ks, vs, bt_t, pos_t)
        if Nn:
            want = ref.paged_decode_attention_mixed_ref(q, kn, vn, qk, qv, ks, vs, bt_t, pos_t)
        else:
            want = ref.paged_decode_attention_quant_ref(q, qk, qv, ks, vs, bt_t, pos_t)
    torch.cuda.synchronize()
    for b in range(B):
        assert _err_ok(got[b], want[b], dtype), b

def chunk_case(rng, B, C, L, H, KVH, hd, variant="mix"):
    """Rows cycle through: a first chunk (pos0 0), a mid-prompt chunk with
    a hole in its prefix, a partial final chunk (valid < C) and an inactive
    row (valid 0). Each row's cache holds positions 0..pos0+valid-1 in
    order (capped at L); slots beyond the written prefix, and the hole, are
    empty (slot_pos -1) and hold +-1e30 garbage. ``variant`` "wrapped"
    moves each active row's chunk past the ring's end (pos0 + valid > L:
    slot i holds the latest position p <= the chunk's last with p % L == i,
    so the early queries of a chunk at L - 64 or later find a first tile of
    later positions, all masked); "hole" empties the slots below each active
    row's pos0, moved to 64 where the cache allows, so every query's first
    tile there is all masked. Numpy arrays."""
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
    for b in range(B):
        nv = int(valid[b])
        if not nv or variant == "mix":
            continue
        sp[b] = -1
        if variant == "wrapped":
            pos0[b] = L + b - nv // 2
            last = pos0[b] + nv - 1
            i = np.arange(L)
            slot = np.where(i <= last % L, last - last % L + i, last - last % L - L + i)
            sp[b] = np.where(slot < 0, -1, slot)
        else:   # "hole"
            pos0[b] = min(64 + b, L - nv)
            sp[b, pos0[b]:pos0[b] + nv] = np.arange(pos0[b], pos0[b] + nv)
    q = rng.standard_normal((B, C, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, L, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((B, L, KVH, hd)).astype(np.float32)
    junk = np.where(rng.random((B, L, KVH, hd)) < 0.5, -1e30, 1e30).astype(np.float32)
    empty = (sp < 0)[..., None, None]
    return q, np.where(empty, junk, k), np.where(empty, -junk, v), sp, pos0, valid


def _rising_np(k):
    """``_rising`` on a numpy cache (B, L, KVH, hd): slot i scaled by 1 + i // 64."""
    return k * (1 + np.arange(k.shape[1]) // 64)[None, :, None, None].astype(np.float32)


# chunk_case's variants, each also with K rising tile by tile (every tile
# holds a new row maximum, so alpha != 1 on every tile)
CHUNK_VARIANTS = [(v, rising) for v in ("mix", "wrapped", "hole") for rising in (False, True)]


# (B, C, L, H, KVH, hd): the serving shape, C of 16/64/128 against L of 64
# and 1024, a ragged C, and a group of one; C of 40 and 130 (not multiples
# of 64) over L that are not either, at hd 32 and 128. bf16 runs the wgmma
# kernel, f32 the CUDA-core one.
GPU_CHUNK = [(8, 128, 1024, 32, 8, 64), (8, 64, 1024, 32, 8, 64), (8, 16, 1024, 32, 8, 64),
             (4, 16, 64, 8, 2, 32), (4, 64, 64, 8, 2, 128), (5, 40, 100, 4, 4, 64),
             (4, 130, 300, 8, 2, 128), (5, 40, 200, 4, 2, 32), (4, 130, 1000, 8, 2, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,L,H,KVH,hd", GPU_CHUNK)
def test_chunk_kernel_matches_plain_on_card(cuda, dtype, B, C, L, H, KVH, hd):
    """K4 on chunk_case's mix, a wrapped ring and rows whose first tile is
    all masked, each also with K rising tile by tile; two launches equal."""
    for variant, rising in CHUNK_VARIANTS:
        rng = np.random.default_rng(C * L + B)
        arrs = list(chunk_case(rng, B, C, L, H, KVH, hd, variant))
        if rising:
            arrs[1] = _rising_np(arrs[1])
        q, k, v = (torch.from_numpy(a).to(cuda, dtype) for a in arrs[:3])
        sp, pos0, valid = (torch.from_numpy(a).to(cuda) for a in arrs[3:])
        got = k_chunk.chunk_attention(q, k, v, sp, pos0, valid)
        want = ref.chunk_attention_ref(q, k, v, sp, pos0, valid)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), (variant, rising)
        for b, n in enumerate(arrs[5]):
            assert not got[b, n:].any()    # padding rows, and all of an inactive row
        assert _err_ok(got, want, dtype), (variant, rising)
        if variant == "mix" and not rising:
            # deterministic: no atomics, no split across CTAs
            assert torch.equal(got, k_chunk.chunk_attention(q, k, v, sp, pos0, valid))


def quant_case(rng, B, MP, ps, KVH, hd, pool, edges=False):
    """``paged_case`` with page-boundary positions (rows 1-3 at ps - 1, ps
    and 2 ps - 1 where the table allows), an inactive row 0, and the pool
    split into regions: ``pool`` "int8" or "fp8" quantizes every page,
    "mixed" keeps the lower half native and quantizes the rest to int8.
    ``edges`` puts rows 4 on at the split's edge positions. Garbage rows
    quantize to codes of +-qmax with scales near 1e30 / qmax, so a read of
    one would show. Returns numpy (native k, v or None; codes k, v; scales
    k, v; block tables; pos) and the code precision."""
    pos = rng.integers(min(128, MP * ps // 2), MP * ps, B).astype(np.int32)
    for b, p in zip(range(1, min(B, 4)), (ps - 1, ps, 2 * ps - 1)):
        if p < MP * ps:
            pos[b] = p
    if edges:
        tail = [p for p in DECODE_EDGES if p < MP * ps][:max(B - 4, 0)]
        pos[4:4 + len(tail)] = tail
    pos[0] = -1
    k, v, bt, pos = paged_case(rng, B, MP, ps, KVH, hd, pos, holes=True)
    prec = parse_kv_precision("fp8" if pool == "fp8" else "int8")
    Nn = k.shape[0] // 2 if pool == "mixed" else 0
    qk, ks = quantize_kv(torch.from_numpy(k[Nn:]), prec)
    qv, vs = quantize_kv(torch.from_numpy(v[Nn:]), prec)
    native = (k[:Nn], v[:Nn]) if Nn else (None, None)
    return (*native, qk, qv, ks, vs, bt, pos)


# (B, MP, ps, H, KVH, hd): the paged serve's shape, a page larger than the
# kernel's 64-slot tile, a page size that is no power of two with hd 128, a
# group of 32 at hd 128 and a group of one at hd 32
GPU_QUANT = [(16, 64, 16, 32, 8, 64), (4, 3, 128, 8, 2, 32), (5, 9, 12, 8, 2, 128),
             (3, 64, 16, 32, 1, 128), (4, 16, 16, 4, 4, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["int8", "fp8", "mixed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,MP,ps,H,KVH,hd", GPU_QUANT)
def test_paged_quant_kernel_matches_plain_on_card(cuda, pool, dtype, B, MP, ps, H, KVH, hd):
    """K3q against its plain version over all-int8, all-fp8 and mixed
    pools (``quant_case``; its inactive row 0 averages garbage page 0, so
    it is only held finite); two launches equal bit for bit."""
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
    assert _err_ok(got[1:], want[1:], dtype)
    assert torch.equal(got, k_paged_quant.paged_decode_attention_quant(q, k, v, qk, qv, ks, vs,
                                                                       bt, pos_t))


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["int8", "fp8", "mixed"])
@pytest.mark.parametrize("ps", [8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_quant_kernel_equals_paged_kernel_on_dequantized_pool_on_card(cuda, dtype, ps,
                                                                            pool):
    """K3q over codes gives K3 over the same pool with its code pages
    dequantized (``dequantize_kv``) and placed after the native ones, read
    through the same table ids, bit for bit: random positions, page
    boundaries, the split's edge positions and a hole. The inactive row 0
    reads page 0 of the code region in K3q and page 0 of the pool in K3,
    as their plain versions do: equal where those are one page (a pool
    with no native page)."""
    rng = np.random.default_rng(ps + len(pool))
    B, H, KVH, hd = 10, 32, 8, 64
    MP = 1024 // ps
    k, v, qk, qv, ks, vs, bt, pos = quant_case(rng, B, MP, ps, KVH, hd, pool, edges=True)
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32)).to(cuda, dtype)
    qk, qv, ks, vs = (t.to(cuda) for t in (qk, qv, ks, vs))
    kk, vv = dequantize_kv(qk, ks, dtype), dequantize_kv(qv, vs, dtype)
    if k is not None:
        k, v = (torch.from_numpy(a).to(cuda, dtype) for a in (k, v))
        kk, vv = torch.cat((k, kk)), torch.cat((v, vv))
    bt, pos_t = torch.from_numpy(bt).to(cuda), torch.from_numpy(pos).to(cuda)
    got = k_paged_quant.paged_decode_attention_quant(q, k, v, qk, qv, ks, vs, bt, pos_t)
    want = k_paged.paged_decode_attention(q, kk, vv, bt, pos_t)
    torch.cuda.synchronize()
    assert torch.equal(got[1:], want[1:])
    if k is None:
        assert torch.equal(got[0], want[0])


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
# chunk 32 with N 64; then what a chunk-parallel grid can get wrong: H 5
# (not a multiple of any head group above 1) with a tail and an initial
# state at chunk 128, one chunk (S <= chunk), 16 chunks of carry (B 1, S
# 2048), chunks of 192 and 256 (three and four 64-row tiles: two CTAs along
# the chunk), and P 8, N 4 padded to the tiles
GPU_SSD = [(8, 512, 24, 64, 128, 128, False), (2, 40, 8, 32, 32, 16, False),
           (2, 300, 4, 64, 128, 128, True), (3, 100, 3, 32, 64, 32, True),
           (2, 300, 5, 64, 128, 128, True), (3, 90, 6, 64, 128, 128, False),
           (1, 2048, 24, 64, 128, 128, False), (2, 500, 4, 32, 32, 192, True),
           (1, 600, 3, 32, 32, 256, False), (2, 50, 3, 8, 4, 16, True)]


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
    k_ssd.launches["ssd_scan"] = k_ssd.launches["ssd_scan_f32"] = 0
    y, fin = k_ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, init_state=st)
    ry, rfin = ref.ssd_chunked(x, dt, A, Bm, Cm, chunk, st)
    ey, efin = ref.ssd_chunked(x.abs(), dt, A, Bm.abs(), Cm.abs(), chunk,
                               None if st is None else st.abs())
    torch.cuda.synchronize()
    assert k_ssd.launches["ssd_scan"] == 1
    assert k_ssd.launches["ssd_scan_f32"] == (dtype == torch.float32)
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
    xb = x.bfloat16()
    with pytest.raises(ValueError, match="chunk"):   # more than four 64-row tiles
        k_ssd.ssd_scan(xb, dt, A, Bm, Cm, chunk=288)
    with pytest.raises(ValueError, match="chunk"):
        k_ssd.chunk_states(xb, dt, A, Bm, chunk=48)
    with pytest.raises(ValueError, match="bfloat16"):   # the phases are the bf16 route's
        k_ssd.chunk_outputs(x, dt, A, Bm, Cm, torch.zeros((1, 2, 2, 32, 32), device=cuda),
                            chunk=16)
    with pytest.raises(ValueError, match="states"):
        k_ssd.chunk_outputs(xb, dt, A, Bm, Cm, torch.zeros((1, 3, 2, 32, 32), device=cuda),
                            chunk=16)
    with pytest.raises(RuntimeError, match="cudaError_t"):   # beyond a CTA's shared memory
        k_ssd.ssd_scan(torch.zeros((1, 8, 1, 256), device=cuda, dtype=torch.bfloat16),
                       dt[:, :8, :1].contiguous(), A[:1], torch.zeros((1, 8, 256), device=cuda),
                       torch.zeros((1, 8, 256), device=cuda), chunk=256)


# (B, S, H, P, N, chunk, init): the full prefill, a tail with an initial
# state and H 5, one short chunk with P 8 and N 4
GPU_SSD_PHASES = [(8, 512, 24, 64, 128, 128, False), (2, 300, 5, 64, 128, 128, True),
                  (2, 50, 3, 8, 4, 64, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,P,N,chunk,init", GPU_SSD_PHASES)
def test_ssd_phase_kernels_match_plain_on_card(cuda, B, S, H, P, N, chunk, init):
    """Each of the bf16 route's three kernels against its plain version on
    the same inputs: the chunk states and the entering states by the f32
    rule, y by the bf16 one; env is the plain phase on |x|, |B|, |C| and
    |state|."""
    x, dt, A, Bm, Cm, st = _ssd_case(cuda, S + 7, B, S, H, P, N, init)
    x = x.bfloat16()
    before = dict(k_ssd.launches)
    contrib, decay = k_ssd.chunk_states(x, dt, A, Bm, chunk=chunk)
    rcontrib, rdecay = ref.ssd_chunk_states_ref(x, dt, A, Bm, chunk)
    econtrib, _ = ref.ssd_chunk_states_ref(x.abs(), dt, A, Bm.abs(), chunk)
    torch.cuda.synchronize()
    assert _ssd_ok(contrib, rcontrib, econtrib, SSD_RTOL[torch.float32])
    assert _ssd_ok(decay, rdecay, rdecay, SSD_RTOL[torch.float32])

    entering = rcontrib.clone()   # the plain contributions, so phase 2 alone is held
    fin = k_ssd.state_passing(entering, rdecay, st)
    rentering, rfin = ref.ssd_state_passing_ref(rcontrib, rdecay, st)
    eentering, efin = ref.ssd_state_passing_ref(econtrib, rdecay,
                                                None if st is None else st.abs())
    torch.cuda.synchronize()
    assert _ssd_ok(entering, rentering, eentering, SSD_RTOL[torch.float32])
    assert _ssd_ok(fin, rfin, efin, SSD_RTOL[torch.float32])

    y = k_ssd.chunk_outputs(x, dt, A, Bm, Cm, rentering.contiguous(), chunk=chunk)
    ry = ref.ssd_chunk_outputs_ref(x, dt, A, Bm, Cm, rentering, chunk)
    ey = ref.ssd_chunk_outputs_ref(x.abs(), dt, A, Bm.abs(), Cm.abs(), eentering, chunk)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and torch.isfinite(y).all()
    assert _ssd_ok(y, ry, ey, SSD_RTOL[torch.bfloat16])
    assert {k: k_ssd.launches[k] - before[k] for k in before} == {
        "ssd_scan": 0, "ssd_scan_f32": 0, "ssd_chunk_states": 1, "ssd_state_passing": 1,
        "ssd_chunk_outputs": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("init", [False, True])
def test_ssd_kernel_two_launches_equal_on_card(cuda, init):
    """The bf16 route has no atomics: two launches on the same inputs give
    the same bits (y and the final state), at the full prefill shape."""
    x, dt, A, Bm, Cm, st = _ssd_case(cuda, 11, 8, 512, 24, 64, 128, init)
    x = x.bfloat16()
    y1, f1 = k_ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=128, init_state=st)
    y2, f2 = k_ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=128, init_state=st)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(f1, f2)


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,L,H,KVH,hd", GPU_CHUNK)
def test_chunk_quant_kernel_matches_plain_on_card(cuda, prec, dtype, B, C, L, H, KVH, hd):
    """K4q: chunk_case's variants (the mix, a wrapped ring, all-masked first
    tiles; each also with K rising tile by tile) over int8 or fp8 codes (its
    +-1e30 garbage quantizes to +-qmax codes with huge scales); two launches
    equal."""
    spec = parse_kv_precision(prec)
    for variant, rising in CHUNK_VARIANTS:
        rng = np.random.default_rng(C * L + B + len(prec))
        q, k, v, sp, pos0, valid = chunk_case(rng, B, C, L, H, KVH, hd, variant)
        if rising:
            k = _rising_np(k)
        qk, ks = quantize_kv(torch.from_numpy(k).to(cuda), spec)
        qv, vs = quantize_kv(torch.from_numpy(v).to(cuda), spec)
        q = torch.from_numpy(q).to(cuda, dtype)
        sp, pos0_t, valid_t = (torch.from_numpy(a).to(cuda) for a in (sp, pos0, valid))
        got = k_pchunk.chunk_attention_quant(q, qk, qv, ks, vs, sp, pos0_t, valid_t)
        want = ref.chunk_attention_quant_ref(q, qk, qv, ks, vs, sp, pos0_t, valid_t)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), (variant, rising)
        for b, n in enumerate(valid):
            assert not got[b, n:].any()
        assert _err_ok(got, want, dtype), (variant, rising)
        if variant == "mix" and not rising:
            assert torch.equal(got, k_pchunk.chunk_attention_quant(q, qk, qv, ks, vs, sp,
                                                                   pos0_t, valid_t))


def paged_chunk_case(rng, B, C, MP, ps, KVH, hd, pool, staged, variant="mix"):
    """A pool of B * MP pages ("native", "int8", "fp8", or "mixed": the
    lower half native, the rest int8) and per row, cycling: a first chunk
    (pos0 0, base 0); a prefix hit ending mid-page (base ps + ps // 2) with
    the chunk there; a hit covering all but the last prompt token (a
    one-token chunk at base = pos0 = L - 1); an inactive row (all -1).
    Each row's table covers its positions up to the chunk's last. Pool
    rows no row may read hold +-1e30 garbage: those past the chunk and,
    with staging buffers (``staged``), those at or past base, which the
    buffers serve. ``variant`` "rising" scales each row's K by 1 + j // 64
    at logical position j (per page, from the page's first position), so
    alpha != 1 on every tile; "holes" puts the one-token chunks at or past
    the pages that cover positions 0-63 and unallocates those pages, so the
    row's first tile holds no key at all (a key's position is its slot, so
    a tile with a key always shows it to some query); "alternate" gives a
    mixed pool's rows int8 and native pages in turn, logical page by
    logical page, so a 64-slot tile mixes both (and staging, past base). Returns (k,
    v or None, None; codes, scales or None; block tables, pos0, valid, base,
    stage_k, stage_v or None) as CPU tensors."""
    N, P = B * MP, MP * ps
    Nn = N if pool == "native" else N // 2 if pool == "mixed" else 0
    perm = rng.permutation(N).astype(np.int32)
    if variant == "alternate" and 0 < Nn < N:
        native, coded = perm[perm < Nn], perm[perm >= Nn]   # N // 2 and the rest
        perm = np.empty(N, np.int32)
        perm[0::2], perm[1::2] = coded, native
    n_hole = -(-64 // ps)   # pages that cover positions 0-63
    bt = np.full((B, MP), -1, np.int32)
    live = np.zeros((N, ps), bool)
    pos0, valid, base = (np.zeros(B, np.int32) for _ in range(3))
    for b in range(B):
        kind = b % 4
        if kind == 3:
            continue
        if kind == 0:
            p0, nv, bs = 0, C, 0
        elif kind == 1:
            bs = ps + ps // 2
            p0, nv = bs, min(C, P - bs)
        else:
            lo = n_hole * ps if variant == "holes" else ps
            p0 = bs = int(rng.integers(lo, P))
            nv = 1
        pos0[b], valid[b], base[b] = p0, nv, bs
        end = p0 + nv
        bt[b, : (end - 1) // ps + 1] = perm[b * MP: b * MP + (end - 1) // ps + 1]
        if variant == "holes" and kind == 2:
            bt[b, :n_hole] = -1
        for j in range(bs if staged else end):
            if bt[b, j // ps] >= 0:
                live[bt[b, j // ps], j % ps] = True
    k = rng.standard_normal((N, ps, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((N, ps, KVH, hd)).astype(np.float32)
    junk = np.where(rng.random((N, ps, KVH, hd)) < 0.5, -1e30, 1e30).astype(np.float32)
    k = np.where(live[..., None, None], k, junk)
    if variant == "rising":
        for b, lp in zip(*np.nonzero(bt >= 0)):
            k[bt[b, lp]] *= 1 + lp * ps // 64
    k = torch.from_numpy(k)
    v = torch.from_numpy(np.where(live[..., None, None], v, -junk))
    codes = (None,) * 4
    if Nn < N:
        spec = parse_kv_precision("fp8" if pool == "fp8" else "int8")
        qk, ks = quantize_kv(k[Nn:], spec)
        qv, vs = quantize_kv(v[Nn:], spec)
        codes = (qk, qv, ks, vs)
    native = (k[:Nn], v[:Nn]) if Nn else (None, None)
    stage = (None, None)
    if staged:
        S = P + 1
        stage = [rng.standard_normal((B, S, KVH, hd)).astype(np.float32) for _ in range(2)]
        if variant == "rising":
            stage[0] = _rising_np(stage[0])
        stage = tuple(torch.from_numpy(a) for a in stage)
    return (*native, *codes, *(torch.from_numpy(a) for a in (bt, pos0, valid, base)), *stage)


# (B, C, MP, ps, H, KVH, hd): the chunked serve's pool (64-page tables of
# 16 rows, chunks of 128), a page size that is no power of two with hd 128,
# a page larger than the kernel's 64-slot tile, and a chunk of 130 (no
# multiple of 64)
GPU_PAGED_CHUNK = [(16, 128, 64, 16, 32, 8, 64), (5, 40, 9, 12, 8, 2, 128),
                   (4, 16, 3, 128, 8, 2, 32), (4, 130, 24, 16, 8, 2, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("pool,staged", [("native", False), ("int8", True), ("fp8", True),
                                         ("mixed", True), ("int8", False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,MP,ps,H,KVH,hd", GPU_PAGED_CHUNK)
def test_paged_chunk_kernel_matches_plain_on_card(cuda, pool, staged, dtype, B, C, MP, ps, H,
                                                  KVH, hd):
    """K4p on every pool kind, with the staging split at base 0, mid-page
    and L - 1, and without staging buffers; K rising tile by tile, leading
    tiles with no key, and (mixed pools) native and int8 pages alternating
    inside a tile; two launches equal."""
    variants = ["mix", "rising", "holes"] + (["alternate"] if pool == "mixed" else [])
    for variant in variants:
        rng = np.random.default_rng(MP * ps + B + len(pool) + staged)
        case = paged_chunk_case(rng, B, C, MP, ps, KVH, hd, pool, staged, variant)
        case = [None if t is None else t.to(cuda) for t in case]
        for i in (0, 1, 10, 11):   # native pages and staging buffers in q's dtype
            if case[i] is not None:
                case[i] = case[i].to(dtype)
        k, v, qk, qv, ks, vs, bt, pos0, valid, base, stk, stv = case
        q = torch.from_numpy(rng.standard_normal((B, C, H, hd)).astype(np.float32)).to(cuda,
                                                                                       dtype)
        kw = dict(stage_k=stk, stage_v=stv, base=base)
        got = k_pchunk.paged_chunk_attention(q, k, v, qk, qv, ks, vs, bt, pos0, valid, **kw)
        want = ref.paged_chunk_attention_ref(q, k, v, qk, qv, ks, vs, bt, pos0, valid, **kw)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), variant
        for b, n in enumerate(valid.tolist()):
            assert not got[b, n:].any()
        assert _err_ok(got, want, dtype), variant
        if variant == "mix":
            again = k_pchunk.paged_chunk_attention(q, k, v, qk, qv, ks, vs, bt, pos0, valid, **kw)
            assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["int8", "mixed"])
def test_fork_then_read_on_card(cuda, pool):
    """A copy-on-write fork on the card, then K4p through the forked pages:
    bit for bit what it reads through the source pages (codes and scales
    move together), and a pad entry touches only the scratch pages."""
    rng = np.random.default_rng(5)
    B, C, MP, ps, H, KVH, hd = 4, 16, 8, 16, 8, 2, 64
    k, v, qk, qv, ks, vs, bt, pos0, valid, base, stk, stv = (
        None if t is None else t.to(cuda)
        for t in paged_chunk_case(rng, B, C, MP, ps, KVH, hd, pool, True))
    pad = lambda t: None if t is None else torch.cat([t, torch.zeros_like(t[:1])])
    pl = PagedKVPool(pad(k), pad(v), pad(qk), pad(qv), pad(ks), pad(vs))
    N = B * MP
    Nn = pl.native_pages
    used = set(bt[bt >= 0].tolist())
    free = [p for p in range(N) if p not in used]
    src = [int(bt[1, 0]), int(bt[2, 1])]        # a page of each of two rows
    dst = [next(p for p in free if (p < Nn) == (s < Nn)) for s in src]
    dst[1] = next(p for p in free if (p < Nn) == (src[1] < Nn) and p != dst[0])
    before = [t.clone() for t in pl if t is not None]
    fork_pages(pl, torch.tensor(src + [0], device=cuda), torch.tensor(dst + [N], device=cuda))
    forked = bt.clone()
    forked[1, 0], forked[2, 1] = dst[0], dst[1]
    q = torch.from_numpy(rng.standard_normal((B, C, H, hd)).astype(np.float32)).to(cuda)
    regions = pl.regions()
    a = k_pchunk.paged_chunk_attention(q, *regions, bt, pos0, valid, stage_k=stk, stage_v=stv,
                                       base=base)
    b = k_pchunk.paged_chunk_attention(q, *regions, forked, pos0, valid, stage_k=stk,
                                       stage_v=stv, base=base)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    native = {d for d in dst if d < Nn} | {Nn}               # region-local; scratch last
    quant = {d - Nn for d in dst if d >= Nn} | {N - Nn}
    for t, was in zip((t for t in pl if t is not None), before, strict=True):
        pages = set((t != was).reshape(t.shape[0], -1).any(-1).nonzero()[:, 0].tolist())
        assert pages <= (native if t.dim() == 4 and t.dtype == q.dtype else quant)


def _codes_on_card(cuda, rng, shape, prec, spread=None, rising=False):
    """Seeded K and V rows quantized on the card: codes and scales.
    ``spread`` multiplies each KV head (axis 2) by its own factor;
    ``rising`` scales K's rows as ``_rising`` does."""
    spec = parse_kv_precision(prec)
    out = []
    for i in range(2):
        x = rng.standard_normal(shape).astype(np.float32)
        if spread is not None:
            x *= spread[None, None, :, None]
        x = torch.from_numpy(x).to(cuda)
        if rising and i == 0:
            x = _rising(x)
        out.extend(quantize_kv(x, spec))
    qk, ks, qv, vs = out
    return qk, qv, ks, vs


@pytest.mark.gpu
@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("prec", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,hd", GPU_PREFILL)
def test_flash_quant_kernel_matches_plain_on_card(cuda, dtype, prec, extreme, B, Sq, Sk, H,
                                                  KVH, hd):
    """K1q and K1rq (dense, ragged, windowed; ``_prefill_cases``) against
    ``attention_quant_ref``; ``extreme`` spreads the KV heads' scales over
    1e-3..1e3; K rows rising tile by tile, and two launches equal."""
    rng = np.random.default_rng(Sq + Sk + hd + KVH)
    spread = np.logspace(-3, 3, KVH).astype(np.float32) if extreme else None
    qk, qv, ks, vs = _codes_on_card(cuda, rng, (B, Sk, KVH, hd), prec, spread)
    rk, _, rks, _ = _codes_on_card(cuda, rng, (B, Sk, KVH, hd), prec, spread, rising=True)
    q = torch.from_numpy(rng.standard_normal((B, Sq, H, hd)).astype(np.float32)).to(cuda, dtype)
    g = torch.Generator(device=cuda).manual_seed(Sq)
    cases = _prefill_cases(cuda, g, B, Sq, Sk)
    for k, k_scale, seq_lens, window in ([(qk, ks, sl, w) for sl, w in cases]
                                         + [(rk, rks, sl, None) for sl in (None, cases[-1][0])]):
        got = k_flash.flash_attention_quant(q, k, qv, k_scale, vs, seq_lens, window=window)
        want = ref.attention_quant_ref(q, k, qv, k_scale, vs, window=window, seq_lens=seq_lens)
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.isfinite(got).all()
        assert _err_ok(got, want, dtype), (seq_lens, window, k is rk)
    sl, w = cases[-1]
    first = k_flash.flash_attention_quant(q, qk, qv, ks, vs, sl, window=w)
    assert torch.equal(first, k_flash.flash_attention_quant(q, qk, qv, ks, vs, sl, window=w))


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,H,KVH,hd", [(3, 64, 8, 2, 32), (8, 1024, 32, 8, 64),
                                          (2, 100, 8, 1, 128), (3, 256, 32, 1, 128),
                                          (4, 128, 4, 4, 32)])
def test_decode_quant_kernel_matches_plain_on_card(cuda, dtype, prec, B, L, H, KVH, hd):
    """K2q against ``decode_attention_quant_ref`` over a ring with empty
    slots (row 0), wrapped rows, and a window; groups of 1 to 32, hd 32 to
    128; two launches equal bit for bit."""
    rng = np.random.default_rng(L + hd)
    qk, qv, ks, vs = _codes_on_card(cuda, rng, (B, L, KVH, hd), prec)
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32)).to(cuda, dtype)
    pos_np = np.asarray([L // 2 - 1] + [L + 5 + 7 * b for b in range(1, B)], np.int32)
    sp = torch.from_numpy(_ring(B, L, pos_np)).to(cuda)
    pos = torch.from_numpy(pos_np).to(cuda)
    for window in (None, 50):
        got = k_decode.decode_attention_quant(q, qk, qv, ks, vs, sp, pos, window=window)
        want = ref.decode_attention_quant_ref(q, qk, qv, ks, vs, sp, pos, window=window)
        torch.cuda.synchronize()
        assert _err_ok(got, want, dtype)
    assert torch.equal(got, k_decode.decode_attention_quant(q, qk, qv, ks, vs, sp, pos,
                                                            window=window))


# (B, L, H, KVH, hd): rings of 64, 100 (a tile cut short), 1,024 and 4,096
# slots (eight tiles a rank), groups of 4, 1, 4 and 32, hd 32 to 128
GPU_DECODE_QUANT = [(3, 64, 8, 2, 32), (6, 100, 8, 8, 64), (8, 1024, 32, 8, 64),
                    (6, 4096, 32, 1, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,H,KVH,hd", GPU_DECODE_QUANT)
def test_decode_quant_kernel_equals_decode_kernel_on_dequantized_ring_on_card(
        cuda, dtype, prec, B, L, H, KVH, hd):
    """K2q over codes gives K2 over the dequantized ring (``dequantize_kv``)
    bit for bit: wrapped rows (row 0 half empty) and unwrapped rows at the
    split's edge positions, each without a window and with windows of 50
    and 200."""
    rng = np.random.default_rng(L + hd + H + len(prec))
    qk, qv, ks, vs = _codes_on_card(cuda, rng, (B, L, KVH, hd), prec)
    k, v = dequantize_kv(qk, ks, dtype), dequantize_kv(qv, vs, dtype)
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32)).to(cuda, dtype)
    wrapped = np.asarray([L // 2 - 1] + [L + 5 + 7 * b for b in range(1, B)], np.int32)
    edges = np.asarray([min(DECODE_EDGES[b % len(DECODE_EDGES)], L - 1) for b in range(B)],
                       np.int32)
    for pos_np, sp_np in ((wrapped, _ring(B, L, wrapped)),
                          (edges, _ring(B, L, edges, empty_row0=False))):
        sp, pos = torch.from_numpy(sp_np).to(cuda), torch.from_numpy(pos_np).to(cuda)
        for window in (None, 50, 200):
            got = k_decode.decode_attention_quant(q, qk, qv, ks, vs, sp, pos, window=window)
            want = k_decode.decode_attention(q, k, v, sp, pos, window=window)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (pos_np, window)


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_quant_kernel_averages_where_no_slot_is_valid_on_card(cuda, dtype, prec):
    """A row with no valid slot gets from K2q what the plain version gives
    it, the mean of its dequantized ring's V: an empty ring, a ring of
    later positions only, and, under a window of 50, a row whose positions
    all lie before the window."""
    rng = np.random.default_rng(5)
    B, L, H, KVH, hd = 4, 1024, 32, 8, 64
    i = np.arange(L)
    sp_np = np.stack([np.full(L, -1), i + 10, np.where(i <= 300, i, -1), i]).astype(np.int32)
    pos_np = np.asarray([700, 5, 700, 700], np.int32)
    qk, qv, ks, vs = _codes_on_card(cuda, rng, (B, L, KVH, hd), prec)
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32)).to(cuda, dtype)
    sp, pos = torch.from_numpy(sp_np).to(cuda), torch.from_numpy(pos_np).to(cuda)
    for window, empty in ((None, 2), (50, 3)):
        got = k_decode.decode_attention_quant(q, qk, qv, ks, vs, sp, pos, window=window)
        want = ref.decode_attention_quant_ref(q, qk, qv, ks, vs, sp, pos, window=window)
        torch.cuda.synchronize()
        for b in range(B):   # each row against its own scale
            assert _err_ok(got[b], want[b], dtype), (window, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_int8_decode_equals_paged_int8_decode_on_card(cuda, dtype):
    """The same int8 codes in a dense ring that has not wrapped (slot j holds
    position j) and in pages of an all-int8 pool, shuffled: K2q and K3q give
    the same output bit for bit, rows of 1 to 1,024 positions."""
    rng = np.random.default_rng(11)
    B, L, H, KVH, hd, ps = 8, 1024, 32, 8, 64, 16
    MP = L // ps
    qk, qv, ks, vs = _codes_on_card(cuda, rng, (B, L, KVH, hd), "int8")
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32)).to(cuda, dtype)
    pos_np = np.asarray([0, 15, 16, 63, 64, 500, 1000, 1023], np.int32)
    sp = np.where(np.arange(L)[None, :] <= pos_np[:, None], np.arange(L)[None, :], -1)
    perm = rng.permutation(B * MP).astype(np.int32)
    bt = perm.reshape(B, MP).copy()
    pages = torch.from_numpy(bt.reshape(-1)).long().to(cuda)
    pool = [torch.empty((B * MP, ps, KVH) + t.shape[3:], dtype=t.dtype, device=cuda)
            for t in (qk, qv, ks, vs)]
    for dst, src in zip(pool, (qk, qv, ks, vs), strict=True):
        dst[pages] = src.reshape(B * MP, ps, KVH, *src.shape[3:])
    bt[np.arange(MP)[None, :] * ps > pos_np[:, None]] = -1   # pages past pos unallocated
    pos = torch.from_numpy(pos_np).to(cuda)
    dense = k_decode.decode_attention_quant(q, qk, qv, ks, vs,
                                            torch.from_numpy(sp.astype(np.int32)).to(cuda), pos)
    paged = k_paged_quant.paged_decode_attention_quant(q, None, None, *pool,
                                                       torch.from_numpy(bt).to(cuda), pos)
    torch.cuda.synchronize()
    assert torch.equal(dense, paged)


@pytest.mark.gpu
def test_quant_kernels_refuse_what_they_do_not_take(cuda):
    rng = np.random.default_rng(0)
    qk, qv, ks, vs = _codes_on_card(cuda, rng, (2, 64, 2, 32), "int8")
    q = torch.zeros((2, 64, 4, 32), device=cuda)
    with pytest.raises(ValueError, match="k/v"):
        k_flash.flash_attention_quant(q, qk.float(), qv.float(), ks, vs)
    with pytest.raises(ValueError, match="k_scale"):
        k_flash.flash_attention_quant(q, qk, qv, ks[:, :32], vs)
    with pytest.raises(ValueError, match="k_scale"):
        k_flash.flash_attention_quant(q, qk, qv, ks.transpose(0, 1).contiguous().transpose(0, 1),
                                      vs)
    sp = torch.arange(64, dtype=torch.int32, device=cuda).repeat(2, 1)
    pos = torch.full((2,), 63, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="v_scale"):
        k_decode.decode_attention_quant(torch.zeros((2, 4, 32), device=cuda), qk, qv, ks,
                                        vs.double(), sp, pos)
    with pytest.raises(ValueError, match="bad shapes"):
        k_decode.decode_attention_quant(torch.zeros((2, 4, 48), device=cuda), qk[..., :48],
                                        qv[..., :48], ks, vs, sp, pos)


# ------------------------------------------------------------ CUDA graphs
# The fused, sync-free and chunked dispatches run as one CUDA graph replay
# each (runtime/graph.py), warmed up and captured before the first slot. At
# the smoke width, each captured mode must serve the same trace and token
# streams (sampled ones too) as the same engine run eagerly
# (``DecodeGraph.enabled = False``), with the same kernel launch counts.
GRAPH_SERVE = ["--arch", "granite-3-2b", "--smoke", "--horizon", "10"]
GRAPH_PAGED = ["--paged", "--policy", "memory-aware"]
GRAPH_MIXED = ["--slots", "8", "--prompt-len", "512", "--min-prompt-len", "128",
               "--cache-len", "1024", "--paged", "--max-active", "16", "--num-pages", "192",
               "--kv-precision", "int8", "--quant-pages", "64", "--policy", "precision-aware",
               "--downgrade-at", "0.5", "--upgrade-at", "0.3"]
GRAPH_CHUNKED = ["--chunked", "--policy", "token-aware", "--chunk-size", "4",
                 "--chunk-budget", "6"]
GRAPH_SAMPLING = ["--temperature", "0.8", "--top-k", "20", "--top-p", "0.9",
                  "--rep-penalty", "1.1", "--sampling-seed", "7"]
GRAPH_PATHS = {
    "dense": [],
    "dense_int8": ["--kv-precision", "int8"],
    "mamba2": ["--arch", "mamba2-130m"],
    "paged": GRAPH_PAGED,
    "mixed_pool": GRAPH_MIXED,
    "sync": ["--sync-free"],
    "mamba2_sync": ["--arch", "mamba2-130m", "--sync-free"],
    "paged_sync": GRAPH_PAGED + ["--sync-free"],
    "chunked": GRAPH_CHUNKED,
    # chunks of 80 over the smoke's 64-slot ring: one write target per slot
    "chunked_wide": ["--chunked", "--policy", "token-aware", "--chunk-size", "80"],
    "paged_chunked": ["--paged"] + GRAPH_CHUNKED,
    "dense_fp8_chunked": GRAPH_CHUNKED + ["--kv-precision", "fp8"],
    "sampled": GRAPH_SAMPLING,
    "sampled_sync": GRAPH_SAMPLING + ["--sync-free"],
    "sampled_chunked": GRAPH_CHUNKED + GRAPH_SAMPLING,
    "sampled_paged_chunked": ["--paged"] + GRAPH_CHUNKED + GRAPH_SAMPLING,
    # the MoE stacks: routing, capacity and combine inside the graphs
    "moe": ["--arch", "olmoe-1b-7b"],
    "moe_sync": ["--arch", "olmoe-1b-7b", "--sync-free"],
    "moe_paged": ["--arch", "olmoe-1b-7b"] + GRAPH_PAGED,
    "moe_paged_sync": ["--arch", "olmoe-1b-7b", "--sync-free"] + GRAPH_PAGED,
    "deepseek_moe": ["--arch", "deepseek-moe-16b"],
    # the hybrid Griffin stack: RG-LRU states and the windowed ring inside
    # the graphs (the smoke window of 32 wraps inside the 64-slot cache)
    "hybrid": ["--arch", "recurrentgemma-2b"],
    "hybrid_sync": ["--arch", "recurrentgemma-2b", "--sync-free"],
    "hybrid_sampled": ["--arch", "recurrentgemma-2b"] + GRAPH_SAMPLING,
}


def _graph_serve(argv, graph: bool, idle_first_slot: bool = False, fail_at=None):
    """One launcher serve with the graphs on or off; the sync-free and
    chunked loops run every slot's engine work under the sync debug mode
    (the scheduler's first decision, which seeds its pipeline, before it).
    With ``idle_first_slot`` no request arrives in slot 0; with ``fail_at``
    a fleet's replica 1 fails at that slot, before its arrivals."""
    from repro_torch import kernels
    from repro_torch.launch import serve as launcher
    from repro_torch.runtime.graph import DecodeGraph

    args = launcher.build_parser().parse_args(argv)
    kernels.reset_launch_counts()
    engine, sched, src = launcher.build(args)
    poll = src.poll
    if idle_first_slot:
        src.poll = lambda t, rate: [] if t == 0 else poll(t, rate)
    if fail_at is not None:
        def failing(t, rate):
            if t == fail_at:
                engine.fail_replica(1)
            return poll(t, rate)
        src.poll = failing
    if args.sync_free or args.chunked:
        control, calls = sched.control_async, [0]

        def checked(*a, **kw):
            calls[0] += 1
            out = control(*a, **kw)
            if calls[0] == 1:
                torch.cuda.set_sync_debug_mode("error")
            return out
        sched.control_async = checked
    DecodeGraph.enabled = graph
    try:
        tr = launcher.run(args, engine, sched, src)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        DecodeGraph.enabled = True
    torch.cuda.synchronize()
    streams = {r.rid: list(r.generated) for r in engine.finished}
    return engine, {k: v.tolist() for k, v in tr.items()}, streams, kernels.launch_counts()


@pytest.mark.gpu
@pytest.mark.parametrize("path", sorted(GRAPH_PATHS))
def test_graph_serve_equals_eager_serve_on_card(cuda, path):
    argv = GRAPH_SERVE + GRAPH_PATHS[path]
    eager, tr_e, st_e, n_e = _graph_serve(argv, graph=False)
    graph, tr_g, st_g, n_g = _graph_serve(argv, graph=True)
    assert tr_g == tr_e
    assert st_g == st_e and len(st_g) > 0
    assert n_g == n_e
    assert eager.graph_replays == 0
    # warmed up and captured before the first slot: every dispatch replays
    # (the chunked loop's mixed and decode-only dispatches; the fused and
    # sync-free loops' decode and their admission of each prompt bucket;
    # each greedy and, with a default sampler, sampled)
    chunked = "chunked" in path
    per = 2 if chunked else 1 + len(graph._warm_buckets())
    warm = per * (2 if "sampled" in path else 1)
    assert eager.warmup_dispatches == graph.warmup_dispatches == warm
    assert graph.prefill_warmups == (0 if chunked else warm - warm // per)
    assert graph.graph_replays == graph.decode_dispatches + graph.prefill_dispatches
    assert graph.prefill_replays == graph.prefill_dispatches
    assert graph.decode_dispatches > 0 and (graph.prefill_dispatches > 0) != chunked
    if "chunked" in path:
        assert graph._graphs["chunk+s" if "sampled" in path else "chunk"].replays > 0
    # rows admitted after the capture decoded through the replays (on the
    # chunked loops every row: their capture precedes slot 0 too, and their
    # long prompts finish too late in the serve to look further)
    assert any(r.admit_slot >= (0 if "chunked" in path else 2) for r in graph.finished)
    if "sync" in path or "chunked" in path:
        assert graph.blocking_syncs == 0


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["dense", "sync", "paged_sync", "chunked", "paged_chunked"])
def test_graph_serve_with_an_idle_first_slot_on_card(cuda, path):
    """No arrival in slot 0, so the first decode dispatch comes later, under
    the sync debug mode on the sync-free loops: the capture was made before
    serving, so no slot synchronizes, and the serve equals the eager one."""
    argv = GRAPH_SERVE + GRAPH_PATHS[path]
    eager, tr_e, st_e, n_e = _graph_serve(argv, graph=False, idle_first_slot=True)
    graph, tr_g, st_g, n_g = _graph_serve(argv, graph=True, idle_first_slot=True)
    assert tr_g["served"][0] == tr_g["active"][0] == 0
    assert (tr_g, st_g, n_g) == (tr_e, st_e, n_e) and len(st_g) > 0
    assert graph.graph_replays == graph.decode_dispatches + graph.prefill_dispatches
    assert graph.decode_dispatches > 0
    if "sync" in path or "chunked" in path:
        assert graph.blocking_syncs == 0


# two replicas on one card, each with its own graphs; replica 1 fails at slot 5
FLEET_PATHS = {"sync": ["--sync-free", "--replicas", "2"],
               "paged_chunked": ["--paged"] + GRAPH_CHUNKED + ["--replicas", "2"]}


@pytest.mark.gpu
@pytest.mark.parametrize("path", sorted(FLEET_PATHS))
def test_fleet_graph_serve_equals_eager_with_a_failure_on_card(cuda, path):
    """A 2-replica fleet (``--replicas 2``), graphed against eager, replica 1
    failing mid-serve: the same trace, streams and launch counts; every
    dispatch of every replica a replay (the failed one's before it failed,
    none after), no blocking sync, its requests requeued to the survivor."""
    argv = GRAPH_SERVE + FLEET_PATHS[path]
    eager, tr_e, st_e, n_e = _graph_serve(argv, graph=False, fail_at=5)
    graph, tr_g, st_g, n_g = _graph_serve(argv, graph=True, fail_at=5)
    assert (tr_g, st_g, n_g) == (tr_e, st_e, n_e) and len(st_g) > 0
    assert graph.requeues == eager.requeues > 0 and graph.alive == [True, False]
    assert graph.replicas[0].model is graph.replicas[1].model
    assert graph.graph_replays == graph.decode_dispatches + graph.prefill_dispatches > 0
    dead = graph.replicas[1]
    assert dead.graph_replays == dead.decode_dispatches + dead.prefill_dispatches
    assert graph.blocking_syncs == 0


@pytest.mark.gpu
def test_decode_captured_mid_serve_counts_its_sync_on_card(cuda):
    """An engine stepped without ``warm_decode`` captures at its first
    dispatch, and that dispatch counts the capture's device synchronize;
    ``warm_decode`` refuses an engine with an active row."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.runtime import Engine, EngineConfig, RequestSource

    cfg = get_config("granite-3-2b", smoke=True)
    eng = Engine(init_params(cfg, seed=0, device=cuda),
                 EngineConfig(batch_slots=2, prompt_len=16, cache_len=64))
    eng.submit(RequestSource(vocab_size=cfg.vocab_size, prompt_len=16, raw_rate=2,
                             max_new_tokens=20, seed=1).poll(0, 2.0))
    eng.step_slot_sync(0, n_steps=2)
    eng.step_slot_sync(1, n_steps=2)
    # slot 0 captured its admission's graph and its decode's, slot 1 replayed
    # the decode (it admitted nobody)
    assert eng.blocking_syncs == 2 and eng.graph_replays == 1
    with pytest.raises(RuntimeError, match="before any row is admitted"):
        eng.warm_decode(2)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fused", "sync", "chunked"])
def test_graph_decode_after_preemption_equals_eager_on_card(cuda, mode):
    """A pool too small for both rows to grow: a row is preempted between
    replays and recomputed, and the streams equal the eager engine's."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.runtime import PagedEngine, PagedEngineConfig, RequestSource
    from repro_torch.runtime.graph import DecodeGraph

    cfg = get_config("granite-3-2b", smoke=True)
    model = init_params(cfg, seed=0, device=cuda)
    reqs = RequestSource(vocab_size=cfg.vocab_size, prompt_len=64, raw_rate=2,
                         max_new_tokens=40, seed=5).poll(0, 2.0)
    out = {}
    for graph in (False, True):
        eng = PagedEngine(model, PagedEngineConfig(prompt_len=64, cache_len=128, page_size=16,
                                                   num_pages=12, max_active=2,
                                                   max_pages_per_req=7))
        DecodeGraph.enabled = graph
        try:
            eng.warm_decode(2, sync=mode == "sync", chunked=mode == "chunked")
            eng.submit([copy.deepcopy(r) for r in reqs])
            step = {"fused": eng.step_slot, "sync": eng.step_slot_sync,
                    "chunked": eng.step_slot_chunked}[mode]
            for t in range(80):
                step(t, n_steps=2)
                if len(eng.finished) == len(reqs):
                    break
        finally:
            DecodeGraph.enabled = True
        if mode != "fused":
            eng.drain()
        torch.cuda.synchronize()
        out[graph] = ({r.rid: r.generated for r in eng.finished}, eng.preemptions,
                      eng.graph_replays)
    assert out[True][0] == out[False][0] and len(out[True][0]) == len(reqs)
    assert out[True][1] == out[False][1] > 0
    assert out[True][2] > 0


@pytest.mark.gpu
def test_decode_graph_replays_and_counts_on_card(cuda):
    """DecodeGraph: the first call runs the body, later calls replay it over
    their inputs (a host array through pinned memory, a device tensor by a
    copy), the carry comes back in place, and the launches recorded at the
    capture are added once per replay."""
    from repro_torch import kernels
    from repro_torch.runtime.graph import DecodeGraph

    q = torch.randn(2, 8, 32, device=cuda)
    k = torch.randn(2, 64, 2, 32, device=cuda)
    v = torch.randn(2, 64, 2, 32, device=cuda)
    sp = torch.from_numpy(_ring(2, 64, np.array([40, 63]), empty_row0=False)).to(cuda)

    def body(pos, bias):
        o = k_decode.decode_attention(q + bias[:, None, None], k, v, sp, pos)
        return (pos, bias + 1.0), (o,)

    g = DecodeGraph("test", cuda)
    kernels.reset_launch_counts()
    pos = np.array([40, 63], np.int32)
    bias = torch.zeros(2, device=cuda)
    outs = []
    for _ in range(4):
        (p, bias), (o,) = g(body, (pos, bias), fixed=(k, v), key=1)
        outs.append(o.clone())
    torch.cuda.synchronize()
    p_t = torch.from_numpy(pos).to(cuda)
    for i, o in enumerate(outs):
        want = ref.decode_attention_ref(q + float(i), k, v, sp, p_t)
        assert _err_ok(o, want, torch.float32)
    assert g.replays == 3 and torch.equal(bias, torch.full((2,), 4.0, device=cuda))
    assert kernels.launch_counts()["decode_attention"] == 4
    assert g.launches == {"decode_attention": 1}


@pytest.mark.gpu
def test_decode_graph_refuses_what_it_was_not_captured_for_on_card(cuda):
    from repro_torch.runtime.graph import DecodeGraph

    g = DecodeGraph("test", cuda)
    body = lambda x: ((x + 1,), (x * 2,))
    x = torch.zeros(4, device=cuda)
    g(body, (x,), key=2)
    with pytest.raises(ValueError, match="captured for"):
        g(body, (torch.zeros(5, device=cuda),), key=2)
    with pytest.raises(ValueError, match="captured for"):
        g(body, (torch.zeros(4, dtype=torch.int32, device=cuda),), key=2)
    with pytest.raises(ValueError, match="captured for 2"):
        g(body, (x,), key=3)
    with pytest.raises(RuntimeError, match="other cache tensors"):
        g(body, (x,), fixed=(x,), key=2)


@pytest.mark.gpu
def test_engine_refuses_another_step_count_after_capture_on_card(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.runtime import Engine, EngineConfig, RequestSource

    cfg = get_config("granite-3-2b", smoke=True)
    eng = Engine(init_params(cfg, seed=0, device=cuda),
                 EngineConfig(batch_slots=2, prompt_len=16, cache_len=64))
    eng.submit(RequestSource(vocab_size=cfg.vocab_size, prompt_len=16, raw_rate=2,
                             max_new_tokens=20, seed=1).poll(0, 2.0))
    eng.step_slot(0, n_steps=2)
    eng.step_slot(1, n_steps=2)
    with pytest.raises(ValueError, match="captured for 2"):
        eng.step_slot(2, n_steps=3)


@pytest.mark.gpu
def test_sampled_graph_refuses_other_tables_on_card(cuda):
    """The sampled sync-free graph was captured over tables of the engine's
    rows: a replay over tables of another shape raises, and so does the
    chunk graph under another chunk width."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.runtime import Engine, EngineConfig, RequestSource, SamplingParams

    cfg = get_config("granite-3-2b", smoke=True)
    eng = Engine(init_params(cfg, seed=0, device=cuda),
                 EngineConfig(batch_slots=2, prompt_len=16, cache_len=64,
                              sampling=SamplingParams(temperature=0.8, seed=3)))
    eng.warm_decode(2, chunked=True)
    assert set(eng._graphs) == {"chunk", "chunk+s", "sync", "sync+s"}
    eng.submit(RequestSource(vocab_size=cfg.vocab_size, prompt_len=16, raw_rate=2,
                             max_new_tokens=20, seed=1).poll(0, 2.0))
    for t in range(6):
        eng.step_slot_chunked(t, n_steps=2)
    assert eng._graphs["sync+s"].replays > 0 and eng._graphs["chunk+s"].replays > 0
    tables = eng._samp_args
    eng._samp_args = lambda force=None: tuple(a[:1] for a in tables(force))
    with pytest.raises(ValueError, match="captured for"):
        eng._decode_sync(2)
    eng._samp_args = tables
    eng._chunk = 8
    with pytest.raises(ValueError, match="captured for"):
        eng._chunk_decode_sync(eng._idle_plan(), 2)


@pytest.mark.gpu
def test_decode_graph_capture_failure_raises_on_card(cuda):
    """A body that reads back to the host cannot be captured: the capture
    raises (the eager warm-up ran), and nothing falls back."""
    from repro_torch.runtime.graph import DecodeGraph

    g = DecodeGraph("test", cuda)
    body = lambda x: ((x + float(x.sum().item()),), (x,))
    with pytest.raises(RuntimeError, match="capture of the test decode failed"):
        g(body, (torch.ones(3, device=cuda),))
    assert g.graph is None
    assert torch.ones(3, device=cuda).sum().item() == 3.0


# ----------------------------------------------------------- K2q at hd 256
@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["int8", "fp8"])
@pytest.mark.parametrize("H", [10, 8])
@pytest.mark.parametrize("B,L", HD256_RINGS)
def test_decode_quant_kernel_at_hd256_matches_plain_on_card(cuda, prec, B, L, H):
    """K2q at hd 256 on one KV head (recurrentgemma-2b's group of 10,
    paligemma-3b's of 8), in bf16 and float32, against
    ``decode_attention_quant_ref``: wrapped rings, rows at split16's edges,
    rows with a single valid slot on a rank's last slot, windows inside a
    tile, across the ranks' tiles and of 2048, and rows with no valid slot
    (the mean of the dequantized ring's V); bit for bit K2 over the
    dequantized ring; two launches equal."""
    KVH, hd = 1, 256
    for dtype in (torch.bfloat16, torch.float32):
        rng = np.random.default_rng(L + B + H + len(prec))
        q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32)).to(cuda, dtype)
        qk, qv, ks, vs = _codes_on_card(cuda, rng, (B, L, KVH, hd), prec)
        dk, dv = dequantize_kv(qk, ks, dtype), dequantize_kv(qv, vs, dtype)
        for label, pos_np, sp_np in _hd256_rings(rng, B, L, dtype):
            sp, pos = torch.from_numpy(sp_np).to(cuda), torch.from_numpy(pos_np).to(cuda)
            for window in (None, 45, 50, 200, 2048):
                got = k_decode.decode_attention_quant(q, qk, qv, ks, vs, sp, pos, window=window)
                want = ref.decode_attention_quant_ref(q, qk, qv, ks, vs, sp, pos, window=window)
                torch.cuda.synchronize()
                assert torch.isfinite(got).all(), (dtype, label, window)
                assert _err_ok(got, want, dtype), (dtype, label, pos_np, window)
                assert torch.equal(got, k_decode.decode_attention(q, dk, dv, sp, pos,
                                                                  window=window)), (dtype, label)
            assert torch.equal(got, k_decode.decode_attention_quant(q, qk, qv, ks, vs, sp, pos,
                                                                    window=window))
        i = np.arange(L)
        rows = [np.full(L, -1), i + 10, np.where(i <= L // 4, i, -1)]
        sp = torch.from_numpy(np.stack([rows[b % 3] for b in range(B)]).astype(np.int32)).to(cuda)
        pos = torch.from_numpy(np.asarray([(L - 1, 5, L - 1)[b % 3] for b in range(B)],
                                          np.int32)).to(cuda)
        got = k_decode.decode_attention_quant(q, qk, qv, ks, vs, sp, pos, window=50)
        want = ref.decode_attention_quant_ref(q, qk, qv, ks, vs, sp, pos, window=50)
        torch.cuda.synchronize()
        for b in range(B):
            assert _err_ok(got[b], want[b], dtype), (dtype, b)
            assert _err_ok(got[b], dv[b].float().mean(0).repeat_interleave(H // KVH, 0),
                           dtype), (dtype, b)


# --------------------------------------------- the unscaled (cast) routes
# (storage, compute): every storage dtype under each compute dtype but its own
CAST_PAIRS = [(s, d) for d in (torch.float32, torch.bfloat16)
              for s in (torch.float16, torch.bfloat16, torch.float32, torch.float8_e4m3fn)
              if s != d]


def _stored(x: np.ndarray, store, cuda) -> torch.Tensor:
    """Seeded float32 values cast to the storage dtype on the card (+-1e30
    junk first brought to +-400, finite in every storage dtype: a masked
    slot's weight is exactly 0 in the plain versions, but 0 * inf is not)."""
    x = np.where(np.abs(x) > 1e29, np.sign(x) * 400.0, x).astype(np.float32)
    return torch.from_numpy(x).to(cuda).to(store)


@pytest.mark.gpu
@pytest.mark.parametrize("store,dtype", CAST_PAIRS)
@pytest.mark.parametrize("B,L,H,KVH,hd", [(3, 64, 8, 2, 32), (8, 1024, 32, 8, 64),
                                          (2, 100, 8, 1, 128), (3, 2048, 10, 1, 256),
                                          (8, 513, 8, 1, 256)])
def test_decode_cast_kernel_matches_plain_on_card(cuda, store, dtype, B, L, H, KVH, hd):
    """K2q's unscaled route over a cast ring (values spread over 1e-3..1e2,
    so float16 under bf16 rounds twice where a direct rounding would differ)
    against ``decode_attention_cast_ref``, and bit for bit K2 over the ring
    rounded to q's dtype by torch (``k.to(q.dtype)``, the reference's
    ``astype``); windows, wrapped rows, a row with no valid slot (the mean
    of the rounded V); two launches equal. At hd 256 (split16) in both
    dtypes, recurrentgemma-2b's group of 10 and paligemma-3b's of 8."""
    rng = np.random.default_rng(L + hd + H)
    spread = np.logspace(-3, 2, hd).astype(np.float32)
    k = _stored(rng.standard_normal((B, L, KVH, hd)).astype(np.float32) * spread, store, cuda)
    v = _stored(rng.standard_normal((B, L, KVH, hd)).astype(np.float32), store, cuda)
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32)).to(cuda, dtype)
    q = q / float(spread.max())
    pos_np = np.asarray([L // 2 - 1] + [L + 5 + 7 * b for b in range(1, B)], np.int32)
    sp_np = _ring(B, L, pos_np)
    sp_np[-1] = -1                    # a row with no valid slot
    sp, pos = torch.from_numpy(sp_np).to(cuda), torch.from_numpy(pos_np).to(cuda)
    kr, vr = k.to(dtype), v.to(dtype)
    for window in (None, 50):
        got = k_decode.decode_attention_cast(q, k, v, sp, pos, window=window)
        want = ref.decode_attention_cast_ref(q, k, v, sp, pos, window=window)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert _err_ok(got, want, dtype), window
        assert torch.equal(got, k_decode.decode_attention(q, kr, vr, sp, pos, window=window))
        assert _err_ok(got[-1], vr[-1].float().mean(0).repeat_interleave(H // KVH, 0), dtype)
    assert torch.equal(got, k_decode.decode_attention_cast(q, k, v, sp, pos, window=window))
    with pytest.raises(ValueError, match="float32 or bfloat16 q"):
        k_decode.decode_attention_cast(q, kr, vr, sp, pos)   # q's own dtype: K2's route


@pytest.mark.gpu
@pytest.mark.parametrize("store,dtype", CAST_PAIRS)
@pytest.mark.parametrize("B,MP,ps,H,KVH,hd", [(16, 64, 16, 32, 8, 64), (5, 9, 12, 8, 2, 128),
                                              (4, 3, 128, 8, 2, 32)])
def test_paged_cast_kernel_matches_plain_on_card(cuda, store, dtype, B, MP, ps, H, KVH, hd):
    """K3q's unscaled route over a cast pool against
    ``paged_decode_attention_cast_ref`` (random positions, a hole, an
    inactive row held finite), and bit for bit K3 over the pool rounded to
    q's dtype; two launches equal."""
    rng = np.random.default_rng(MP * ps + B + hd)
    pos = rng.integers(min(128, MP * ps // 2), MP * ps, B).astype(np.int32)
    pos[0] = -1
    k, v, bt, pos = paged_case(rng, B, MP, ps, KVH, hd, pos, holes=True)
    k, v = _stored(k, store, cuda), _stored(v, store, cuda)
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32)).to(cuda, dtype)
    bt, pos_t = torch.from_numpy(bt).to(cuda), torch.from_numpy(pos).to(cuda)
    got = k_paged_quant.paged_decode_attention_cast(q, k, v, bt, pos_t)
    want = ref.paged_decode_attention_cast_ref(q, k, v, bt, pos_t)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert _err_ok(got[1:], want[1:], dtype)
    assert torch.equal(got, k_paged.paged_decode_attention(q, k.to(dtype), v.to(dtype), bt, pos_t))
    assert torch.equal(got, k_paged_quant.paged_decode_attention_cast(q, k, v, bt, pos_t))


@pytest.mark.gpu
@pytest.mark.parametrize("store,dtype", CAST_PAIRS)
@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("B,C,MP,ps,H,KVH,hd", GPU_PAGED_CHUNK[:3])
def test_paged_chunk_cast_kernel_matches_plain_on_card(cuda, store, dtype, staged, B, C, MP, ps,
                                                       H, KVH, hd):
    """K4p's unscaled route over cast pages (the staging split at base 0,
    mid-page and L - 1, or no staging; K rising tile by tile and leading
    tiles with no key) against ``paged_chunk_attention_ref``, and bit for
    bit K4p over the pages rounded to q's dtype; two launches equal."""
    for variant in ("mix", "rising", "holes"):
        rng = np.random.default_rng(MP * ps + B + staged + hd)
        case = paged_chunk_case(rng, B, C, MP, ps, KVH, hd, "native", staged, variant)
        k, v, _, _, _, _, bt, pos0, valid, base, stk, stv = [
            None if t is None else t.to(cuda) for t in case]
        k, v = _stored(k.cpu().numpy(), store, cuda), _stored(v.cpu().numpy(), store, cuda)
        stk, stv = (None, None) if stk is None else (stk.to(dtype), stv.to(dtype))
        q = torch.from_numpy(rng.standard_normal((B, C, H, hd)).astype(np.float32)).to(cuda,
                                                                                       dtype)
        kw = dict(stage_k=stk, stage_v=stv, base=base)
        got = k_pchunk.paged_chunk_attention_cast(q, k, v, bt, pos0, valid, **kw)
        want = ref.paged_chunk_attention_ref(q, k, v, None, None, None, None, bt, pos0, valid,
                                             **kw)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), variant
        for b, n in enumerate(valid.tolist()):
            assert not got[b, n:].any()
        assert _err_ok(got, want, dtype), variant
        native = k_pchunk.paged_chunk_attention(q, k.to(dtype), v.to(dtype), None, None, None,
                                                None, bt, pos0, valid, **kw)
        assert torch.equal(got, native), variant
        if variant == "mix":
            assert torch.equal(got, k_pchunk.paged_chunk_attention_cast(q, k, v, bt, pos0, valid,
                                                                        **kw))
