"""The attention kernels' plain versions against the reference's Pallas
kernels (interpret mode) and oracles. The CUDA kernels are held against
their plain versions on the card in tests/test_torch_kernels_gpu.py."""
import re
from pathlib import Path

import jax  # noqa: F401  (JAX stays on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro_torch.kernels import decode_attention as k_decode
from repro_torch.kernels import flash_attention as k_flash
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as k_paged
from repro_torch.kernels import rglru_scan as k_rglru
from test_torch_engine import one_torch_thread  # noqa: F401  (autouse fixture)

# float32 on both sides: the two softmaxes differ only in summation order
ATOL = 2e-5


def _qkv(seed, B, S, H, KVH, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd), np.float32),
            rng.standard_normal((B, S, KVH, hd), np.float32),
            rng.standard_normal((B, S, KVH, hd), np.float32))


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


PREFILL = [  # (B, S, H, KVH, hd, window)
    (2, 16, 4, 2, 32, None),
    (2, 16, 4, 2, 32, 5),
    (1, 8, 4, 1, 64, None),
    (2, 8, 8, 2, 32, 3),
    (2, 16, 10, 1, 256, 5),   # recurrentgemma-2b's heads: MQA at hd 256, windowed
]


@pytest.mark.parametrize("B,S,H,KVH,hd,window", PREFILL)
def test_plain_flash_matches_pallas_and_oracle(B, S, H, KVH, hd, window):
    q, k, v = _qkv(0, B, S, H, KVH, hd)
    got = ops.flash_attention(*_t(q, k, v), causal=True, window=window).numpy()
    pal = ref_ops.flash_attention(q, k, v, causal=True, window=window,
                                  impl="interpret", block_q=8, block_k=8)
    ora = ref_oracles.attention_ref(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(got, np.asarray(pal), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(ora), atol=ATOL, rtol=0)


@pytest.mark.parametrize("B,S,H,KVH,hd,window", PREFILL)
def test_plain_ragged_flash_matches_pallas_and_oracle(B, S, H, KVH, hd, window):
    q, k, v = _qkv(1, B, S, H, KVH, hd)
    lens = np.asarray([1, S, S // 2 + 1][:B] if B > 1 else [3], np.int32)
    got = ops.flash_attention(*_t(q, k, v), torch.from_numpy(lens), causal=True,
                              window=window).numpy()
    pal = ref_ops.flash_attention(q, k, v, jnp.asarray(lens), causal=True, window=window,
                                  impl="interpret", block_q=8, block_k=8)
    ora = ref_oracles.attention_ref(q, k, v, causal=True, window=window,
                                    seq_lens=jnp.asarray(lens))
    np.testing.assert_allclose(got, np.asarray(pal), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(ora), atol=ATOL, rtol=0)
    for b, n in enumerate(lens):
        assert not got[b, n:].any()    # rows at or beyond the length are zeros


def _ring(B, L, pos):
    """slot_pos of a ring cache at positions ``pos``: slot i holds the
    latest position p <= pos with p % L == i; row 0 has empty slots."""
    i = np.arange(L)[None, :]
    p = pos[:, None]
    sp = np.where(i <= p % L, p - p % L + i, p - p % L - L + i)
    sp = np.where(sp < 0, -1, sp).astype(np.int32)
    sp[0, L // 2:] = -1
    return sp


DECODE = [  # (B, L, H, KVH, hd, window)
    (3, 16, 4, 2, 32, None),
    (3, 16, 4, 2, 32, 6),
    (2, 32, 4, 1, 64, None),
    (2, 32, 8, 2, 32, 20),
    (3, 32, 10, 1, 256, 20),  # recurrentgemma-2b's heads: a group of 10 at hd 256
    # paligemma-3b's heads (8 on 1 at hd 256) under a window, on a ring whose
    # L is no multiple of split16's 32 x 16 slots
    (2, 520, 8, 1, 256, 300),
]


@pytest.mark.parametrize("B,L,H,KVH,hd,window", DECODE)
def test_plain_decode_matches_pallas_and_oracle(B, L, H, KVH, hd, window):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((B, H, hd), np.float32)
    k = rng.standard_normal((B, L, KVH, hd), np.float32)
    v = rng.standard_normal((B, L, KVH, hd), np.float32)
    pos = np.asarray([L // 2 - 1, L + 5, 3 * L - 1][:B], np.int32)  # ring wraps
    sp = _ring(B, L, pos)
    got = ops.decode_attention(*_t(q, k, v, sp, pos), window=window).numpy()
    pal = ref_ops.decode_attention(q, k, v, sp, pos, window=window,
                                   impl="interpret", block_l=8)
    ora = ref_oracles.decode_attention_ref(q, k, v, sp, pos, window=window)
    np.testing.assert_allclose(got, np.asarray(pal), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(ora), atol=ATOL, rtol=0)


def test_cuda_wrappers_refuse_cpu_tensors():
    q, k, v = _t(*_qkv(3, 1, 8, 4, 2, 32))
    with pytest.raises(ValueError, match="CUDA"):
        k_flash.flash_attention(q, k, v)
    pos = torch.zeros(1, dtype=torch.int32)
    sp = torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        k_decode.decode_attention(q[:, 0], k, v, sp, pos)
    with pytest.raises(ValueError, match="CUDA"):   # k, v as a pool of 1 x 8-row pages
        k_paged.paged_decode_attention(q[:, 0], k, v, torch.zeros(1, 1, dtype=torch.int32),
                                       pos)
    with pytest.raises(ValueError, match="CUDA"):
        k_rglru.rglru_scan(q[..., 0, :], q[..., 0, :])


def _header_routes() -> dict:
    """The route table of csrc/flash_attention.cu's header: (q dtype,
    quantized K/V) -> {hd: route}."""
    text = (Path(k_flash.__file__).parent / "csrc" / "flash_attention.cu").read_text()
    table = text[text.index("// Routes"):].split("\n//\n", 1)[0]
    names = {"wide": "wide", "wgmma": "wgmma", "CUDA cores": "cuda_cores"}
    out: dict = {}
    for line in table.splitlines()[2:]:
        m = re.match(r"//\s+(wide|wgmma|CUDA cores)\s+(bf16|f32)\s+(native|codes)\s+([\d, ]+)$",
                     line)
        assert m, line
        key = (torch.bfloat16 if m.group(2) == "bf16" else torch.float32, m.group(3) == "codes")
        for hd in m.group(4).split(","):
            assert int(hd) not in out.setdefault(key, {}), line
            out[key][int(hd)] = names[m.group(1)]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quantized", [False, True])
def test_flash_route_is_the_headers_table(dtype, quantized):
    """``flash_attention.route`` (the route the wrapper counts under, and the
    card test holds the library to) states the table of the source's
    header, and refuses every hd the table leaves out."""
    table = _header_routes()[(dtype, quantized)]
    for hd in (16, 32, 64, 96, 128, 256, 512):
        if hd in table:
            assert k_flash.route(dtype, hd, quantized) == table[hd], hd
        else:
            with pytest.raises(ValueError, match="no flash_attention route"):
                k_flash.route(dtype, hd, quantized)


def test_flash_counters_follow_the_route():
    """K1 and K1r count under the wide route's counters exactly where it
    serves (bf16 at hd 128 and 256), and both map to its kernel function."""
    from repro_torch import kernels
    for dtype in (torch.float32, torch.bfloat16):
        for hd in (32, 64, 128, 256):
            wide = dtype == torch.bfloat16 and hd >= 128
            for ragged in (False, True):
                name = k_flash.counter(dtype, hd, ragged)
                assert name == ("flash_attention" + ("_wide" if wide else "")
                                + ("_ragged" if ragged else ""))
                assert name in k_flash.launches
                assert kernels.kernel_function(name) == (
                    "flash_attention_wide_kernel" if wide else "flash_attention_kernel")


def _header_decode_routes() -> dict:
    """The route table of csrc/decode_core.cuh's header: q dtype -> {hd:
    (route, tile, split, stages)}."""
    text = (Path(k_decode.__file__).parent / "csrc" / "decode_core.cuh").read_text()
    table = text[text.index("// Routes"):].split("\n//\n", 1)[0]
    out: dict = {}
    for line in table.splitlines()[2:]:
        m = re.match(r"//\s+(split\d+)\s+(bf16|f32)\s+(\d+(?:, \d+)*)\s+(\d+)\s+(\d+)\s+(\d+)\s",
                     line)
        assert m, line
        key = torch.bfloat16 if m.group(2) == "bf16" else torch.float32
        for hd in m.group(3).split(","):
            assert int(hd) not in out.setdefault(key, {}), line
            out[key][int(hd)] = (m.group(1), *(int(m.group(i)) for i in (4, 5, 6)))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_route_is_the_headers_table(dtype):
    """``decode_attention.route`` (the geometry the wrappers check, the card
    tests build their edges on and chip_smoke.py names its rows by) states
    the table of csrc/decode_core.cuh's header, counts under K2's counter,
    and refuses every hd the table leaves out."""
    table = _header_decode_routes()[dtype]
    for hd in (16, 32, 64, 96, 128, 256, 512):
        if hd in table:
            rt = k_decode.route(dtype, hd)
            assert (rt["name"], rt["tile"], rt["split"], rt["stages"]) == table[hd], hd
            assert rt["counter"] == "decode_attention" and rt["counter"] in k_decode.launches
        else:
            with pytest.raises(ValueError, match="no decode_attention route"):
                k_decode.route(dtype, hd)
    assert set(table) == {32, 64, 128, 256}
