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

from repro_torch.kernels import decode_attention as k_decode
from repro_torch.kernels import flash_attention as k_flash
from repro_torch.kernels import ref


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
