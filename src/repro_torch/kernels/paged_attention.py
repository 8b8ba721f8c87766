"""Wrapper of the hand-written paged decode attention kernel
(csrc/paged_attention.cu).

Replaces the Pallas TPU kernel ``_paged_kernel`` (K3) of
``src/repro/kernels/paged_attention.py``, and with it the ``_pool_read``
gather the reference's model path runs before its einsum softmax: the
kernel reads each valid K/V row straight from its page through the block
table. Byte-bound on the H100: a step reads the valid pages' K/V once
(B 16, pos up to 1023, KVH 8, hd 64 in bf16: ~19 MB, ~6 us at 3.35 TB/s).

Rows with no valid slot come back as zeros (the plain version averages
page 0's V there); the engine discards them. This wrapper takes CUDA
tensors only and raises on anything the kernel does not take;
``repro_torch.kernels.ops`` sends CPU tensors to the plain version instead.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# launches of the kernel: the wrapper counts where it launches, nowhere else
launches = {"paged_decode_attention": 0}

_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (32, 64, 128)
_INT_MAX = 2 ** 31 - 1


def _fn():
    fn = build.library("paged_attention").paged_decode_attention_fwd
    # q, k_pages, v_pages, block_tables, pos, out; B, H, KVH, N, ps, MP, hd,
    # is_bf16; scale; stream
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                               ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(hd: int, G: int) -> int:
    """Dynamic shared memory of one CTA at head dim ``hd``, group size ``G``."""
    return int(build.library("paged_attention").paged_decode_attention_smem_bytes(hd, G))


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           block_tables: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """q (B,H,hd) roped; pools (N,ps,KVH,hd); block_tables (B,MP) int32
    (-1 = unallocated); pos (B,) int32, the position just written
    -> (B,H,hd), on the card."""
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError(f"paged_decode_attention takes float32 or bfloat16 q/k/v of one "
                         f"dtype, got {q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k_pages {tuple(k_pages.shape)} "
                         f"v_pages {tuple(v_pages.shape)}")
    B, H, hd = q.shape
    N, ps, KVH, hd_k = k_pages.shape
    if hd_k != hd or hd not in _HEAD_DIMS or H % KVH or H // KVH > 32:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k_pages {tuple(k_pages.shape)}: "
                         f"need equal hd in {_HEAD_DIMS}, H % KVH == 0, H/KVH <= 32")
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2 \
            or block_tables.shape[0] != B:
        raise ValueError(f"block_tables must be ({B}, MP) int32")
    MP = block_tables.shape[1]
    if N * ps > _INT_MAX or MP * ps > _INT_MAX:
        raise ValueError(f"pool of {N} x {ps} rows or table of {MP} pages too large")
    if pos.dtype != torch.int32 or pos.shape != (B,):
        raise ValueError(f"pos must be ({B},) int32")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("pos", pos)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:   # the kernel reads rows with 16-byte loads
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(q)
    err = _fn()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                block_tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
                B, H, KVH, N, ps, MP, hd, int(q.dtype == torch.bfloat16), hd ** -0.5,
                torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention_fwd failed: cudaError_t {err}")
    launches["paged_decode_attention"] += 1
    return out
