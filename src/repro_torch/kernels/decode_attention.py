"""Wrapper of the hand-written decode attention kernel (csrc/decode_attention.cu).

Replaces the Pallas TPU kernel ``_decode_kernel`` (K2) of
``src/repro/kernels/decode_attention.py``. Decode attention is byte-bound
on the H100: each step reads the whole ring cache (B 8, L 1024, KVH 8,
hd 64 in bf16: 16.8 MB, ~5 us at 3.35 TB/s) for a few MFLOP. The kernel
reads each K/V tile once for all G query heads of its KV head (one warp
per query head), as the TPU kernel's group packing does. Its grid (KVH, B)
is 64 CTAs at B = 8, which leaves most of the 132 SMs idle; splitting L
across CTAs (flash-decoding) is the first redesign.

This wrapper takes CUDA tensors only and raises on anything the kernel does
not take; ``repro_torch.kernels.ops`` sends CPU tensors to the plain
version instead.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

# launches of the kernel: the wrapper counts where it launches, nowhere else
launches = {"decode_attention": 0}

_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (32, 64, 128)


def _fn():
    fn = build.library("decode_attention").decode_attention_fwd
    # q, k, v, slot_pos, pos, out; B, H, KVH, L, hd, window, is_bf16; scale; stream
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                               ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(hd: int, G: int) -> int:
    """Dynamic shared memory of one CTA at head dim ``hd``, group size ``G``."""
    return int(build.library("decode_attention").decode_attention_smem_bytes(hd, G))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     slot_pos: torch.Tensor, pos: torch.Tensor, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """q (B,H,hd), cache k/v (B,L,KVH,hd), slot_pos (B,L) int32, pos (B,)
    int32 -> (B,H,hd), on the card."""
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode_attention takes float32 or bfloat16 q/k/v of one "
                         f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    B, H, hd = q.shape
    _, L, KVH, hd_k = k.shape
    if (k.shape[0] != B or hd_k != hd or hd not in _HEAD_DIMS or H % KVH
            or H // KVH > 32):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)}: need "
                         f"equal B, hd in {_HEAD_DIMS}, H % KVH == 0, H/KVH <= 32")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if slot_pos.dtype != torch.int32 or slot_pos.shape != (B, L):
        raise ValueError(f"slot_pos must be ({B}, {L}) int32")
    if pos.dtype != torch.int32 or pos.shape != (B,):
        raise ValueError(f"pos must be ({B},) int32")
    for name, t in (("q", q), ("k", k), ("v", v), ("slot_pos", slot_pos),
                    ("pos", pos)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:   # the kernel reads rows with 16-byte loads
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(q)
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), slot_pos.data_ptr(),
                pos.data_ptr(), out.data_ptr(), B, H, KVH, L, hd,
                -1 if window is None else int(window),
                int(q.dtype == torch.bfloat16), hd ** -0.5,
                torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention_fwd failed: cudaError_t {err}")
    launches["decode_attention"] += 1
    return out
