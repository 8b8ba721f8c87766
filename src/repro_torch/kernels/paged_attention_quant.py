"""Wrapper of the hand-written quantized and mixed paged decode attention
kernel (csrc/paged_attention_quant.cu, K3q).

Replaces the quantized variant of the Pallas TPU kernel ``_paged_kernel``
(``src/repro/kernels/paged_attention.py``, ``quantized=True``) and the
reference model path's ``_pool_read``, which gathers and dequantizes a
mixed two-region pool before its einsum softmax: the kernel reads each
valid row through the block table from its region, int8 or fp8 codes with
their float32 scale dequantized right after the load. Byte-bound on the
H100: at the paged serve's shapes (B 16, pos up to 1023, KVH 8, hd 64) an
all-int8 step reads ~10 MB of codes and scales, ~3 us at 3.35 TB/s.

This wrapper takes CUDA tensors only and raises on anything the kernel
does not take; ``repro_torch.kernels.ops`` sends CPU tensors to the plain
versions instead.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

# launches of the kernel: the wrapper counts where it launches, nowhere else
launches = {"paged_decode_attention_quant": 0}

_DTYPES = (torch.float32, torch.bfloat16)
_CODES = (torch.int8, torch.float8_e4m3fn)
_HEAD_DIMS = (32, 64, 128)
_INT_MAX = 2 ** 31 - 1


def _fn():
    fn = build.library("paged_attention_quant").paged_decode_attention_quant_fwd
    # q, k_pages, v_pages, qk_pages, qv_pages, k_scale, v_scale, block_tables,
    # pos, out; B, H, KVH, Nn, Nq, ps, MP, hd, is_bf16, is_fp8; scale; stream
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_float,
                                                                 ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(hd: int, G: int) -> int:
    """Dynamic shared memory of one CTA at head dim ``hd``, group size ``G``."""
    lib = build.library("paged_attention_quant")
    return int(lib.paged_decode_attention_quant_smem_bytes(hd, G))


def paged_decode_attention_quant(q: torch.Tensor, k_pages: Optional[torch.Tensor],
                                 v_pages: Optional[torch.Tensor], qk_pages: torch.Tensor,
                                 qv_pages: torch.Tensor, k_scale: torch.Tensor,
                                 v_scale: torch.Tensor, block_tables: torch.Tensor,
                                 pos: torch.Tensor) -> torch.Tensor:
    """q (B,H,hd) roped; native pools (N_n,ps,KVH,hd) in q's dtype, or None
    for a pool with no native region; quantized pools (N_q,ps,KVH,hd) int8
    or float8_e4m3fn with scales (N_q,ps,KVH) float32; block_tables (B,MP)
    int32 (ids below N_n native, the rest quantized at id - N_n; -1 =
    unallocated); pos (B,) int32 -> (B,H,hd), on the card."""
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention_quant kernel needs CUDA tensors, got {q.device}")
    if (k_pages is None) != (v_pages is None):
        raise ValueError("k_pages and v_pages come in pairs")
    if q.dtype not in _DTYPES or qk_pages.dtype not in _CODES or qv_pages.dtype != qk_pages.dtype:
        raise ValueError(f"paged_decode_attention_quant takes float32 or bfloat16 q and int8 or "
                         f"float8_e4m3fn codes, got {q.dtype}/{qk_pages.dtype}/{qv_pages.dtype}")
    if q.dim() != 3 or qk_pages.dim() != 4 or qk_pages.shape != qv_pages.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} qk_pages {tuple(qk_pages.shape)} "
                         f"qv_pages {tuple(qv_pages.shape)}")
    B, H, hd = q.shape
    Nq, ps, KVH, hd_k = qk_pages.shape
    if hd_k != hd or hd not in _HEAD_DIMS or H % KVH or H // KVH > 32 or Nq == 0:
        raise ValueError(f"bad shapes q {tuple(q.shape)} qk_pages {tuple(qk_pages.shape)}: "
                         f"need equal hd in {_HEAD_DIMS}, H % KVH == 0, H/KVH <= 32, N_q > 0")
    if k_scale.dtype != torch.float32 or k_scale.shape != (Nq, ps, KVH) \
            or v_scale.shape != k_scale.shape or v_scale.dtype != torch.float32:
        raise ValueError(f"k_scale/v_scale must be ({Nq}, {ps}, {KVH}) float32")
    Nn = 0
    if k_pages is not None:
        Nn = k_pages.shape[0]
        if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype or \
                k_pages.shape[1:] != qk_pages.shape[1:] or v_pages.shape != k_pages.shape:
            raise ValueError(f"native pools must be (N_n, {ps}, {KVH}, {hd}) {q.dtype}")
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2 \
            or block_tables.shape[0] != B:
        raise ValueError(f"block_tables must be ({B}, MP) int32")
    MP = block_tables.shape[1]
    if (Nn + Nq) * ps > _INT_MAX or MP * ps > _INT_MAX:
        raise ValueError(f"pool of {Nn + Nq} x {ps} rows or table of {MP} pages too large")
    if pos.dtype != torch.int32 or pos.shape != (B,):
        raise ValueError(f"pos must be ({B},) int32")
    named = [("q", q), ("qk_pages", qk_pages), ("qv_pages", qv_pages), ("k_scale", k_scale),
             ("v_scale", v_scale), ("block_tables", block_tables), ("pos", pos)]
    if k_pages is not None:
        named += [("k_pages", k_pages), ("v_pages", v_pages)]
    for name, t in named:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    for name, t in named[:3] + named[7:]:
        if t.data_ptr() % 16:   # the kernel reads rows with 16-byte loads
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(q)
    err = _fn()(q.data_ptr(), 0 if k_pages is None else k_pages.data_ptr(),
                0 if v_pages is None else v_pages.data_ptr(), qk_pages.data_ptr(),
                qv_pages.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
                block_tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
                B, H, KVH, Nn, Nq, ps, MP, hd, int(q.dtype == torch.bfloat16),
                int(qk_pages.dtype == torch.float8_e4m3fn), hd ** -0.5,
                torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention_quant_fwd failed: cudaError_t {err}")
    launches["paged_decode_attention_quant"] += 1
    return out
