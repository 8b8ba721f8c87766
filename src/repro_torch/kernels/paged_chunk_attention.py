"""Wrappers of the hand-written chunked-prefill attention kernels over
quantized K/V and over a paged pool (csrc/paged_chunk_attention.cu): K4q
and K4p.

K4q replaces the quantized variant of the Pallas TPU kernel
``_chunk_kernel`` (``src/repro/kernels/chunk_attention.py``,
``quantized=True``): chunk attention over a dense cache of int8 or fp8
codes with one float32 scale per slot and KV head, dequantized as each
tile loads. K4p has no Pallas counterpart: it is the attention of the
reference's ``attn_chunk_paged``, which gathers the pool through the block
tables (dequantizing quantized pages) and concatenates the native staging
buffer; the kernel reads each key in place from a native page, a quantized
page (K4q's arithmetic) or the staging buffer. At the chunked serve's mix
(B 8-16, C 128, H 32 on KVH 8, hd 64) both are byte-bound on the tensor
cores; like K4 they compute on the CUDA cores in f32 FMAs, so FMA issue
bounds them.

These wrappers take CUDA tensors only and raise on anything the kernels do
not take; ``repro_torch.kernels.ops`` sends CPU tensors to the plain
versions instead.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

# launches of each kernel: the wrappers count where they launch, nowhere else.
# K4p counts its launches over a pool with a quantized region apart
# ("paged_chunk_attention_quant"): those run K4q's dequantizing loads.
launches = {"chunk_attention_quant": 0, "paged_chunk_attention": 0,
            "paged_chunk_attention_quant": 0}

_DTYPES = (torch.float32, torch.bfloat16)
_CODES = (torch.int8, torch.float8_e4m3fn)
_HEAD_DIMS = (32, 64, 128)
_INT_MAX = 2 ** 31 - 1


def _lib():
    return build.library("paged_chunk_attention")


def smem_bytes(hd: int) -> int:
    """Dynamic shared memory of one CTA at head dim ``hd``."""
    return int(_lib().paged_chunk_attention_smem_bytes(hd))


def _check(named: list, dtype_of: dict) -> None:
    """Contiguity, device and 16-byte alignment of the named tensors (None
    skipped), and their dtypes where ``dtype_of`` names one."""
    dev = named[0][1].device
    for name, t in named:
        if t is None:
            continue
        if name in dtype_of and t.dtype != dtype_of[name]:
            raise ValueError(f"{name} must be {dtype_of[name]}, got {t.dtype}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")
        if t.dim() == 4 and t.data_ptr() % 16:   # rows are read with 16-byte loads
            raise ValueError(f"{name} must be 16-byte aligned")


def _qshape(q: torch.Tensor, codes: torch.Tensor) -> tuple:
    if q.device.type != "cuda":
        raise ValueError(f"the chunk attention kernels need CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES or q.dim() != 4:
        raise ValueError(f"q must be (B, C, H, hd) float32 or bfloat16, got {q.dtype} "
                         f"{tuple(q.shape)}")
    B, C, H, hd = q.shape
    if codes is not None and codes.dtype not in _CODES:
        raise ValueError(f"codes must be int8 or float8_e4m3fn, got {codes.dtype}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {_HEAD_DIMS}")
    return B, C, H, hd


def chunk_attention_quant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          k_scale: torch.Tensor, v_scale: torch.Tensor,
                          slot_pos: torch.Tensor, pos0: torch.Tensor,
                          valid: torch.Tensor) -> torch.Tensor:
    """K4q: q (B,C,H,hd) bf16/f32; codes k/v (B,L,KVH,hd) int8 or
    float8_e4m3fn; scales (B,L,KVH) float32; slot_pos (B,L) int32; pos0 and
    valid (B,) int32 -> (B,C,H,hd), on the card. Query rows at or beyond
    ``valid`` are zeros."""
    B, C, H, hd = _qshape(q, k)
    if k.dim() != 4 or k.shape != v.shape or v.dtype != k.dtype or k.shape[0] != B \
            or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    _, L, KVH, _ = k.shape
    if k_scale.shape != (B, L, KVH) or v_scale.shape != (B, L, KVH):
        raise ValueError(f"k_scale/v_scale must be ({B}, {L}, {KVH})")
    if slot_pos.shape != (B, L) or pos0.shape != (B,) or valid.shape != (B,):
        raise ValueError(f"slot_pos must be ({B}, {L}), pos0 and valid ({B},)")
    if B * L > _INT_MAX:
        raise ValueError(f"cache of {B} x {L} rows too large")
    i32, f32 = torch.int32, torch.float32
    _check([("q", q), ("k", k), ("v", v), ("k_scale", k_scale), ("v_scale", v_scale),
            ("slot_pos", slot_pos), ("pos0", pos0), ("valid", valid)],
           {"k_scale": f32, "v_scale": f32, "slot_pos": i32, "pos0": i32, "valid": i32})
    out = torch.empty_like(q)
    fn = _lib().chunk_attention_quant_fwd
    # q, k, v, k_scale, v_scale, slot_pos, pos0, valid, out; B, C, L, H, KVH, hd,
    # is_bf16, is_fp8; scale; stream
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
             slot_pos.data_ptr(), pos0.data_ptr(), valid.data_ptr(), out.data_ptr(),
             B, C, L, H, KVH, hd, int(q.dtype == torch.bfloat16),
             int(k.dtype == torch.float8_e4m3fn), hd ** -0.5,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"chunk_attention_quant_fwd failed: cudaError_t {err}")
    launches["chunk_attention_quant"] += 1
    return out


def paged_chunk_attention(q: torch.Tensor, k_pages: Optional[torch.Tensor],
                          v_pages: Optional[torch.Tensor], qk_pages: Optional[torch.Tensor],
                          qv_pages: Optional[torch.Tensor], k_scale: Optional[torch.Tensor],
                          v_scale: Optional[torch.Tensor], block_tables: torch.Tensor,
                          pos0: torch.Tensor, valid: torch.Tensor, *,
                          stage_k: Optional[torch.Tensor] = None,
                          stage_v: Optional[torch.Tensor] = None,
                          base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4p: q (B,C,H,hd) bf16/f32, roped; native pages (N_n,ps,KVH,hd) in
    q's dtype or None; quantized pages (N_q,ps,KVH,hd) int8/float8_e4m3fn
    with scales (N_q,ps,KVH) float32, or None; block_tables (B,MP) int32
    (ids below N_n native, the rest quantized at id - N_n; -1 =
    unallocated); pos0, valid (B,) int32; staging buffers (B,S,KVH,hd) in
    q's dtype with ``base`` (B,) int32, or None -> (B,C,H,hd), on the card.
    Query rows at or beyond ``valid`` are zeros."""
    B, C, H, hd = _qshape(q, qk_pages)
    if (k_pages is None) != (v_pages is None) or (qk_pages is None) != (qv_pages is None) \
            or (stage_k is None) != (stage_v is None):
        raise ValueError("k/v pages, quantized pages and staging buffers come in pairs")
    if k_pages is None and qk_pages is None:
        raise ValueError("the pool has no pages")
    if stage_k is not None and base is None:
        raise ValueError("staging needs base")
    ref = k_pages if k_pages is not None else qk_pages
    _, ps, KVH, hd_k = ref.shape
    if hd_k != hd or H % KVH:
        raise ValueError(f"bad shapes q {tuple(q.shape)} pages {tuple(ref.shape)}")
    Nn = 0 if k_pages is None else k_pages.shape[0]
    Nq = 0 if qk_pages is None else qk_pages.shape[0]
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t is not None and t.shape != (Nn, ps, KVH, hd):
            raise ValueError(f"{name} must be ({Nn}, {ps}, {KVH}, {hd})")
    if qk_pages is not None:
        if qv_pages.shape != (Nq, ps, KVH, hd) or qk_pages.shape != (Nq, ps, KVH, hd) \
                or qv_pages.dtype != qk_pages.dtype:
            raise ValueError(f"quantized pages must be ({Nq}, {ps}, {KVH}, {hd}) of one dtype")
        if k_scale is None or v_scale is None or k_scale.shape != (Nq, ps, KVH) \
                or v_scale.shape != (Nq, ps, KVH):
            raise ValueError(f"k_scale/v_scale must be ({Nq}, {ps}, {KVH})")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"block_tables must be ({B}, MP)")
    MP = block_tables.shape[1]
    S = 0
    if stage_k is not None:
        S = stage_k.shape[1]
        if stage_k.shape != (B, S, KVH, hd) or stage_v.shape != stage_k.shape:
            raise ValueError(f"staging buffers must be ({B}, S, {KVH}, {hd})")
    if pos0.shape != (B,) or valid.shape != (B,) or (base is not None and base.shape != (B,)):
        raise ValueError(f"pos0, valid and base must be ({B},)")
    if (Nn + Nq) * ps > _INT_MAX or MP * ps > _INT_MAX or B * S > _INT_MAX:
        raise ValueError("pool, table or staging buffers too large")
    i32, f32 = torch.int32, torch.float32
    _check([("q", q), ("k_pages", k_pages), ("v_pages", v_pages), ("qk_pages", qk_pages),
            ("qv_pages", qv_pages), ("k_scale", k_scale), ("v_scale", v_scale),
            ("block_tables", block_tables), ("stage_k", stage_k), ("stage_v", stage_v),
            ("base", base if stage_k is not None else None), ("pos0", pos0),
            ("valid", valid)],
           {"k_pages": q.dtype, "v_pages": q.dtype, "stage_k": q.dtype, "stage_v": q.dtype,
            "k_scale": f32, "v_scale": f32, "block_tables": i32, "base": i32, "pos0": i32,
            "valid": i32})
    ptr = lambda t: 0 if t is None else t.data_ptr()
    out = torch.empty_like(q)
    fn = _lib().paged_chunk_attention_fwd
    # q, k_pages, v_pages, qk_pages, qv_pages, k_scale, v_scale, block_tables,
    # stage_k, stage_v, base, pos0, valid, out; B, C, H, KVH, Nn, Nq, ps, MP, S,
    # hd, is_bf16, is_fp8; scale; stream
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 12 + [ctypes.c_float,
                                                                 ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(q.data_ptr(), ptr(k_pages), ptr(v_pages), ptr(qk_pages), ptr(qv_pages),
             ptr(k_scale), ptr(v_scale), block_tables.data_ptr(), ptr(stage_k), ptr(stage_v),
             ptr(base) if stage_k is not None else 0, pos0.data_ptr(), valid.data_ptr(),
             out.data_ptr(), B, C, H, KVH, Nn, Nq, ps, MP, S, hd,
             int(q.dtype == torch.bfloat16),
             int(qk_pages is not None and qk_pages.dtype == torch.float8_e4m3fn), hd ** -0.5,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_chunk_attention_fwd failed: cudaError_t {err}")
    launches["paged_chunk_attention_quant" if Nq else "paged_chunk_attention"] += 1
    return out
