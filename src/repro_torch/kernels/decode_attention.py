"""Wrappers of the hand-written decode attention kernels
(csrc/decode_attention.cu, csrc/decode_attention_quant.cu).

``decode_attention`` replaces the Pallas TPU kernel ``_decode_kernel`` (K2)
of ``src/repro/kernels/decode_attention.py``; ``decode_attention_quant``
(K2q) is K2 over a quantized ring (int8 or fp8 codes with per-token-per-head
scales), which has no Pallas kernel: the reference's ``attn_decode``
dequantizes the whole ring in XLA first. Decode attention is byte-bound
on the H100: each step reads the ring's valid slots (B 8, L 1024, KVH 8,
hd 64 in bf16: up to 16.8 MB, ~5 us at 3.35 TB/s; as int8 codes with their
scales 7.4 MB) for a few MFLOP. Both are flash-decoding in one launch on
one core (``csrc/decode_core.cuh``, shared with K3 and K3q): a cluster of 8
CTAs per (KV head, batch row) splits the ring's 64-slot tiles between
them, skips tiles with no valid slot before loading them, reads each K/V
tile once for all G query heads of its KV head (K2q's codes dequantized in
shared memory as ``dequantize_kv`` does; then bf16 products on the tensor
cores by mma.sync, f32 on the CUDA cores), and combines the 8 partial
softmax states through distributed shared memory. So K2q over codes equals
K2 over the dequantized ring bit for bit. A row with no valid slot gets
the mean of its ring's V, as from the plain version (a uniform softmax
over masked scores). ``decode_attention_cast`` is K2q's unscaled route,
over a ring held under an unscaled storage cast (float16, bfloat16,
float32 or float8_e4m3fn, not q's dtype; no scales): each stored value is
rounded to q's dtype as it lands in shared memory, as the reference's
``ck.astype(q.dtype)``, and the rest is K2's arithmetic.

These wrappers take CUDA tensors only and raise on anything the kernel
does not take; ``repro_torch.kernels.ops`` sends CPU tensors to the plain
versions instead. K2 and K2q (both routes) take head dims 32, 64, 128
and, in bf16, 256 (recurrentgemma-2b's MQA heads, a group of 10).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

# launches of the kernel: the wrapper counts where it launches, nowhere else
launches = {"decode_attention": 0, "decode_attention_quant": 0, "decode_attention_cast": 0}

_DTYPES = (torch.float32, torch.bfloat16)
_CODES = (torch.int8, torch.float8_e4m3fn)
_HEAD_DIMS = (32, 64, 128, 256)   # K2 and K2q; 256 in bf16 only
# the unscaled route's storage dtypes, by the code the C entry points take
STORE_CODES = {torch.float16: 0, torch.bfloat16: 1, torch.float32: 2, torch.float8_e4m3fn: 3}
SMEM_LIMIT = 232448                # the dynamic shared memory an H100 CTA may have


def _fn():
    fn = build.library("decode_attention").decode_attention_fwd
    # q, k, v, slot_pos, pos, out; B, H, KVH, L, hd, window, is_bf16; scale; stream
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                               ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _quant_fn():
    fn = build.library("decode_attention_quant").decode_attention_quant_fwd
    # q, k, v, k_scale, v_scale, slot_pos, pos, out; B, H, KVH, L, hd, window,
    # is_bf16, is_fp8; scale; stream
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                               ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _cast_fn():
    fn = build.library("decode_attention_quant").decode_attention_cast_fwd
    # q, k, v, slot_pos, pos, out; B, H, KVH, L, hd, window, is_bf16, store; scale; stream
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                               ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(hd: int, G: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Dynamic shared memory of one CTA at head dim ``hd``, group size ``G``
    and ``dtype`` (float32 or bfloat16)."""
    lib = build.library("decode_attention")
    return int(lib.decode_attention_smem_bytes(hd, G, int(dtype == torch.bfloat16)))


def quant_smem_bytes(hd: int, G: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """``smem_bytes`` of the quantized kernel (K2q), whose codes land in
    the rows of ``dtype``'s tiles: K2's shared memory."""
    lib = build.library("decode_attention_quant")
    return int(lib.decode_attention_quant_smem_bytes(hd, G, int(dtype == torch.bfloat16)))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, slot_pos: torch.Tensor,
           pos: torch.Tensor, window: Optional[int], kv_dtypes,
           head_dims=_HEAD_DIMS) -> None:
    """Raise on anything the kernels do not take."""
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES or k.dtype not in kv_dtypes or v.dtype != k.dtype:
        raise ValueError(f"decode_attention takes float32 or bfloat16 q with k/v of "
                         f"{kv_dtypes}, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    B, H, hd = q.shape
    _, L, KVH, hd_k = k.shape
    if (k.shape[0] != B or hd_k != hd or hd not in head_dims or H % KVH
            or H // KVH > 32):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)}: need "
                         f"equal B, hd in {head_dims}, H % KVH == 0, H/KVH <= 32")
    if hd == 256 and q.dtype == torch.float32:
        need = smem_bytes(256, H // KVH, torch.float32)
        raise ValueError(f"decode_attention in float32 at hd 256 needs {need} bytes of "
                         f"shared memory a CTA (two stages of 64 K and V rows of 1,040 "
                         f"bytes), above the {SMEM_LIMIT} an H100 CTA may have: it runs "
                         "in bfloat16 only")
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


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     slot_pos: torch.Tensor, pos: torch.Tensor, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """q (B,H,hd), cache k/v (B,L,KVH,hd), slot_pos (B,L) int32, pos (B,)
    int32 -> (B,H,hd), on the card."""
    _check(q, k, v, slot_pos, pos, window, (q.dtype,))
    B, H, hd = q.shape
    _, L, KVH, _ = k.shape
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


def decode_attention_quant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           k_scale: torch.Tensor, v_scale: torch.Tensor,
                           slot_pos: torch.Tensor, pos: torch.Tensor, *,
                           window: Optional[int] = None) -> torch.Tensor:
    """K2q: q (B,H,hd) float32 or bfloat16, ring codes k/v (B,L,KVH,hd) int8
    or float8_e4m3fn with k_scale/v_scale (B,L,KVH) float32, slot_pos (B,L)
    int32, pos (B,) int32 -> (B,H,hd) in q's dtype, on the card."""
    _check(q, k, v, slot_pos, pos, window, _CODES)
    B, H, hd = q.shape
    _, L, KVH, _ = k.shape
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if (t.dtype != torch.float32 or t.shape != (B, L, KVH) or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({B}, {L}, {KVH}) float32 "
                             f"tensor on {q.device}")
    out = torch.empty_like(q)
    err = _quant_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
                      v_scale.data_ptr(), slot_pos.data_ptr(), pos.data_ptr(),
                      out.data_ptr(), B, H, KVH, L, hd, -1 if window is None else int(window),
                      int(q.dtype == torch.bfloat16), int(k.dtype == torch.float8_e4m3fn),
                      hd ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention_quant_fwd failed: cudaError_t {err}")
    launches["decode_attention_quant"] += 1
    return out


def decode_attention_cast(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          slot_pos: torch.Tensor, pos: torch.Tensor, *,
                          window: Optional[int] = None) -> torch.Tensor:
    """K2q's unscaled route: q (B,H,hd) float32 or bfloat16, a cast ring k/v
    (B,L,KVH,hd) in float16, bfloat16, float32 or float8_e4m3fn other than
    q's dtype, slot_pos (B,L) int32, pos (B,) int32 -> (B,H,hd) in q's
    dtype, on the card."""
    _check(q, k, v, slot_pos, pos, window,
           tuple(dt for dt in STORE_CODES if dt != q.dtype))
    B, H, hd = q.shape
    _, L, KVH, _ = k.shape
    out = torch.empty_like(q)
    err = _cast_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), slot_pos.data_ptr(),
                     pos.data_ptr(), out.data_ptr(), B, H, KVH, L, hd,
                     -1 if window is None else int(window), int(q.dtype == torch.bfloat16),
                     STORE_CODES[k.dtype], hd ** -0.5,
                     torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention_cast_fwd failed: cudaError_t {err}")
    launches["decode_attention_cast"] += 1
    return out
