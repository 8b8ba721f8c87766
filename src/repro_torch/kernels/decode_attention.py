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
one core (``csrc/decode_core.cuh``, shared with K3 and K3q): a cluster of
CTAs per (KV head, batch row) splits the ring's tiles between them
(``route``: 8 CTAs over 64-slot tiles at hd <= 128; 16 over 32-slot tiles
at hd 256, where one KV head at B 8 would otherwise fill 64 of 132 SMs),
skips tiles with no valid slot before loading them, reads each K/V tile
once for all G query heads of its KV head (K2q's codes dequantized in
shared memory as ``dequantize_kv`` does; then bf16 products on the tensor
cores by mma.sync, f32 on the CUDA cores), and combines the partial
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
and 256 (recurrentgemma-2b's and paligemma-3b's MQA heads, groups of 10
and 8), in float32 and bfloat16.
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
_HEAD_DIMS = (32, 64, 128, 256)   # K2 and K2q, in both dtypes (``route``)
# the unscaled route's storage dtypes, by the code the C entry points take
STORE_CODES = {torch.float16: 0, torch.bfloat16: 1, torch.float32: 2, torch.float8_e4m3fn: 3}

# the routes of csrc/decode_core.cuh's table, by head dim (both dtypes):
# (name, slots a tile, CTAs a cluster, stages of the K/V ring)
_ROUTES = {32: ("split8", 64, 8, 2), 64: ("split8", 64, 8, 2), 128: ("split8", 64, 8, 2),
           256: ("split16", 32, 16, 2)}


def route(dtype: torch.dtype, hd: int) -> dict:
    """The route of K2 and K2q (and K3, K3q where they take ``hd``) for q of
    ``dtype`` at head dim ``hd``: its name, slots a tile (``tile``), CTAs a
    cluster (``split``: tile t goes to rank t % split), stages of the
    cp.async ring, and K2's launch counter (K2q's and the unscaled route's
    launches count under theirs on every route). Raises on what no route
    takes."""
    if dtype not in _DTYPES or hd not in _ROUTES:
        raise ValueError(f"no decode_attention route takes {dtype} q at hd {hd}: need "
                         f"float32 or bfloat16 and hd in {_HEAD_DIMS}")
    name, tile, split, stages = _ROUTES[hd]
    return {"name": name, "tile": tile, "split": split, "stages": stages,
            "counter": "decode_attention"}


def library_route(dtype: torch.dtype, hd: int) -> Optional[dict]:
    """(tile, split, stages) of the built library at (``dtype``, ``hd``), as
    ``route`` states them, or None where it takes no such hd."""
    fn = build.library("decode_attention").decode_attention_geometry
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    if fn(hd, int(dtype == torch.bfloat16), out) != 0:
        return None
    return {"tile": out[0], "split": out[1], "stages": out[2]}


def max_clusters(hd: int, G: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """How many clusters of K2's kernel at (``hd``, group ``G``, ``dtype``)
    the card holds at once (cudaOccupancyMaxActiveClusters): a launch of
    B * KVH clusters up to that runs in one wave."""
    fn = build.library("decode_attention").decode_attention_max_clusters
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    n = int(fn(hd, G, int(dtype == torch.bfloat16)))
    if n < 0:
        raise RuntimeError(f"decode_attention_max_clusters failed at hd {hd}, G {G}, {dtype}")
    return n


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


def cta_threads(hd: int, G: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Threads of one CTA of K2 (K2q, K3 and K3q take the same) at head dim
    ``hd``, group size ``G`` and ``dtype``; 0 where no route takes ``hd``."""
    lib = build.library("decode_attention")
    return int(lib.decode_attention_threads(hd, G, int(dtype == torch.bfloat16)))


def quant_smem_bytes(hd: int, G: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """``smem_bytes`` of the quantized kernel (K2q), whose codes land in
    the rows of ``dtype``'s tiles: K2's shared memory."""
    lib = build.library("decode_attention_quant")
    return int(lib.decode_attention_quant_smem_bytes(hd, G, int(dtype == torch.bfloat16)))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, slot_pos: torch.Tensor,
           pos: torch.Tensor, window: Optional[int], kv_dtypes) -> None:
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
    if k.shape[0] != B or hd_k != hd or H % KVH or H // KVH > 32:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)}: need "
                         f"equal B, equal hd, H % KVH == 0, H/KVH <= 32")
    route(q.dtype, hd)
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
