"""Wrappers of the hand-written prefill attention kernel (csrc/flash_attention.cu).

Replaces the Pallas TPU kernels ``_attn_kernel`` (K1) and
``_attn_kernel_ragged`` (K1r) of ``src/repro/kernels/flash_attention.py``,
and their ``quantized=True`` variants (K1q, K1rq) through
``flash_attention_quant``: the same kernel over int8 or fp8 K/V codes,
each tile dequantized in shared memory before its products.

One CTA per (64-row q-tile, head, batch row) loops over the live KV tiles
with the online softmax in registers and skips tiles above the diagonal,
outside the window or in the row's padding. For bf16 q the CTA is one
warpgroup that runs QK^T and PV on the tensor cores (wgmma), fed by a
two-stage ring of cp.async copies, so the next tile's loads overlap this
tile's products. At serving shapes (B 8, S 512, H 32, hd 64: ~8.6 GFLOP
causal against ~42 MB) the work is byte-bound on the tensor cores; what
holds the kernel above that bound is issue: each CTA's serial chain of
copies, products and softmax, with the causal grid's diagonal tiles and
triangular load on top (``chip_smoke.py``'s flash_anatomy phase). f32 q
keeps a CUDA-core kernel: a tensor-core product in f32 is TF32, which its
f32 tolerance does not allow. Head dims 32, 64 and 128 on every route, and
256 (recurrentgemma-2b's MQA heads) over native K/V on both.

These wrappers take CUDA tensors only and raise on anything the kernel
does not take; ``repro_torch.kernels.ops`` sends CPU tensors to the plain
versions instead.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

# launches of each kernel: the wrapper counts where it launches, nowhere else
launches = {"flash_attention": 0, "flash_attention_ragged": 0,
            "flash_attention_quant": 0, "flash_attention_quant_ragged": 0}

_DTYPES = (torch.float32, torch.bfloat16)
_CODES = (torch.int8, torch.float8_e4m3fn)
_HEAD_DIMS = (32, 64, 128, 256)
_CODE_HEAD_DIMS = (32, 64, 128)   # K1q/K1rq: hd 256 serves no quantized path


def _fn():
    fn = build.library("flash_attention").flash_attention_fwd
    # q, k, v, seq_lens, out; B, Sq, Sk, H, KVH, hd, causal, window, is_bf16;
    # scale; stream
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_float,
                                                               ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _quant_fn():
    fn = build.library("flash_attention").flash_attention_quant_fwd
    # q, k, v, k_scale, v_scale, seq_lens, out; B, Sq, Sk, H, KVH, hd, causal,
    # window, is_bf16, is_fp8; scale; stream
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_float,
                                                                ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(hd: int, dtype: torch.dtype, quantized: bool = False) -> int:
    """Dynamic shared memory of one CTA at head dim ``hd`` for q of ``dtype``
    (bf16: the wgmma kernel; f32: the CUDA-core kernel), over native K/V or
    over codes (``quantized``)."""
    fn = build.library("flash_attention").flash_attention_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return int(fn(hd, int(dtype == torch.bfloat16), int(quantized)))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           seq_lens: Optional[torch.Tensor], window: Optional[int], kv_dtypes,
           head_dims=_HEAD_DIMS) -> None:
    """Raise on anything the kernel does not take."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES or k.dtype not in kv_dtypes or v.dtype != k.dtype:
        raise ValueError(f"flash_attention takes float32 or bfloat16 q with k/v of "
                         f"{kv_dtypes}, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    _, Sk, KVH, hd_k = k.shape
    if k.shape[0] != B or hd_k != hd or hd not in head_dims or H % KVH:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)}: "
                         f"need equal B and hd in {head_dims}, H % KVH == 0")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned on {q.device}")
    if seq_lens is not None:
        if (seq_lens.dtype != torch.int32 or seq_lens.shape != (B,)
                or seq_lens.device != q.device or not seq_lens.is_contiguous()):
            raise ValueError("seq_lens must be a contiguous (B,) int32 tensor "
                             f"on {q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    seq_lens: Optional[torch.Tensor] = None, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q (B,Sq,H,hd), k/v (B,Sk,KVH,hd) -> (B,Sq,H,hd), on the card.

    ``seq_lens`` (B,) int32 selects the ragged kernel (K1r): keys at or
    beyond a row's length are masked and its query rows there are zeroed.
    """
    _check(q, k, v, seq_lens, window, (q.dtype,))
    B, Sq, H, hd = q.shape
    _, Sk, KVH, _ = k.shape
    out = torch.empty_like(q)
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if seq_lens is None else seq_lens.data_ptr(), out.data_ptr(),
                B, Sq, Sk, H, KVH, hd, int(causal),
                -1 if window is None else int(window),
                int(q.dtype == torch.bfloat16), hd ** -0.5,
                torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd failed: cudaError_t {err}")
    launches["flash_attention" if seq_lens is None else "flash_attention_ragged"] += 1
    return out


def flash_attention_quant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          k_scale: torch.Tensor, v_scale: torch.Tensor,
                          seq_lens: Optional[torch.Tensor] = None, *,
                          causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """K1q (K1rq with ``seq_lens``): q (B,Sq,H,hd) float32 or bfloat16, k/v
    (B,Sk,KVH,hd) int8 or float8_e4m3fn codes with k_scale/v_scale
    (B,Sk,KVH) float32 -> (B,Sq,H,hd) in q's dtype, on the card."""
    _check(q, k, v, seq_lens, window, _CODES, _CODE_HEAD_DIMS)
    B, Sq, H, hd = q.shape
    _, Sk, KVH, _ = k.shape
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if (t.dtype != torch.float32 or t.shape != (B, Sk, KVH) or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({B}, {Sk}, {KVH}) float32 "
                             f"tensor on {q.device}")
    out = torch.empty_like(q)
    err = _quant_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
                      v_scale.data_ptr(), None if seq_lens is None else seq_lens.data_ptr(),
                      out.data_ptr(), B, Sq, Sk, H, KVH, hd, int(causal),
                      -1 if window is None else int(window),
                      int(q.dtype == torch.bfloat16), int(k.dtype == torch.float8_e4m3fn),
                      hd ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_quant_fwd failed: cudaError_t {err}")
    launches["flash_attention_quant" if seq_lens is None
             else "flash_attention_quant_ragged"] += 1
    return out
