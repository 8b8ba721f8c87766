"""Wrapper of the hand-written prefill attention kernel (csrc/flash_attention.cu).

Replaces the Pallas TPU kernels ``_attn_kernel`` (K1) and
``_attn_kernel_ragged`` (K1r) of ``src/repro/kernels/flash_attention.py``.
On the H100 the prefill at serving shapes would be byte-bound on the tensor
cores (B 8, S 512, H 32, hd 64: ~8.6 GFLOP causal against ~42 MB); this
first kernel computes on the CUDA cores in f32 FMAs from shared memory, so
FMA issue bounds it. One CTA per (q-tile, head, batch row) loops over the
live KV tiles with the online softmax in registers and skips tiles above
the diagonal, outside the window or in the row's padding.

This wrapper takes CUDA tensors only and raises on anything the kernel does
not take; ``repro_torch.kernels.ops`` sends CPU tensors to the plain
version instead.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

# launches of each kernel: the wrapper counts where it launches, nowhere else
launches = {"flash_attention": 0, "flash_attention_ragged": 0}

_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (32, 64, 128)


def _fn():
    fn = build.library("flash_attention").flash_attention_fwd
    # q, k, v, seq_lens, out; B, Sq, Sk, H, KVH, hd, causal, window, is_bf16;
    # scale; stream
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_float,
                                                               ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(hd: int) -> int:
    """Dynamic shared memory of one CTA at head dim ``hd``."""
    return int(build.library("flash_attention").flash_attention_smem_bytes(hd))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    seq_lens: Optional[torch.Tensor] = None, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q (B,Sq,H,hd), k/v (B,Sk,KVH,hd) -> (B,Sq,H,hd), on the card.

    ``seq_lens`` (B,) int32 selects the ragged kernel (K1r): keys at or
    beyond a row's length are masked and its query rows there are zeroed.
    """
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes float32 or bfloat16 q/k/v of one "
                         f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    _, Sk, KVH, hd_k = k.shape
    if k.shape[0] != B or hd_k != hd or hd not in _HEAD_DIMS or H % KVH:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)}: "
                         f"need equal B and hd in {_HEAD_DIMS}, H % KVH == 0")
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
