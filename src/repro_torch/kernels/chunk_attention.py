"""Wrapper of the hand-written chunked-prefill attention kernel
(csrc/chunk_attention.cu).

Replaces the Pallas TPU kernel ``_chunk_kernel`` (K4) of
``src/repro/kernels/chunk_attention.py``: the kernel behind continuous
batching, where each admitted prompt enters the cache a chunk per control
slot and the chunk's queries attend everything the row has written so far.
One CTA per (tile of 64 chunk queries, head, batch row) loops over the KV
tiles up to the tile's last live query position (the cache of a chunk row
is position-ordered), with the online softmax in registers and the
slot_pos mask applied per tile. For bf16 q the CTA is one warpgroup that
runs QK^T and PV on the tensor cores (wgmma; ``csrc/chunk_core.cuh``, the
core K4p and K4q share), fed by a two-stage ring of cp.async copies that
carries each tile's slot_pos beside its K/V. At the serving mix (B 8, C
128, H 32 on KVH 8, hd 64) the call is byte-bound on the tensor cores
(~10-14 MB for ~2 GFLOP); what holds the kernel above that bound is the
per-tile chain of one warpgroup and the grid's longest CTA chain
(``chip_smoke.py``'s chunk_anatomy phase). f32 q keeps a CUDA-core kernel:
a tensor-core product in f32 is TF32, which its f32 tolerance does not
allow.

This wrapper takes CUDA tensors only and raises on anything the kernel does
not take; ``repro_torch.kernels.ops`` sends CPU tensors to the plain
version instead.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# launches of the kernel: the wrapper counts where it launches, nowhere else
launches = {"chunk_attention": 0}

_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (32, 64, 128)


def _fn():
    fn = build.library("chunk_attention").chunk_attention_fwd
    # q, k, v, slot_pos, pos0, valid, out; B, C, L, H, KVH, hd, is_bf16; scale; stream
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                               ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(hd: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one CTA at head dim ``hd`` for q of ``dtype``
    (bf16: the wgmma kernel; f32: the CUDA-core kernel)."""
    fn = build.library("chunk_attention").chunk_attention_smem_bytes
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    return int(fn(hd, int(dtype == torch.bfloat16)))


def chunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    slot_pos: torch.Tensor, pos0: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """q (B,C,H,hd), cache k/v (B,L,KVH,hd), slot_pos (B,L) int32, pos0 and
    valid (B,) int32 -> (B,C,H,hd), on the card. Query rows at or beyond
    ``valid`` are zeros."""
    if q.device.type != "cuda":
        raise ValueError(f"chunk_attention kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"chunk_attention takes float32 or bfloat16 q/k/v of one "
                         f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    B, C, H, hd = q.shape
    _, L, KVH, hd_k = k.shape
    if k.shape[0] != B or hd_k != hd or hd not in _HEAD_DIMS or H % KVH:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)}: "
                         f"need equal B and hd in {_HEAD_DIMS}, H % KVH == 0")
    if slot_pos.dtype != torch.int32 or slot_pos.shape != (B, L):
        raise ValueError(f"slot_pos must be ({B}, {L}) int32")
    for name, t in (("pos0", pos0), ("valid", valid)):
        if t.dtype != torch.int32 or t.shape != (B,):
            raise ValueError(f"{name} must be ({B},) int32")
    for name, t in (("q", q), ("k", k), ("v", v), ("slot_pos", slot_pos),
                    ("pos0", pos0), ("valid", valid)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:   # the kernel reads rows with 16-byte loads
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(q)
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), slot_pos.data_ptr(),
                pos0.data_ptr(), valid.data_ptr(), out.data_ptr(), B, C, L, H, KVH, hd,
                int(q.dtype == torch.bfloat16), hd ** -0.5,
                torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"chunk_attention_fwd failed: cudaError_t {err}")
    launches["chunk_attention"] += 1
    return out
