"""Wrapper of the hand-written RG-LRU scan kernel (csrc/rglru_scan.cu), K7.

It replaces no TPU kernel: the reference scans each RG-LRU block's prefill
with ``jax.lax.associative_scan`` (``src/repro/models/rglru.py:92-98``),
which XLA lowers itself. The port needs a kernel all the same: a torch
loop over a 512-token prompt puts about 18 x 512 x 3 nodes into every
admission graph of recurrentgemma-2b, and a pairwise (S x S x R) form
needs gigabytes. K7 computes h_t = exp(log_a_t) h_{t-1} + gated_t over
(B, S, R) float32 from h0 and writes every h_t, each channel one serial
chain rounded as ``ref.rglru_scan_ref`` rounds it (bit-equal on the card).
Bytes bound it: at the admission shape (B 8, S 512, R 2560) it reads 84 MB
and writes 42 MB (~38 us at 3.35 TB/s). So a CTA is one warp over 32
channels (640 CTAs at that shape, about five an SM in one wave) that
streams log_a and gated through a six-stage cp.async ring in shared
memory (16-byte copies where R is a multiple of 4), five stages of 16
steps in flight behind the step it computes, and stores each step's 32
states coalesced along R as streaming stores.

This wrapper takes CUDA tensors only and raises on anything the kernel
does not take; ``repro_torch.kernels.ops`` sends CPU tensors to the plain
version (``ref.rglru_scan_ref``) instead.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

# launches of the kernel: the wrapper counts where it launches, nowhere else
launches = {"rglru_scan": 0}


def _fn():
    fn = build.library("rglru_scan").rglru_scan_fwd
    # log_a, gated, h0, out; B, S, R; stream
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rglru_scan(log_a: torch.Tensor, gated: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """log_a, gated (B, S, R) float32, h0 (B, R) float32 or None (zeros)
    -> every h_t, (B, S, R) float32, on the card."""
    if gated.device.type != "cuda":
        raise ValueError(f"rglru_scan kernel needs CUDA tensors, got {gated.device}")
    if gated.dim() != 3 or log_a.shape != gated.shape:
        raise ValueError(f"log_a and gated must be one (B, S, R) shape, got "
                         f"{tuple(log_a.shape)} and {tuple(gated.shape)}")
    B, S, R = gated.shape
    want = [("log_a", log_a, (B, S, R)), ("gated", gated, (B, S, R))]
    if h0 is not None:
        want.append(("h0", h0, (B, R)))
    for name, t, shape in want:
        if (t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != gated.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {shape} float32 tensor on "
                             f"{gated.device}, got {tuple(t.shape)} {t.dtype}")
    if B < 1 or S < 1 or R < 1:
        raise ValueError(f"rglru_scan takes a non-empty (B, S, R), got {(B, S, R)}")
    out = torch.empty_like(gated)
    err = _fn()(log_a.data_ptr(), gated.data_ptr(), None if h0 is None else h0.data_ptr(),
                out.data_ptr(), B, S, R, torch.cuda.current_stream(gated.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan_fwd failed: cudaError_t {err}")
    launches["rglru_scan"] += 1
    return out
