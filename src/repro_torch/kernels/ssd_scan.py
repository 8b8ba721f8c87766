"""Wrapper of the hand-written Mamba-2 SSD chunked-scan kernel
(csrc/ssd_scan.cu).

Replaces the Pallas TPU kernel ``_ssd_kernel`` (K6) of
``src/repro/kernels/ssd_scan.py``: the scan behind every SSM layer's
prefill. At the full mamba2-130m prefill (B 8, S 512, H 24, P 64, N 128,
chunk 128, bf16 x) the call moves ~36 MB for ~6 GFLOP, byte-bound on the
tensor cores; this first kernel computes on the CUDA cores in f32 FMAs from
shared memory, so FMA issue bounds it. One CTA per (head, batch row) loops
over the chunks with the state resident in shared memory.

Unlike the TPU kernel it takes any sequence length (the tail chunk is
masked inside the kernel) and an optional initial state. This wrapper
takes CUDA tensors only and raises on anything the kernel does not take;
``repro_torch.kernels.ops`` sends CPU tensors to the plain version instead.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

# launches of the kernel: the wrapper counts where it launches, nowhere else
launches = {"ssd_scan": 0}

_DTYPES = (torch.float32, torch.bfloat16)


def _fn():
    fn = build.library("ssd_scan").ssd_scan_fwd
    # x, dt, A, Bm, Cm, init_state, y, state; B, S, H, P, N, Q, is_bf16; stream
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(chunk: int, P: int, N: int) -> int:
    """Dynamic shared memory of one CTA at chunk ``chunk``, head dim ``P``
    and state size ``N``."""
    return int(build.library("ssd_scan").ssd_scan_smem_bytes(chunk, P, N))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, *, chunk: int,
             init_state: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P) float32 or bfloat16, dt (B,S,H), A (H,), Bm/Cm (B,S,N)
    and ``init_state`` (B,H,P,N) (None: zeros) float32 -> y (B,S,H,P) in
    x's dtype and the final state (B,H,P,N) float32, on the card."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan kernel needs CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"ssd_scan takes float32 or bfloat16 x, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[-1] if Bm.dim() == 3 else -1
    want = {"dt": (dt, (B, S, H)), "A": (A, (H,)), "Bm": (Bm, (B, S, N)),
            "Cm": (Cm, (B, S, N))}
    if init_state is not None:
        want["init_state"] = (init_state, (B, H, P, N))
    for name, (t, shape) in want.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} float32, got {tuple(t.shape)} {t.dtype}")
    for name, t in (("x", x), *((n, t) for n, (t, _) in want.items())):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.data_ptr() % 16:   # the kernel reads rows with 16-byte loads
            raise ValueError(f"{name} must be 16-byte aligned")
    vec = 16 // x.element_size()
    if (S < 1 or chunk < 4 or chunk % 4 or (chunk > 32 and chunk % 32) or N < 4 or N % 4
            or P % vec):
        raise ValueError(f"ssd_scan takes S >= 1, a chunk that is a multiple of 4 (of 32 "
                         f"above 32), N a multiple of 4 and P of {vec}; got S {S} chunk "
                         f"{chunk} N {N} P {P}")
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    err = _fn()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                init_state.data_ptr() if init_state is not None else None, y.data_ptr(),
                state.data_ptr(), B, S, H, P, N, chunk, int(x.dtype == torch.bfloat16),
                torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_fwd failed: cudaError_t {err}")
    launches["ssd_scan"] += 1
    return y, state
