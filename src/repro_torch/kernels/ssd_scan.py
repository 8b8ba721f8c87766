"""Wrapper of the hand-written Mamba-2 SSD chunked-scan kernels
(csrc/ssd_scan.cu).

Replaces the Pallas TPU kernel ``_ssd_kernel`` (K6) of
``src/repro/kernels/ssd_scan.py``: the scan behind every SSM layer's
prefill. bf16 x runs three phase kernels on the tensor cores, which
``ssd_scan`` composes and which are also callable one by one:

- ``chunk_states``: each chunk's own state contribution and decay, every
  chunk in parallel;
- ``state_passing``: the states entering each chunk and the final state,
  sequential over chunks and elementwise over P x N;
- ``chunk_outputs``: y, with C Bᵀ computed once per chunk and shared by
  the heads a CTA takes.

The per-chunk states live in scratch this wrapper allocates (B x nc x H x
P x N f32). float32 x runs the one-launch CUDA-core kernel of the first
port, which holds K6's f32 rule. At the full mamba2-130m prefill (B 8, S
512, H 24, P 64, N 128, chunk 128, bf16 x) the call moves ~36 MB: bytes
bound it.

Unlike the TPU kernel it takes any sequence length (the tail chunk is
masked inside the kernels) and an optional initial state. These wrappers
take CUDA tensors only and raise on anything the kernels do not take;
``repro_torch.kernels.ops`` sends CPU tensors to the plain version instead.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

# launches: each wrapper counts where it launches its kernel, nowhere else;
# ``ssd_scan`` counts once per call, whichever kernels the call runs: an f32
# call runs ``ssd_scan_kernel`` (also counted as ``ssd_scan_f32``), a bf16
# call the three phase kernels (each counted by its own counter)
launches = {"ssd_scan": 0, "ssd_scan_f32": 0, "ssd_chunk_states": 0,
            "ssd_state_passing": 0, "ssd_chunk_outputs": 0}

_DTYPES = (torch.float32, torch.bfloat16)
_P, _I = ctypes.c_void_p, ctypes.c_int
# C function: argument types after the pointers (ints, then the stream)
_SIGNATURES = {"ssd_scan_f32_fwd": (8, 6), "ssd_chunk_states_fwd": (6, 6),
               "ssd_state_passing_fwd": (4, 5), "ssd_chunk_outputs_fwd": (7, 6)}


def _fn(name: str):
    fn = getattr(build.library("ssd_scan"), name)
    n_ptr, n_int = _SIGNATURES[name]
    fn.argtypes = [_P] * n_ptr + [_I] * n_int + [_P]
    fn.restype = ctypes.c_int
    return fn


def _call(name: str, *args) -> None:
    err = _fn(name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError_t {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def smem_bytes(chunk: int, P: int, N: int, dtype: torch.dtype = torch.float32) -> dict:
    """Dynamic shared memory of one CTA of each kernel the ``dtype`` route
    runs at chunk ``chunk``, head dim ``P`` and state size ``N``."""
    lib = build.library("ssd_scan")
    if dtype == torch.float32:
        return {"ssd_scan_kernel": int(lib.ssd_scan_smem_bytes(chunk, P, N))}
    return {"ssd_chunk_states_kernel": int(lib.ssd_chunk_states_smem_bytes(chunk, P, N)),
            "ssd_chunk_outputs_kernel": int(lib.ssd_chunk_outputs_smem_bytes(chunk, P, N))}


def _check(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, chunk: int,
           dtypes=_DTYPES, **f32: Optional[torch.Tensor]) -> tuple[int, int, int, int, int]:
    """Raise on anything the kernels do not take; (B, S, H, P, N)."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan kernel needs CUDA tensors, got {x.device}")
    if x.dtype not in dtypes:
        raise ValueError(f"ssd_scan takes {' or '.join(str(d)[6:] for d in dtypes)} x, "
                         f"got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    B, S, H, P = x.shape
    N = f32["Bm"].shape[-1] if f32["Bm"].dim() == 3 else -1
    shapes = {"Bm": (B, S, N), "Cm": (B, S, N), "init_state": (B, H, P, N)}
    want = {"dt": (dt, (B, S, H)), "A": (A, (H,))}
    want.update({k: (t, shapes[k]) for k, t in f32.items() if t is not None})
    for name, (t, shape) in want.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} float32, got {tuple(t.shape)} {t.dtype}")
    for name, t in (("x", x), *((n, t) for n, (t, _) in want.items())):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    for name, t in (("x", x), *((n, t) for n, (t, _) in want.items() if n != "A" and n != "dt")):
        if t.data_ptr() % 16:   # the kernels read rows with 16-byte loads
            raise ValueError(f"{name} must be 16-byte aligned")
    vec = 16 // x.element_size()
    if (S < 1 or chunk < 4 or chunk % 4 or (chunk > 32 and chunk % 32) or N < 4 or N % 4
            or P % vec):
        raise ValueError(f"ssd_scan takes S >= 1, a chunk that is a multiple of 4 (of 32 "
                         f"above 32), N a multiple of 4 and P of {vec}; got S {S} chunk "
                         f"{chunk} N {N} P {P}")
    if x.dtype == torch.bfloat16 and chunk > 256:
        raise ValueError(f"the bf16 ssd_scan takes a chunk of at most 256, got {chunk}")
    return B, S, H, P, N


def _chunk_states(x, dt, A, Bm, chunk, B, S, H, P, N):
    nc = -(-S // chunk)
    states = torch.empty((B, nc, H, P, N), dtype=torch.float32, device=x.device)
    decay = torch.empty((B, nc, H), dtype=torch.float32, device=x.device)
    _call("ssd_chunk_states_fwd", x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
          states.data_ptr(), decay.data_ptr(), B, S, H, P, N, chunk, _stream(x))
    launches["ssd_chunk_states"] += 1
    return states, decay


def _state_passing(states, decay, init_state):
    B, nc, H, P, N = states.shape
    final = torch.empty((B, H, P, N), dtype=torch.float32, device=states.device)
    _call("ssd_state_passing_fwd", states.data_ptr(), decay.data_ptr(),
          init_state.data_ptr() if init_state is not None else None, final.data_ptr(),
          B, nc, H, P, N, _stream(states))
    launches["ssd_state_passing"] += 1
    return final


def _chunk_outputs(x, dt, A, Bm, Cm, states, chunk, B, S, H, P, N):
    y = torch.empty_like(x)
    _call("ssd_chunk_outputs_fwd", x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
          Cm.data_ptr(), states.data_ptr(), y.data_ptr(), B, S, H, P, N, chunk, _stream(x))
    launches["ssd_chunk_outputs"] += 1
    return y


def chunk_states(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor, *,
                 chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase 1, bf16 x (B,S,H,P): each chunk's own state contribution
    sum_s exp(LA_end - LA_s) dt_s x_s B_sᵀ (B,nc,H,P,N) float32 and its
    decay exp(LA_end) (B,nc,H) float32."""
    dims = _check(x, dt, A, chunk, (torch.bfloat16,), Bm=Bm)
    return _chunk_states(x, dt, A, Bm, chunk, *dims)


def state_passing(states: torch.Tensor, decay: torch.Tensor,
                  init_state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Phase 2: ``states`` (B,nc,H,P,N) float32, each chunk's contribution,
    becomes IN PLACE the state entering each chunk, from ``init_state``
    (B,H,P,N) float32 (None: zeros); returns the final state (B,H,P,N)."""
    if states.device.type != "cuda":
        raise ValueError(f"ssd_scan kernel needs CUDA tensors, got {states.device}")
    if states.dim() != 5:
        raise ValueError(f"states must be (B, nc, H, P, N), got {tuple(states.shape)}")
    B, nc, H, P, N = states.shape
    want = {"states": (states, (B, nc, H, P, N)), "decay": (decay, (B, nc, H))}
    if init_state is not None:
        want["init_state"] = (init_state, (B, H, P, N))
    for name, (t, shape) in want.items():
        if (t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != states.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned {shape} float32 "
                             f"tensor on {states.device}")
    if (P * N) % 4:
        raise ValueError(f"state_passing takes P N a multiple of 4, got {P} x {N}")
    return _state_passing(states, decay, init_state)


def chunk_outputs(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                  Cm: torch.Tensor, states: torch.Tensor, *, chunk: int) -> torch.Tensor:
    """Phase 3, bf16 x (B,S,H,P): y (B,S,H,P) bf16 from the states entering
    each chunk ``states`` (B,nc,H,P,N) float32."""
    B, S, H, P, N = _check(x, dt, A, chunk, (torch.bfloat16,), Bm=Bm, Cm=Cm)
    shape = (B, -(-S // chunk), H, P, N)
    if (states.dtype != torch.float32 or tuple(states.shape) != shape
            or states.device != x.device or not states.is_contiguous() or states.data_ptr() % 16):
        raise ValueError(f"states must be a contiguous, 16-byte aligned {shape} float32 tensor "
                         f"on {x.device}")
    return _chunk_outputs(x, dt, A, Bm, Cm, states, chunk, B, S, H, P, N)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, *, chunk: int,
             init_state: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P) float32 or bfloat16, dt (B,S,H), A (H,), Bm/Cm (B,S,N)
    and ``init_state`` (B,H,P,N) (None: zeros) float32 -> y (B,S,H,P) in
    x's dtype and the final state (B,H,P,N) float32, on the card."""
    B, S, H, P, N = _check(x, dt, A, chunk, Bm=Bm, Cm=Cm, init_state=init_state)
    if x.dtype == torch.bfloat16:
        states, decay = _chunk_states(x, dt, A, Bm, chunk, B, S, H, P, N)
        final = _state_passing(states, decay, init_state)
        y = _chunk_outputs(x, dt, A, Bm, Cm, states, chunk, B, S, H, P, N)
    else:
        y = torch.empty_like(x)
        final = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
        _call("ssd_scan_f32_fwd", x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
              Cm.data_ptr(), init_state.data_ptr() if init_state is not None else None,
              y.data_ptr(), final.data_ptr(), B, S, H, P, N, chunk, _stream(x))
        launches["ssd_scan_f32"] += 1
    launches["ssd_scan"] += 1
    return y, final
