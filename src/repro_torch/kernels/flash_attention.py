"""Wrappers of the hand-written prefill attention kernels (csrc/flash_attention.cu).

Replaces the Pallas TPU kernels ``_attn_kernel`` (K1) and
``_attn_kernel_ragged`` (K1r) of ``src/repro/kernels/flash_attention.py``,
and their ``quantized=True`` variants (K1q, K1rq) through
``flash_attention_quant``: over int8 or fp8 K/V codes, each tile
dequantized in shared memory before its products.

Three routes (``route``; the table in the source's header):

- **wide** (bf16 q over native K/V at hd 128 and 256: olmoe-1b-7b,
  qwen3-8b, recurrentgemma-2b): a warp-specialized, persistent CTA (one
  an SM) whose producer warpgroup loads Q and a ring of K/V tiles by TMA,
  behind mbarriers, for two consumer warpgroups of 64 query rows each.
  The two are two query heads of one KV group where the group is even,
  else two adjacent q-tiles of one head, so every K/V tile landed serves
  128 rows; the producer runs on into the next work unit (the q-tiles with
  the most keys first) while the consumers finish this one. Its launches
  count under ``flash_attention_wide`` (``_ragged`` with ``seq_lens``).
- **wgmma** (bf16 q at hd 32 and 64, and every quantized K/V): one
  warpgroup per (64-row q-tile, head, batch row), fed by a two-stage ring
  of cp.async copies (granite-3-2b's hd 64).
- **CUDA cores** (f32 q): a tensor-core product in f32 is TF32, which the
  f32 tolerance does not allow.

Every route also takes ``causal=False`` (an encoder's self-attention and
a decoder's cross-attention over it, Sq and Sk apart) and a prefix-LM mask
(``prefix_len``: keys below it are visible to every query, the
reference's ``chunked_attention`` rule for a VLM's image patches, which the
TPU kernel lacks; causal, native K/V, no ``seq_lens``).

Each route skips KV tiles above the diagonal, outside the window or in the
row's padding and keeps the online softmax in f32 registers. At the
serving shapes the work is byte-bound on the tensor cores (recurrentgemma's
admission 13.8 us, olmoe's 20.0, granite's 12.5); what holds the kernels
above that is each warpgroup's chain of a tile's QK^T, softmax and PV over
short causal ranges (``chip_smoke.py``'s kernels and flash_anatomy
phases).

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
            "flash_attention_wide": 0, "flash_attention_wide_ragged": 0,
            "flash_attention_quant": 0, "flash_attention_quant_ragged": 0}

_DTYPES = (torch.float32, torch.bfloat16)
_CODES = (torch.int8, torch.float8_e4m3fn)
_HEAD_DIMS = (32, 64, 128, 256)
_CODE_HEAD_DIMS = (32, 64, 128)   # K1q/K1rq: hd 256 serves no quantized path
# flash_attention_route's answers, in its order
ROUTES = ("cuda_cores", "wgmma", "wide")


def route(dtype: torch.dtype, hd: int, quantized: bool = False) -> str:
    """The kernel that serves q of ``dtype`` at head dim ``hd`` over native
    K/V or codes (``quantized``): "wide" (bf16 over native K/V at hd 128
    and 256), "wgmma" (bf16 at hd 32 and 64, and bf16 over codes) or
    "cuda_cores" (f32). Raises on what no route takes."""
    if dtype not in _DTYPES or hd not in (_CODE_HEAD_DIMS if quantized else _HEAD_DIMS):
        raise ValueError(f"no flash_attention route takes {dtype} q at hd {hd}"
                         + (" over codes" if quantized else ""))
    if dtype == torch.float32:
        return "cuda_cores"
    return "wide" if not quantized and hd >= 128 else "wgmma"


def counter(dtype: torch.dtype, hd: int, ragged: bool = False) -> str:
    """The launch counter of K1 (K1r with ``ragged``) over native K/V at
    ``dtype`` and ``hd``: the wide route's or the others'. A causal, a
    non-causal and a prefix-LM launch count alike."""
    wide = route(dtype, hd) == "wide"
    return "flash_attention" + ("_wide" if wide else "") + ("_ragged" if ragged else "")


def library_route(dtype: torch.dtype, hd: int, quantized: bool = False) -> Optional[str]:
    """The route the built library takes for (``dtype``, ``hd``,
    ``quantized``), or None where it refuses."""
    fn = build.library("flash_attention").flash_attention_route
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    r = int(fn(hd, int(dtype == torch.bfloat16), int(quantized)))
    return ROUTES[r] if r >= 0 else None


def _fn():
    fn = build.library("flash_attention").flash_attention_prefix_fwd
    # q, k, v, seq_lens, out; B, Sq, Sk, H, KVH, hd, causal, window,
    # prefix_len, is_bf16; scale; stream
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_float,
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
    """Dynamic shared memory of one CTA of the route (``route``) that serves
    q of ``dtype`` at head dim ``hd`` over native K/V or over codes
    (``quantized``); 0 where no route does."""
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


def check_prefix(prefix_len: int, causal: bool, seq_lens) -> None:
    """The prefix-LM mask is causal prefill over native K/V only: the
    reference asserts prefix_len == 0 on its ragged path, and no path
    attends quantized K/V at prefill."""
    if prefix_len < 0:
        raise ValueError(f"prefix_len must be >= 0, got {prefix_len}")
    if prefix_len and (not causal or seq_lens is not None):
        raise ValueError("prefix_len needs causal prefill without seq_lens")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    seq_lens: Optional[torch.Tensor] = None, *,
                    causal: bool = True,
                    window: Optional[int] = None,
                    prefix_len: int = 0) -> torch.Tensor:
    """q (B,Sq,H,hd), k/v (B,Sk,KVH,hd) -> (B,Sq,H,hd), on the card.

    ``seq_lens`` (B,) int32 selects the ragged kernel (K1r): keys at or
    beyond a row's length are masked and its query rows there are zeroed.
    ``prefix_len`` > 0 (causal, no ``seq_lens``) makes keys below it
    visible to every query (the prefix-LM mask).
    """
    _check(q, k, v, seq_lens, window, (q.dtype,))
    check_prefix(prefix_len, causal, seq_lens)
    B, Sq, H, hd = q.shape
    _, Sk, KVH, _ = k.shape
    out = torch.empty_like(q)
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if seq_lens is None else seq_lens.data_ptr(), out.data_ptr(),
                B, Sq, Sk, H, KVH, hd, int(causal),
                -1 if window is None else int(window), int(prefix_len),
                int(q.dtype == torch.bfloat16), hd ** -0.5,
                torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_prefix_fwd failed: cudaError_t {err}")
    launches[counter(q.dtype, hd, seq_lens is not None)] += 1
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
