"""Symmetric per-token-per-head KV quantization: the storage format of the
quantized page region.

Scales are per cached row per KV head over the head dim (one float32 each),
so a new token never forces a written row to requantize: pages stay
append-only. int8: ``scale = max(amax, 1e-8) / 127``, code =
round(x / scale) clipped to [-127, 127] (``torch.round`` rounds half to
even, as ``jnp.round`` does); fp8 (e4m3): ``scale = max(amax, 1e-8) / 448``,
code = the cast, which rounds. Dequantization is ``code * scale`` in
float32, then the cast to the compute dtype. These are elementwise ops, as
in the reference (``src/repro/kernels/quant.py``), which runs them in XLA
outside any kernel; on the same inputs they give the reference's codes and
scales bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.cache.precision import KVPrecision

__all__ = ["qdtype_of", "quantize_kv", "dequantize_kv"]

_EPS = 1e-8  # amax floor: an all-zero row quantizes to zeros, its scale stays finite


def qdtype_of(prec: KVPrecision) -> torch.dtype:
    """The spec's storage dtype as a torch dtype."""
    dt = getattr(torch, prec.dtype, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"kv_precision dtype {prec.dtype!r} is not available in this "
                         "torch build; use 'int8'")
    return dt


def quantize_kv(x: torch.Tensor, prec: KVPrecision) -> tuple[torch.Tensor, torch.Tensor]:
    """K or V rows ``x (..., head_dim)`` -> ``(codes, scale)``: codes in the
    storage dtype, ``scale (...,)`` float32."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=_EPS) / prec.qmax
    scaled = xf / scale[..., None]
    if prec.dtype == "int8":
        q = torch.clamp(torch.round(scaled), -prec.qmax, prec.qmax).to(torch.int8)
    else:   # fp8: the cast rounds; the scale keeps amax inside the range
        q = scaled.to(qdtype_of(prec))
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``q (..., head_dim)`` with ``scale (...,)`` -> ``dtype``."""
    return (q.float() * scale[..., None]).to(dtype)
