"""Layer primitives: norms, rotary embeddings, gated MLP, embeddings.

Plain functions on tensors, with the reference package's numerics: RMSNorm
in float32 cast back to the input dtype, RoPE angles in float32, weights in
the reference layouts (``w_gate``/``w_up`` (D, F), ``w_down`` (F, D),
``tok`` (V, D)).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def param(shape, dtype, device) -> nn.Parameter:
    """An inference parameter, uninitialised: the caller fills it."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32, multiplied by the scale, cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split RoPE. x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                       # (hd/2,)
    ang = positions[..., None].float() * freqs                    # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1f, x2f = x[..., : hd // 2].float(), x[..., hd // 2:].float()
    return torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1).to(x.dtype)


def mlp(w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
        x: torch.Tensor) -> torch.Tensor:
    """SiLU-gated MLP."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def embed(tok: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return tok[tokens]


def unembed(tok: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Tied output projection: logits = h @ tok^T."""
    return h @ tok.T
