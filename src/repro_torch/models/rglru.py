"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Block: x-branch = Conv1D (width W) -> RG-LRU; y-branch = GeLU(linear).
Output = linear ``out`` of (x-branch * y-branch). The RG-LRU recurrence:

    r_t = sigmoid(W_a x_t + b_a)        (recurrence gate, block-diagonal W)
    i_t = sigmoid(W_x x_t + b_x)        (input gate)
    a_t = a^(c * r_t), a = sigmoid(lam) (per-channel learnable decay, c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The prefill's scan over time goes through ``repro_torch.kernels.ops.rglru_scan``
(K7 on the card, its plain loop on the CPU); the decode step is one
elementwise update. Numerics and parameter layouts are the reference
package's (``src/repro/models/rglru.py``): the gates in float32 from a
float32 block-diagonal product, ``softplus(-lam)`` as jax defines it, the
state in float32, cast to the compute dtype before the y-gate product.

A decode carries ``RecState``: the last W-1 conv inputs and the state h
(float32), per batch row; the decode step writes both in place.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import cdtype, param

_C = 8.0  # Griffin's fixed temperature on the recurrence gate


class RecState(NamedTuple):
    """Recurrent state. In a DecodeState each leaf carries a leading layer
    axis; the block functions take one layer's view of it."""

    conv: torch.Tensor   # (B, W-1, R) the last W-1 conv inputs, compute dtype
    h: torch.Tensor      # (B, R) float32

    def layer(self, i: int) -> "RecState":
        return RecState(self.conv[i], self.h[i])


class RGLRU(nn.Module):
    """The block's parameters in the reference's dtypes: ``in_x``, ``in_y``
    (D, R), ``conv_w`` (W, R), ``conv_b`` (R,) and ``out`` (R, D) in the
    compute dtype; the block-diagonal gates ``w_a``, ``w_x`` (nb, bs, bs),
    their biases ``b_a``, ``b_x`` (R,) and ``lam`` (R,) in float32."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        D, R, W, nb = cfg.d_model, cfg.lru_width_, cfg.conv_width, cfg.lru_heads
        bs, dt = R // nb, cdtype(cfg)
        self.in_x = param((D, R), dt, device)
        self.in_y = param((D, R), dt, device)
        self.conv_w = param((W, R), dt, device)
        self.conv_b = param((R,), dt, device)
        self.w_a = param((nb, bs, bs), torch.float32, device)
        self.b_a = param((R,), torch.float32, device)
        self.w_x = param((nb, bs, bs), torch.float32, device)
        self.b_x = param((R,), torch.float32, device)
        self.lam = param((R,), torch.float32, device)
        self.out = param((R, D), dt, device)


# the leaves ``rglru_constants`` sets (the others are drawn at random)
RGLRU_CONSTANTS = ("conv_b", "b_a", "b_x", "lam")


@torch.no_grad()
def rglru_constants(p: RGLRU, cfg: ModelConfig) -> None:
    """The leaves the reference's ``rglru_init`` sets to constants: zero
    biases and lam = linspace(2.2, 6.9, R), so a = sigmoid(lam) lies in
    (0.9, 0.999)."""
    p.conv_b.zero_()
    p.b_a.zero_()
    p.b_x.zero_()
    p.lam.copy_(torch.linspace(2.2, 6.9, cfg.lru_width_, dtype=torch.float32))


def _block_diag(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x (..., R) -> the block-diagonal linear with (nb, bs, bs) weights, in
    float32."""
    nb, bs, _ = w.shape
    xs = x.reshape(*x.shape[:-1], nb, bs).float()
    y = torch.einsum("...ni,nij->...nj", xs, w)
    return y.reshape(*x.shape[:-1], nb * bs) + b


def _gates(p: RGLRU, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(log_a, gated input), both float32 of x's shape (..., R)."""
    r = torch.sigmoid(_block_diag(x, p.w_a, p.b_a))
    i = torch.sigmoid(_block_diag(x, p.w_x, p.b_x))
    # jax.nn.softplus is log(1 + exp(x)) = logaddexp(x, 0) with no threshold
    sp = torch.logaddexp(-p.lam, torch.zeros((), dtype=p.lam.dtype, device=p.lam.device))
    log_a = -_C * r * sp                               # c * r * log(sigmoid(lam))
    a2 = torch.exp(2.0 * log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) * (i * x.float())
    return log_a, gated


def _conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          state_conv: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv of u (B, S, R) with w (W, R), after the state's
    W-1 inputs (None: zeros); (out (B, S, R), the last W-1 inputs)."""
    W, S = w.shape[0], u.shape[1]
    if state_conv is not None:
        u_ext = torch.cat([state_conv.to(u.dtype), u], dim=1)
    else:
        u_ext = F.pad(u, (0, 0, W - 1, 0))
    out = sum(u_ext[:, i:i + S] * w[i] for i in range(W))
    return out + b, u_ext[:, -(W - 1):]


def rglru_forward_with_state(p: RGLRU, h: torch.Tensor, cfg: ModelConfig,
                             init: Optional[RecState] = None) -> tuple[torch.Tensor, RecState]:
    """Full-sequence block over h (B, S, D), from ``init`` (None: zeros).
    Returns the block's output (B, S, D) and the state after the sequence."""
    x = h @ p.in_x
    y_gate = F.gelu(h @ p.in_y, approximate="tanh")
    x, new_conv = _conv(x, p.conv_w, p.conv_b, init.conv if init is not None else None)
    log_a, gated = _gates(p, x)
    hs = ops.rglru_scan(log_a.contiguous(), gated.contiguous(),
                        init.h.contiguous() if init is not None else None)
    out = (hs.to(h.dtype) * y_gate) @ p.out
    return out, RecState(conv=new_conv, h=hs[:, -1])


def rec_state_init(batch: int, cfg: ModelConfig, device,
                   layers: Optional[int] = None) -> RecState:
    """Zero state; ``layers`` adds a leading layer axis."""
    R, W = cfg.lru_width_, cfg.conv_width
    lead = (layers,) if layers is not None else ()
    return RecState(conv=torch.zeros((*lead, batch, W - 1, R), dtype=cdtype(cfg), device=device),
                    h=torch.zeros((*lead, batch, R), dtype=torch.float32, device=device))


def rglru_decode(p: RGLRU, h: torch.Tensor, state: RecState, cfg: ModelConfig) -> torch.Tensor:
    """One-token step. h (B, D) -> (B, D). Writes the new state into
    ``state``'s own tensors (the conv window moved on by one input, h
    decayed and updated)."""
    x = h @ p.in_x                                               # (B, R)
    y_gate = F.gelu(h @ p.in_y, approximate="tanh")
    win = torch.cat([state.conv, x[:, None]], dim=1)             # (B, W, R)
    x = torch.einsum("bwr,wr->br", win, p.conv_w) + p.conv_b
    log_a, gated = _gates(p, x)
    h_new = torch.exp(log_a) * state.h + gated
    out = (h_new.to(h.dtype) * y_gate) @ p.out
    state.conv.copy_(win[:, 1:])   # win is a new tensor: the copy does not overlap
    state.h.copy_(h_new)
    return out
