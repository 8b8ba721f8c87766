"""Mamba-2 block: the SSD chunked scan for prefill, an O(1) recurrent step
for decode.

Block layout (arXiv:2405.21060, one group):
  in_proj: D -> [z (d_inner), x (d_inner), B (N), C (N), dt (H)],
  a depthwise causal conv (width W) over the [x, B, C] channels, then SiLU,
  SSD: h_t = exp(dt_t A_h) h_{t-1} + dt_t x_t B_t^T,  y_t = C_t . h_t,
  y = y + D_h x, RMSNorm gated by SiLU(z), out_proj: d_inner -> D.

The prefill's scan goes through ``repro_torch.kernels.ops.ssd`` (the SSD
kernel on the card, its plain version on the CPU); the decode step and the
conv are plain tensor ops, as in the reference. Numerics and parameter
layouts are the reference package's (``src/repro/models/ssm.py``).

A decode carries ``SSMState``: the last W-1 pre-conv inputs and the SSD
state (H, P, N) in float32, per batch row; the decode step writes both in
place.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import cdtype, param


class SSMState(NamedTuple):
    """Recurrent state. In a DecodeState each leaf carries a leading layer
    axis; the block functions take one layer's view of it."""

    conv: torch.Tensor   # (B, W-1, conv_ch) the last W-1 pre-conv inputs
    ssd: torch.Tensor    # (B, H, P, N) float32

    def layer(self, i: int) -> "SSMState":
        return SSMState(self.conv[i], self.ssd[i])


class SSM(nn.Module):
    """The block's parameters in the reference's dtypes: the projections,
    conv weight and bias in the compute dtype, ``A_log``, ``D``,
    ``dt_bias`` and the gated norm's ``norm`` in float32."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        D, di, N, H, W = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads,
                          cfg.conv_width)
        ch, dt = di + 2 * N, cdtype(cfg)
        self.in_proj = param((D, 2 * di + 2 * N + H), dt, device)
        self.conv_w = param((W, ch), dt, device)
        self.conv_b = param((ch,), dt, device)
        self.A_log = param((H,), torch.float32, device)
        self.D = param((H,), torch.float32, device)
        self.dt_bias = param((H,), torch.float32, device)
        self.norm = param((di,), torch.float32, device)
        self.out_proj = param((di, D), dt, device)


# the leaves ``ssm_constants`` sets (the others are drawn at random)
SSM_CONSTANTS = ("A_log", "D", "dt_bias", "norm", "conv_b")


@torch.no_grad()
def ssm_constants(p: SSM, cfg: ModelConfig) -> None:
    """The leaves the reference's ``ssm_init`` sets to constants:
    A_log = log(linspace(1, 16, H)) (A = -exp(A_log)), D = 1, dt_bias = 0,
    norm = 1, conv_b = 0."""
    # in float64, rounded once (the reference's float32 linspace and log may
    # differ from it by an ulp)
    H = cfg.n_ssm_heads
    p.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float64)).float())
    p.D.fill_(1.0)
    p.dt_bias.zero_()
    p.norm.fill_(1.0)
    p.conv_b.zero_()


def _split_proj(proj: torch.Tensor, cfg: ModelConfig):
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    return torch.split(proj, [di, di, N, N, H], dim=-1)   # z, x, B, C, dt


def _gated_norm(scale: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
                eps: float) -> torch.Tensor:
    xf = x.float() * F.silu(z.float())
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """u (B,S,ch), w (W,ch): depthwise causal conv, left-padded, then SiLU."""
    W, S = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + S] * w[i] for i in range(W))
    return F.silu(out + b)


def ssm_forward_with_state(p: SSM, h: torch.Tensor, cfg: ModelConfig,
                           init: Optional[SSMState] = None) -> tuple[torch.Tensor, SSMState]:
    """Full-sequence block over h (B,S,D), from ``init`` (None: zeros).
    Returns the block's output (B,S,D) and the state after the sequence."""
    B, S, _ = h.shape
    di, N, H, P, W = (cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_headdim,
                      cfg.conv_width)
    proj = h @ p.in_proj
    z, x, Bm, Cm, dtr = _split_proj(proj, cfg)
    u = torch.cat([x, Bm, Cm], dim=-1)
    if init is not None:
        u_ext = torch.cat([init.conv.to(u.dtype), u], dim=1)
        conv = _causal_conv(u_ext, p.conv_w, p.conv_b)[:, W - 1:]
    else:
        conv = _causal_conv(u, p.conv_w, p.conv_b)
    x, Bm, Cm = conv[..., :di], conv[..., di:di + N], conv[..., di + N:]
    dt = F.softplus(dtr.float() + p.dt_bias)                       # (B,S,H)
    A = -torch.exp(p.A_log)
    xh = x.reshape(B, S, H, P).contiguous()
    y, ssd_state = ops.ssd(xh, dt, A, Bm.float().contiguous(), Cm.float().contiguous(),
                           chunk=cfg.ssm_chunk,
                           init_state=init.ssd.contiguous() if init is not None else None)
    y = y.float() + p.D[None, None, :, None] * xh.float()
    y = y.reshape(B, S, di).to(h.dtype)
    y = _gated_norm(p.norm, y, z, cfg.norm_eps)
    out = (y @ p.out_proj).to(h.dtype)
    if init is not None:
        new_conv = torch.cat([init.conv.to(u.dtype), u], dim=1)[:, -(W - 1):]
    elif S >= W - 1:
        new_conv = u[:, -(W - 1):]
    else:
        new_conv = F.pad(u, (0, 0, W - 1 - S, 0))
    return out, SSMState(conv=new_conv, ssd=ssd_state)


def ssm_state_init(batch: int, cfg: ModelConfig, device,
                   layers: Optional[int] = None) -> SSMState:
    """Zero state; ``layers`` adds a leading layer axis."""
    di, N, H, P, W = (cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_headdim,
                      cfg.conv_width)
    lead = (layers,) if layers is not None else ()
    return SSMState(
        conv=torch.zeros((*lead, batch, W - 1, di + 2 * N), dtype=cdtype(cfg), device=device),
        ssd=torch.zeros((*lead, batch, H, P, N), dtype=torch.float32, device=device))


def ssm_decode(p: SSM, h: torch.Tensor, state: SSMState, cfg: ModelConfig) -> torch.Tensor:
    """One-token step. h (B,D) -> (B,D). Writes the new state into
    ``state``'s own tensors (the conv window moved on by one input, the SSD
    state decayed and updated)."""
    B, _ = h.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_headdim
    proj = h @ p.in_proj
    z, x, Bm, Cm, dtr = _split_proj(proj, cfg)
    u = torch.cat([x, Bm, Cm], dim=-1)                               # (B, ch)
    win = torch.cat([state.conv, u[:, None]], dim=1)                 # (B, W, ch)
    conv = F.silu(torch.einsum("bwc,wc->bc", win, p.conv_w) + p.conv_b)
    x, Bm, Cm = conv[..., :di], conv[..., di:di + N], conv[..., di + N:]
    dt = F.softplus(dtr.float() + p.dt_bias)                         # (B,H)
    A = -torch.exp(p.A_log)
    xh = x.reshape(B, H, P).float()
    decay = torch.exp(dt * A)
    contrib = torch.einsum("bh,bhp,bn->bhpn", dt, xh, Bm.float())
    ssd = decay[:, :, None, None] * state.ssd + contrib
    y = torch.einsum("bn,bhpn->bhp", Cm.float(), ssd)
    y = y + p.D[None, :, None] * xh
    y = y.reshape(B, di).to(h.dtype)
    y = _gated_norm(p.norm, y, z, cfg.norm_eps)
    out = (y @ p.out_proj).to(h.dtype)
    state.conv.copy_(win[:, 1:])   # win is a new tensor: the copy does not overlap
    state.ssd.copy_(ssd)
    return out
