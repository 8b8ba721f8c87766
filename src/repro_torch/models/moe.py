"""Mixture-of-Experts FFN: top-k routing, capacity-bounded gather dispatch.

The reference package's ``models/moe.py`` step by step, at fixed shapes
with nothing read back to the host, so the dispatch runs inside the decode
and admission CUDA graphs:
  1. router logits (T, E) in float32, softmax, top-k of the probabilities
     (ties to the lower expert index, as ``jax.lax.top_k``), renormalized.
  2. each assignment's slot in its expert by a cumulative count in flat
     (token, k) order; slots at or beyond the capacity
     C = ceil(top_k * T / E * capacity_factor) (rounded up to 8) drop.
  3. an (E, C) table gathers the tokens into per-expert buffers, the
     (E, C, D) @ (E, D, F) batched matmuls run the experts, and each token
     adds its experts' weighted outputs in float32.

The reference writes its (E, C) table with a scatter in which every
dropped assignment lands on cell (expert 0, slot C-1), and the last write
in flat order wins there: whenever an assignment of the block drops, the
token kept in expert 0's last slot may lose it and get nothing from
expert 0 (ROADMAP.md R8). The port makes that rule explicit: each cell
belongs to the highest flat index that writes it (a max-scatter, the
same on every launch), and a token receives an expert's output only
through the cell it owns. Its contributions are added in ascending expert
order from 0.0, the order of the reference's scatter-add, with no atomics,
so a graph replay equals an eager run bit for bit.

DeepSeekMoE's ``n_shared_experts`` always-on experts are one dense MLP of
width ``n_shared_experts * moe_d_ff`` added to the routed output;
``first_k_dense`` is the stack's leading dense segment
(``transformer.plan_segments``). The auxiliary terms (load balance,
router z-loss, dropped share) come from ``moe_aux``, which serving never
calls.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import cdtype, mlp, param


class MLP(nn.Module):
    """A SiLU-gated MLP's weights: w_gate/w_up (D, F), w_down (F, D)."""

    def __init__(self, d: int, f: int, dtype, device):
        super().__init__()
        self.w_gate = param((d, f), dtype, device)
        self.w_up = param((d, f), dtype, device)
        self.w_down = param((f, d), dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(self.w_gate, self.w_up, self.w_down, x)


class MoE(nn.Module):
    """The reference's ``moe`` leaves: ``router`` (D, E) float32, the
    experts' ``w_gate``/``w_up`` (E, D, F) and ``w_down`` (E, F, D) in the
    compute dtype, and the shared experts' MLP (``shared``, None without)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        E, D, Fd, dt = cfg.n_experts, cfg.d_model, cfg.moe_d_ff, cdtype(cfg)
        self.router = param((D, E), torch.float32, device)
        self.w_gate = param((E, D, Fd), dt, device)
        self.w_up = param((E, D, Fd), dt, device)
        self.w_down = param((E, Fd, D), dt, device)
        self.shared = MLP(D, cfg.n_shared_experts * Fd, dt, device) \
            if cfg.n_shared_experts else None


def expert_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = math.ceil(cfg.top_k * n_tokens / cfg.n_experts * cfg.capacity_factor)
    # a multiple of 8 lanes, and >= top_k for tiny smoke shapes
    return max(int(math.ceil(c / 8) * 8), cfg.top_k)


def route(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest probabilities of each row and their experts, in
    descending order, equal ones in ascending expert order (a stable sort:
    ``torch.topk`` promises no order among ties)."""
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    return top_p[..., :k], top_e[..., :k]


class Routing(NamedTuple):
    """One block's routing, kept for ``moe_aux``: router logits and
    probabilities (T, E), the chosen experts (T, K) and which assignments
    fit their expert's capacity (T*K,)."""

    logits: torch.Tensor
    probs: torch.Tensor
    top_e: torch.Tensor
    keep: torch.Tensor


def moe_ffn(moe: MoE, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, list]:
    """x (..., D) -> (y (..., D), routings). Tokens are dispatched in blocks
    of ``cfg.moe_block`` when there are more of them and the block divides
    them (capacity is per block), else all at once. ``routings`` holds each
    block's ``Routing``; the reference's auxiliary terms are ``moe_aux`` of
    each, averaged over the blocks (serving drops them)."""
    lead, D = x.shape[:-1], x.shape[-1]
    T = math.prod(lead)
    xt = x.reshape(T, D)
    blk = cfg.moe_block
    blocks = xt.split(blk) if T > blk and T % blk == 0 else (xt,)
    outs = [_moe_block(moe, xb, cfg) for xb in blocks]
    y = torch.cat([o[0] for o in outs]) if len(outs) > 1 else outs[0][0]
    return y.reshape(*lead, D), [o[1] for o in outs]


def _moe_block(moe: MoE, xt: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, Routing]:
    """Dispatch, expert compute and combine for one (T, D) token block."""
    T, D = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    C = expert_capacity(T, cfg)
    dev = xt.device

    logits = xt.float() @ moe.router                              # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = route(probs, K)                                # (T, K)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)               # renormalize

    # --- capacity assignment: each assignment's slot in its expert, a
    # running count over the one-hot in flat order (laid out (E, T*K) so
    # the scan runs along the contiguous dim)
    flat_e = top_e.reshape(-1)                                    # (T*K,)
    onehot = (torch.arange(E, device=dev)[:, None] == flat_e).to(torch.int32)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32).gather(0, flat_e[None])[0] - 1
    keep = pos < C
    # the cell each assignment writes: its own, or (0, C-1) when dropped;
    # each cell holds the highest flat index that writes it (R8)
    flat = torch.arange(T * K, device=dev)
    cell = torch.where(keep, flat_e * C + pos, C - 1)
    owner = torch.full((E * C,), -1, dtype=torch.int64, device=dev).scatter_reduce_(
        0, cell, flat, "amax")
    held = owner.clamp_min(0)
    valid = (owner >= 0) & keep[held]                             # (E*C,)
    table = torch.where(valid, held // K, 0).view(E, C)

    # --- expert compute
    xe = torch.where(valid.view(E, C, 1), xt[table], 0)           # (E, C, D)
    h = F.silu(torch.bmm(xe, moe.w_gate)) * torch.bmm(xe, moe.w_up)
    ye = torch.bmm(h, moe.w_down).view(E * C, D)

    # --- combine: each token's owned cells, ascending expert order, float32
    owns = keep & (owner[cell] == flat)                           # (T*K,)
    w = top_p.reshape(-1)
    order = top_e.argsort(dim=-1) + torch.arange(T, device=dev)[:, None] * K
    y = torch.zeros((T, D), dtype=torch.float32, device=dev)
    for j in range(K):
        i = order[:, j]
        y = y + torch.where(owns[i, None], ye[cell[i]].float() * w[i, None], 0.0)
    y = y.to(xt.dtype)
    if moe.shared is not None:
        y = y + moe.shared(xt)
    return y, Routing(logits, probs, top_e, keep)


def moe_aux(r: Routing, cfg: ModelConfig) -> dict:
    """The reference's auxiliary terms for one block: the switch-style
    load-balance loss (E * sum of dispatched share x mean probability per
    expert), the router z-loss and the share of assignments dropped."""
    E, K = cfg.n_experts, cfg.top_k
    chosen = (r.top_e[..., None] == torch.arange(E, device=r.top_e.device)).float()
    frac_dispatch = chosen.sum(1).mean(0) / K                     # (E,)
    return {"lb_loss": E * torch.sum(frac_dispatch * r.probs.mean(0)),
            "z_loss": torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2),
            "drop_frac": 1.0 - r.keep.float().mean()}
