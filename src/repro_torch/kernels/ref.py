"""Plain PyTorch versions of the attention kernels: full score matrices.

These compute what the CUDA kernels compute, in the simplest correct way,
so that the CPU tests and ``chip_smoke.py`` hold the kernels against
something independently simple. They repeat the kernels' arithmetic: scores
and softmax in float32 from inputs upcast to float32, masked scores at
-1e30, the probabilities rounded to the value dtype before the PV product,
which accumulates in float32.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  seq_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B,Sq,H,hd), k/v (B,Sk,KVH,hd) -> (B,Sq,H,hd).

    seq_lens (B,) int32: per-row real lengths (ragged prefill). Keys at or
    beyond a row's length are masked out; query rows at or beyond it are
    zeroed (their inputs are padding — the value must not be consumed).
    """
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    kk = k.repeat_interleave(G, dim=2).float()
    vv = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) * hd ** -0.5
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    mask = mask.expand(B, Sq, Sk)
    if seq_lens is not None:
        mask = mask & (kpos[None] < seq_lens[:, None, None])
    s = torch.where(mask[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p.float(), vv.float()).to(q.dtype)
    if seq_lens is not None:
        rows = torch.arange(Sq, device=q.device)[None, :] < seq_lens[:, None]
        out = torch.where(rows[..., None, None], out, torch.zeros((), dtype=out.dtype,
                                                                  device=out.device))
    return out


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         slot_pos: torch.Tensor, pos: torch.Tensor, *,
                         window: Optional[int] = None) -> torch.Tensor:
    """q (B,H,hd), cache k/v (B,L,KVH,hd), slot_pos (B,L), pos (B,)."""
    B, H, hd = q.shape
    KVH = k.shape[2]
    G = H // KVH
    kk = k.repeat_interleave(G, dim=2).float()
    vv = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bhd,blhd->bhl", q.float(), kk) * hd ** -0.5
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None])
    if window is not None:
        valid &= slot_pos > (pos[:, None] - window)
    s = torch.where(valid[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhl,blhd->bhd", p.float(), vv.float()).to(q.dtype)
