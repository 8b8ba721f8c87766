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


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, block_tables: torch.Tensor,
                               pos: torch.Tensor) -> torch.Tensor:
    """Paged decode: gather the pages, then the dense ``decode_attention_ref``.

    q (B,H,hd); pools (N,ps,KVH,hd); block_tables (B,MP) int32 physical page
    per logical page (-1 = unallocated); pos (B,) the position just written.
    Logical slot j (page j // ps, row j % ps) holds absolute position j —
    paged caches never wrap — so a slot is valid when its page is allocated
    and j <= pos. With MP * ps == L and an allocated prefix this is bit for
    bit the dense version on the gathered cache (same shapes, masks and
    reduction order). A row with no valid slot averages page 0's V (a
    uniform softmax over masked scores), as the TPU kernel does.
    """
    B, H, hd = q.shape
    N, ps, KVH, _ = k_pages.shape
    MP = block_tables.shape[1]
    phys = block_tables.clamp(0, N - 1).long()
    kk = k_pages[phys].reshape(B, MP * ps, KVH, hd)
    vv = v_pages[phys].reshape(B, MP * ps, KVH, hd)
    j = torch.arange(MP * ps, dtype=torch.int32, device=q.device)[None, :]
    allocated = (block_tables >= 0).repeat_interleave(ps, dim=1)
    slot_pos = torch.where(allocated, j, -1)
    return decode_attention_ref(q, kk, vv, slot_pos, pos)


def chunk_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        slot_pos: torch.Tensor, pos0: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """Chunked-prefill attention: C chunk queries per row against the row's
    cache, full masked softmax.

    q (B,C,H,hd); cache k/v (B,L,KVH,hd), already holding the chunk;
    slot_pos (B,L) absolute position per slot (-1 empty); pos0 (B,) the
    chunk's first position; valid (B,) its real tokens. Query i of row b
    sits at pos0[b] + i and sees the slots with 0 <= slot_pos <= that
    position; query rows at or beyond ``valid`` are zeros (padding, never
    consumed), so a row with valid 0 is all zeros.
    """
    B, C, H, hd = q.shape
    KVH = k.shape[2]
    G = H // KVH
    kk = k.repeat_interleave(G, dim=2).float()
    vv = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,blhd->bhql", q.float(), kk) * hd ** -0.5
    cols = torch.arange(C, device=q.device)
    qpos = pos0[:, None] + cols[None, :]                         # (B, C)
    sp = slot_pos[:, None, :]
    ok = (sp >= 0) & (sp <= qpos[:, :, None])                     # (B, C, L)
    s = torch.where(ok[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bhql,blhd->bqhd", p.float(), vv.float()).to(q.dtype)
    rows = cols[None, :] < valid[:, None]
    return torch.where(rows[..., None, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))
