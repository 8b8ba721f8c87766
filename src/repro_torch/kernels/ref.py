"""Plain PyTorch versions of the kernels: the attention kernels with full
score matrices, and the SSD scan (``ssd_chunked``, with ``ssd_ref`` its
sequential oracle).

These compute what the CUDA kernels compute, in the simplest correct way,
so that the CPU tests and ``chip_smoke.py`` hold the kernels against
something independently simple. The attention versions repeat the
kernels' arithmetic: scores and softmax in float32 from inputs upcast to
float32, masked scores at -1e30, the probabilities rounded to the value
dtype before the PV product, which accumulates in float32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

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


def dequant_ref(codes: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Per-token-per-head dequantization: codes (..., hd) int8/fp8, scale
    (...) float32 over the head dim, ``codes * scale`` in float32, then the
    cast to ``dtype``."""
    return (codes.float() * scale[..., None]).to(dtype)


def paged_decode_attention_quant_ref(q: torch.Tensor, qk_pages: torch.Tensor,
                                     qv_pages: torch.Tensor, k_scale: torch.Tensor,
                                     v_scale: torch.Tensor, block_tables: torch.Tensor,
                                     pos: torch.Tensor) -> torch.Tensor:
    """Paged decode over an all-quantized pool: dequantize the whole pool
    (codes (N, ps, KVH, hd), scales (N, ps, KVH)) to q's dtype, then
    ``paged_decode_attention_ref``."""
    return paged_decode_attention_ref(q, dequant_ref(qk_pages, k_scale, q.dtype),
                                      dequant_ref(qv_pages, v_scale, q.dtype),
                                      block_tables, pos)


def pool_gather_ref(block_tables: torch.Tensor, dtype: torch.dtype,
                    k_pages: Optional[torch.Tensor], v_pages: Optional[torch.Tensor],
                    qk_pages: Optional[torch.Tensor] = None,
                    qv_pages: Optional[torch.Tensor] = None,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> tuple:
    """Every row's logical K/V through its block table (B, MP), page by page
    as the reference's ``_pool_read`` gathers: an id below N_n (the native
    pages (N_n, ps, KVH, hd), None for none) reads the native region, an id
    at or above it the quantized one at ``id - N_n`` (codes with scales,
    None for none), dequantized; -1 entries read a clamped page (the caller
    masks them). Returns k, v (B, MP * ps, KVH, hd) in ``dtype``."""
    B, MP = block_tables.shape
    Nn = 0 if k_pages is None else k_pages.shape[0]
    if qk_pages is None:
        nidx = block_tables.clamp(0, Nn - 1).long()
        kk, vv = k_pages[nidx].to(dtype), v_pages[nidx].to(dtype)
    else:
        qidx = (block_tables - Nn).clamp(0, qk_pages.shape[0] - 1).long()
        kk = dequant_ref(qk_pages[qidx], k_scale[qidx], dtype)
        vv = dequant_ref(qv_pages[qidx], v_scale[qidx], dtype)
        if k_pages is not None:
            nidx = block_tables.clamp(0, Nn - 1).long()
            native = ((block_tables >= 0) & (block_tables < Nn))[:, :, None, None, None]
            kk = torch.where(native, k_pages[nidx].to(dtype), kk)
            vv = torch.where(native, v_pages[nidx].to(dtype), vv)
    ps, KVH, hd = kk.shape[2:]
    return kk.reshape(B, MP * ps, KVH, hd), vv.reshape(B, MP * ps, KVH, hd)


def _table_slot_pos(block_tables: torch.Tensor, ps: int) -> torch.Tensor:
    """(B, MP * ps) int32: logical slot j holds position j on an allocated
    page, -1 on an unallocated one."""
    MP = block_tables.shape[1]
    j = torch.arange(MP * ps, dtype=torch.int32, device=block_tables.device)[None, :]
    return torch.where((block_tables >= 0).repeat_interleave(ps, dim=1), j, -1)


def paged_decode_attention_mixed_ref(q: torch.Tensor, k_pages: torch.Tensor,
                                     v_pages: torch.Tensor, qk_pages: torch.Tensor,
                                     qv_pages: torch.Tensor, k_scale: torch.Tensor,
                                     v_scale: torch.Tensor, block_tables: torch.Tensor,
                                     pos: torch.Tensor) -> torch.Tensor:
    """Paged decode over a two-region pool: ``pool_gather_ref`` (native
    pages k_pages/v_pages in q's dtype, quantized ones dequantized to it;
    unallocated entries read quantized page 0 and are masked), then the
    dense ``decode_attention_ref`` with the mask of
    ``paged_decode_attention_ref``."""
    kk, vv = pool_gather_ref(block_tables, q.dtype, k_pages, v_pages, qk_pages, qv_pages,
                             k_scale, v_scale)
    return decode_attention_ref(q, kk, vv, _table_slot_pos(block_tables, k_pages.shape[1]),
                                pos)


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


def chunk_attention_quant_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              k_scale: torch.Tensor, v_scale: torch.Tensor,
                              slot_pos: torch.Tensor, pos0: torch.Tensor,
                              valid: torch.Tensor) -> torch.Tensor:
    """K4q's plain version: dequantize the cache (codes (B,L,KVH,hd), scales
    (B,L,KVH)) to q's dtype, then ``chunk_attention_ref``."""
    return chunk_attention_ref(q, dequant_ref(k, k_scale, q.dtype),
                               dequant_ref(v, v_scale, q.dtype), slot_pos, pos0, valid)


def paged_chunk_attention_ref(q: torch.Tensor, k_pages: Optional[torch.Tensor],
                              v_pages: Optional[torch.Tensor],
                              qk_pages: Optional[torch.Tensor],
                              qv_pages: Optional[torch.Tensor],
                              k_scale: Optional[torch.Tensor],
                              v_scale: Optional[torch.Tensor], block_tables: torch.Tensor,
                              pos0: torch.Tensor, valid: torch.Tensor, *,
                              stage_k: Optional[torch.Tensor] = None,
                              stage_v: Optional[torch.Tensor] = None,
                              base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4p's plain version, the reference's ``attn_chunk_paged`` attention:
    gather the pool (``pool_gather_ref``) and, with staging buffers (B, S,
    KVH, hd), concatenate them after it; pool slot j counts as position j
    when its page is allocated (and, with staging, j < base), staging slot
    j as position j when j >= base. Then ``chunk_attention_ref``, whose
    mask keeps the positions <= each query's and zeros rows at or past
    ``valid``."""
    kk, vv = pool_gather_ref(block_tables, q.dtype, k_pages, v_pages, qk_pages, qv_pages,
                             k_scale, v_scale)
    ps = (k_pages if k_pages is not None else qk_pages).shape[1]
    sp = _table_slot_pos(block_tables, ps)
    if stage_k is not None:
        sp = torch.where(sp < base[:, None], sp, -1)
        js = torch.arange(stage_k.shape[1], dtype=torch.int32, device=q.device)[None, :]
        kk = torch.cat([kk, stage_k.to(q.dtype)], dim=1)
        vv = torch.cat([vv, stage_v.to(q.dtype)], dim=1)
        sp = torch.cat([sp, torch.where(js >= base[:, None], js, -1)], dim=1)
    return chunk_attention_ref(q, kk, vv, sp, pos0, valid)


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
            Cm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The SSD recurrence one step at a time (the literal SSM), from a zero
    state: h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = C_t . h_t.

    x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm (B,S,N). Returns y (B,S,H,P) in
    x's dtype and the final state (B,H,P,N) float32.
    """
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    A = A.float()
    state = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        dtt = dt[:, t].float()                                       # (B,H)
        decay = torch.exp(dtt * A)
        contrib = torch.einsum("bh,bhp,bn->bhpn", dtt, x[:, t].float(), Bm[:, t].float())
        state = decay[..., None, None] * state + contrib
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t].float(), state))
    return torch.stack(ys, dim=1).to(x.dtype), state


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan, the plain version of the SSD kernel.

    x (B,S,H,P), dt (B,S,H) post-softplus, A (H,) negative, Bm/Cm (B,S,N),
    ``init_state`` (B,H,P,N) float32 or None (zeros). Returns y (B,S,H,P)
    in x's dtype and the final state (B,H,P,N) float32.

    A sequence that is not a multiple of ``chunk`` is padded with dt = 0:
    the decay there is exp(0) = 1 and the contribution 0, so the final
    state is the state after the real steps. Within a chunk, LA is the
    cumulative sum of dt*A and the intra-chunk weights exp(LA_q - LA_s)
    are taken with the exponent masked at -1e9 above the diagonal. The
    rounding is the reference's: the weights are cast to x's dtype before
    they multiply x, and the carried state's contribution is cast to x's
    dtype before the two parts are added.
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = (S + pad) // chunk
    xc = x.reshape(Bsz, nc, chunk, H, P)
    dtc = dt.reshape(Bsz, nc, chunk, H)
    Bc = Bm.reshape(Bsz, nc, chunk, N)
    Cc = Cm.reshape(Bsz, nc, chunk, N)
    dA = dtc * A                                            # (B,nc,Q,H)
    LA = torch.cumsum(dA, dim=2)
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    state = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
             if init_state is None else init_state)
    ys = []
    for c in range(nc):
        xq, dtq, Bq, Cq, dAq, LAq = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c], dA[:, c], LA[:, c]
        diff = LAq[:, :, None, :] - LAq[:, None, :, :]         # (B,Q,Q,H)
        M = torch.exp(torch.where(tril[None, :, :, None], diff, -1e9))
        G = torch.einsum("bqn,bsn->bqs", Cq, Bq)
        W = G[..., None] * M * dtq[:, None, :, :]
        y_intra = torch.einsum("bqsh,bshp->bqhp", W.to(xq.dtype), xq)
        decay_q = torch.exp(LAq)                               # (B,Q,H)
        y_inter = torch.einsum("bqn,bhpn,bqh->bqhp", Cq.float(), state,
                               decay_q).to(xq.dtype)
        tail = torch.exp(LAq[:, -1:, :] - LAq)
        contrib = torch.einsum("bqh,bqhp,bqn->bhpn", (tail * dtq).float(), xq.float(),
                               Bq.float())
        state = torch.exp(dAq.sum(1))[:, :, None, None] * state + contrib
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(Bsz, nc * chunk, H, P)
    return y[:, :S], state
