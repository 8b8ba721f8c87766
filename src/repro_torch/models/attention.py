"""Self-attention with GQA, optional qk-norm, RoPE and the ring KV cache.

Shapes follow the reference package: x (B, S, D); q (B, S, H, hd); k, v
(B, S, KVH, hd); caches (B, cache_len, KVH, hd) with slot_pos
(B, cache_len) int32 (-1 = empty). The cache is a ring: each slot stores
the absolute position it holds, so slot validity comes from slot_pos, not
layout. Prefill attention goes to ``kernels.ops.flash_attention`` and
decode attention to ``kernels.ops.decode_attention`` and chunked-prefill
attention to ``kernels.ops.chunk_attention`` (the hand-written kernels on
the card, their plain versions on the CPU).

The paged path keeps K/V in a shared pool of pages (``PagedKVPool``) that
block tables index; its decode attention goes to
``kernels.ops.paged_decode_attention``, which reads the pages through the
tables and so replaces the reference's ``_pool_read`` gather.

Unlike the reference, which returns new caches, the port writes K/V into
the cache tensors and pools it is handed, in place.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import host_to_device
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, cdtype, param, rmsnorm


class Attention(nn.Module):
    """Projections in the reference layouts: wq (D,H,hd), wk/wv (D,KVH,hd),
    wo (H,hd,D); q_norm/k_norm (hd,) float32 when the config has qk-norm."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        D, H, KVH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        dt = cdtype(cfg)
        self.wq = param((D, H, hd), dt, device)
        self.wk = param((D, KVH, hd), dt, device)
        self.wv = param((D, KVH, hd), dt, device)
        self.wo = param((H, hd, D), dt, device)
        if cfg.qk_norm:
            self.q_norm = param((hd,), torch.float32, device)
            self.k_norm = param((hd,), torch.float32, device)

    def qkv(self, x: torch.Tensor, cfg: ModelConfig):
        """x (..., D) -> q (..., H, hd), k and v (..., KVH, hd), before RoPE."""
        D = x.shape[-1]
        lead = x.shape[:-1]
        q = (x @ self.wq.view(D, -1)).view(*lead, *self.wq.shape[1:])
        k = (x @ self.wk.view(D, -1)).view(*lead, *self.wk.shape[1:])
        v = (x @ self.wv.view(D, -1)).view(*lead, *self.wv.shape[1:])
        if cfg.qk_norm:
            q = rmsnorm(self.q_norm, q, cfg.norm_eps)
            k = rmsnorm(self.k_norm, k, cfg.norm_eps)
        return q, k, v

    def out(self, o: torch.Tensor) -> torch.Tensor:
        """o (..., H, hd) -> (..., D)."""
        H, hd, D = self.wo.shape
        return o.reshape(*o.shape[:-2], H * hd) @ self.wo.view(H * hd, D)


class KVCache(NamedTuple):
    """Dense ring cache at native precision. In a DecodeState each leaf
    carries a leading layer axis; the attention functions take one layer's
    view of it."""

    k: torch.Tensor          # (B, L, KVH, hd) — RoPE already applied
    v: torch.Tensor          # (B, L, KVH, hd)
    slot_pos: torch.Tensor   # (B, L) int32, absolute position held; -1 empty

    @property
    def cache_len(self) -> int:
        return self.k.shape[-3]

    def layer(self, i: int) -> "KVCache":
        return KVCache(self.k[i], self.v[i], self.slot_pos[i])


def kv_cache_init(batch: int, cache_len: int, cfg: ModelConfig, device,
                  layers: Optional[int] = None) -> KVCache:
    """Empty cache; ``layers`` adds a leading layer axis."""
    lead = (layers,) if layers is not None else ()
    shape = (*lead, batch, cache_len, cfg.n_kv_heads, cfg.head_dim_)
    return KVCache(
        k=torch.zeros(shape, dtype=cdtype(cfg), device=device),
        v=torch.zeros(shape, dtype=cdtype(cfg), device=device),
        slot_pos=torch.full((*lead, batch, cache_len), -1, dtype=torch.int32,
                            device=device),
    )


def attn_prefill(p: Attention, x: torch.Tensor, cfg: ModelConfig, cache: KVCache,
                 *, window: Optional[int] = None,
                 seq_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal self-attention over the prompt; fills the empty ``cache``.

    Stores the last ``cache_len`` roped K/V into the ring so that slot index
    = absolute_pos % cache_len. ``seq_lens`` (B,) int32 makes the prefill
    length-aware (ragged): attention runs the ragged kernel, and cache slots
    at or beyond a row's real length stay empty (zero K/V, slot_pos -1) so
    padding never enters decode attention.
    """
    B, S, _ = x.shape
    q, k, v = p.qkv(x, cfg)
    pos = torch.arange(S, device=x.device)[None, :]
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    o = ops.flash_attention(q, k, v, seq_lens, causal=True, window=window)
    y = p.out(o)

    L = cache.cache_len
    n = min(S, L)
    tail = torch.arange(S - n, S, device=x.device)   # absolute positions kept
    slots = tail % L                                  # ring placement
    kw = k[:, S - n:].to(cache.k.dtype)
    vw = v[:, S - n:].to(cache.v.dtype)
    spw = tail.to(torch.int32)[None, :].expand(B, n)
    if seq_lens is not None:
        keep = tail[None, :] < seq_lens[:, None]
        zero = torch.zeros((), dtype=kw.dtype, device=x.device)
        kw = torch.where(keep[..., None, None], kw, zero)
        vw = torch.where(keep[..., None, None], vw, zero)
        spw = torch.where(keep, spw, -1).to(torch.int32)
    cache.k[:, slots] = kw
    cache.v[:, slots] = vw
    cache.slot_pos[:, slots] = spw
    return y


def attn_decode(p: Attention, x: torch.Tensor, cache: KVCache, pos: torch.Tensor,
                cfg: ModelConfig, *, window: Optional[int] = None) -> torch.Tensor:
    """One decode step: rope at pos, write K/V into the ring in place, then
    attend over the valid slots. x (B, D); pos (B,) int32."""
    B = x.shape[0]
    q, k, v = p.qkv(x, cfg)
    q = apply_rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    k = apply_rope(k[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    slot = pos % cache.cache_len
    b_idx = torch.arange(B, device=x.device)
    cache.k[b_idx, slot] = k.to(cache.k.dtype)
    cache.v[b_idx, slot] = v.to(cache.v.dtype)
    cache.slot_pos[b_idx, slot] = pos
    o = ops.decode_attention(q, cache.k, cache.v, cache.slot_pos, pos, window=window)
    return p.out(o)


class ChunkWrites(NamedTuple):
    """Where one chunk dispatch writes K/V: the valid (row, chunk column)
    pairs, the ring slot and the absolute position of each. Built on the
    host, which knows every row's pos0 and valid, and shared by all layers."""

    rows: torch.Tensor    # (n,) int64 batch rows
    cols: torch.Tensor    # (n,) int64 chunk columns
    slots: torch.Tensor   # (n,) int64 ring slots, pos % cache_len
    pos: torch.Tensor     # (n,) int32 absolute positions


def chunk_write_targets(pos0: np.ndarray, valid: np.ndarray, cache_len: int,
                        device) -> ChunkWrites:
    """The (row, column) pairs a chunk writes: column c of row b for c <
    valid[b], at position pos0[b] + c. The reference scatters every pair
    and drops the rest (``mode="drop"``); PyTorch has no dropping scatter,
    so the host lists the valid pairs, and one pinned copy takes them to
    the device (a mask selection there would read a count back)."""
    valid = np.asarray(valid, np.int64)
    rows = np.repeat(np.arange(len(valid)), valid)
    cols = np.arange(len(rows)) - np.repeat(np.cumsum(valid) - valid, valid)
    pos = np.asarray(pos0, np.int64)[rows] + cols
    idx = host_to_device(np.stack([rows, cols, pos % cache_len, pos]), torch.device(device))
    return ChunkWrites(idx[0], idx[1], idx[2], idx[3].to(torch.int32))


def attn_chunk(p: Attention, x: torch.Tensor, cache: KVCache, pos0: torch.Tensor,
               valid: torch.Tensor, cfg: ModelConfig, writes: ChunkWrites, *,
               reset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Chunked-prefill attention: rope the chunk at pos0 + arange(C), write
    its valid K/V and slot_pos into the ring in place (``writes``), then
    attend the chunk's queries over the row's whole cache, earlier chunks
    and the chunk itself. x (B, C, D); pos0 and valid (B,) int32.

    ``reset`` (B,) bool marks rows whose cache still holds a previous
    tenant: their slot_pos is invalidated before the write (stale K/V need
    no zeroing, an invalid slot's weight is exactly 0). Query rows at or
    beyond ``valid`` come out as zeros; the caller never reads them.
    """
    B, C, _ = x.shape
    q, k, v = p.qkv(x, cfg)
    pos = pos0[:, None] + torch.arange(C, device=x.device)[None, :]
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    if reset is not None:
        cache.slot_pos.masked_fill_(reset[:, None], -1)
    cache.k[writes.rows, writes.slots] = k[writes.rows, writes.cols].to(cache.k.dtype)
    cache.v[writes.rows, writes.slots] = v[writes.rows, writes.cols].to(cache.v.dtype)
    cache.slot_pos[writes.rows, writes.slots] = writes.pos
    o = ops.chunk_attention(q, cache.k, cache.v, cache.slot_pos, pos0, valid)
    return p.out(o)


class PagedKVPool(NamedTuple):
    """Shared-pool paged KV storage at native precision. In a decode state
    each leaf carries a leading layer axis; the attention functions take one
    layer's view of it.

    k/v: (num_pages, page_size, KVH, hd). Rows are owned through
    ``repro_torch.cache.PageAllocator`` block tables; logical slot j of a
    request lives at (table[j // page_size], j % page_size) and holds
    absolute position j — paged caches never wrap, they grow by appending
    pages. Recycled pages are not zeroed: the validity mask (j <= pos on
    allocated pages) hides stale rows.
    """

    k: torch.Tensor   # (num_pages, page_size, KVH, hd) — RoPE already applied
    v: torch.Tensor

    @property
    def num_pages(self) -> int:
        return self.k.shape[-4]

    @property
    def page_size(self) -> int:
        return self.k.shape[-3]

    def layer(self, i: int) -> "PagedKVPool":
        return PagedKVPool(self.k[i], self.v[i])


def paged_pool_init(num_pages: int, page_size: int, cfg: ModelConfig, device,
                    layers: Optional[int] = None) -> PagedKVPool:
    """Zeroed pool; ``layers`` adds a leading layer axis."""
    lead = (layers,) if layers is not None else ()
    shape = (*lead, num_pages, page_size, cfg.n_kv_heads, cfg.head_dim_)
    return PagedKVPool(k=torch.zeros(shape, dtype=cdtype(cfg), device=device),
                       v=torch.zeros(shape, dtype=cdtype(cfg), device=device))


class PagedWrites(NamedTuple):
    """Where one decode step writes each row's new K/V: only the rows whose
    position falls in an allocated page of their block table."""

    rows: torch.Tensor    # (k,) int64 batch rows that write
    pages: torch.Tensor   # (k,) int64 physical page of each
    offs: torch.Tensor    # (k,) int64 row inside the page


def paged_write_targets(block_table: torch.Tensor, pos: torch.Tensor,
                        num_pages: int, page_size: int) -> PagedWrites:
    """The rows of ``block_table`` (B, MP) that write position ``pos`` (B,).

    The reference scatters every row and drops the out-of-range ones (an
    inactive row's -1 page becomes id num_pages, ``mode="drop"``). PyTorch
    has no dropping scatter, and clamping would overwrite a page another
    request owns, so the rows are selected by a mask and only those write:
    an inactive row (all -1), a position past the table or an unallocated
    page writes nowhere. Selecting them reads the row count back to the
    host once per decode step (all layers share the result).
    """
    MP = block_table.shape[1]
    lp = torch.div(pos, page_size, rounding_mode="floor")
    page = block_table.gather(1, lp.clamp(0, MP - 1).long()[:, None])[:, 0]
    ok = (lp < MP) & (page >= 0) & (page < num_pages)
    rows = ok.nonzero()[:, 0]
    return PagedWrites(rows, page[rows].long(), (pos[rows] % page_size).long())


def attn_decode_paged(p: Attention, x: torch.Tensor, pool: PagedKVPool,
                      block_table: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig,
                      writes: Optional[PagedWrites] = None) -> torch.Tensor:
    """One decode step against the paged pool: rope at pos, write the new
    row into its block-table page in place, then attend over the row's
    pages. x (B, D); block_table (B, MP) int32 (-1 = unallocated); pos (B,)
    int32, the position of the new token. ``writes`` (from
    ``paged_write_targets``) lets the layers of one step share the
    selection.

    Mirrors ``attn_decode`` op for op, so with MP * page_size == cache_len
    the two paths are bit-identical on the CPU: the plain paged attention
    gathers exactly the dense cache and its mask equals the dense one. On
    the card the kernel reads the pages in place; nothing is gathered.
    """
    q, k, v = p.qkv(x, cfg)
    q = apply_rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    k = apply_rope(k[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    if writes is None:
        writes = paged_write_targets(block_table, pos, pool.num_pages, pool.page_size)
    pool.k[writes.pages, writes.offs] = k[writes.rows].to(pool.k.dtype)
    pool.v[writes.pages, writes.offs] = v[writes.rows].to(pool.v.dtype)
    o = ops.paged_decode_attention(q, pool.k, pool.v, block_table, pos)
    return p.out(o)


def paged_splice_prompt(pool: PagedKVPool, cache: KVCache, page_idx: np.ndarray) -> None:
    """Copy a prefill-built dense cache into the page pool, in place.

    cache k/v: (..., B, P, KVH, hd) with the prompt in slots 0..P-1
    (prefill with cache_len == P never wraps); pool leaves (..., N, ps, KVH,
    hd) with the same leading (layer) axes. page_idx (B, P // ps), on the
    host: the physical page of each prompt block; pad rows and blocks past
    a prompt's pages carry an id outside [0, N). Those entries are left out
    (the reference's scatter drops them), so only the listed pages change.
    """
    B, P = cache.k.shape[-4], cache.k.shape[-3]
    npp = page_idx.shape[1]
    ps = P // npp
    rows, cols = np.nonzero((page_idx >= 0) & (page_idx < pool.num_pages))
    dev = pool.k.device
    dst = torch.as_tensor(page_idx[rows, cols].astype(np.int64), device=dev)
    src_r = torch.as_tensor(rows, device=dev)
    src_c = torch.as_tensor(cols, device=dev)
    for leaf, rows_kv in ((pool.k, cache.k), (pool.v, cache.v)):
        blocks = rows_kv.unflatten(-3, (npp, ps))          # (..., B, npp, ps, KVH, hd)
        leaf[..., dst, :, :, :] = blocks[..., src_r, src_c, :, :, :].to(leaf.dtype)
