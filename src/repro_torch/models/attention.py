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
``kernels.ops.paged_decode_attention`` (a native pool) or
``kernels.ops.paged_decode_attention_quant`` (a pool with a quantized
region), which read the pages through the tables and so replace the
reference's ``_pool_read`` gather and dequantization.

Unlike the reference, which returns new caches, the port writes K/V into
the cache tensors and pools it is handed, in place.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.cache.precision import (KVPrecision, parse_kv_precision,
                                         resolve_kv_precision)
from repro_torch.configs.base import ModelConfig
from repro_torch.device import host_to_device
from repro_torch.kernels import ops
from repro_torch.kernels.quant import qdtype_of, quantize_kv
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
    """Shared-pool paged KV storage. In a decode state each leaf carries a
    leading layer axis; the attention functions take one layer's view of it.

    Rows are owned through ``repro_torch.cache.PageAllocator`` block
    tables; logical slot j of a request lives at (table[j // page_size],
    j % page_size) and holds absolute position j — paged caches never wrap,
    they grow by appending pages. Recycled pages are not zeroed: the
    validity mask (j <= pos on allocated pages) hides stale rows.

    Physical page ids fall in two regions: ids [0, native_pages) live in
    k/v at the compute dtype; ids [native_pages, num_pages) live in qk/qv
    as int8 or fp8 codes with k_scale/v_scale, one float32 scale per token
    and KV head. Either region may be empty (its leaves None); a pool with
    no quantized region is the native pool of two leaves.
    """

    k: Optional[torch.Tensor]             # (native_pages, ps, KVH, hd), RoPE applied
    v: Optional[torch.Tensor]
    qk: Optional[torch.Tensor] = None     # (quant_pages, ps, KVH, hd) codes
    qv: Optional[torch.Tensor] = None
    k_scale: Optional[torch.Tensor] = None  # (quant_pages, ps, KVH) float32
    v_scale: Optional[torch.Tensor] = None

    @property
    def native_pages(self) -> int:
        return self.k.shape[-4] if self.k is not None else 0

    @property
    def quant_pages(self) -> int:
        return self.qk.shape[-4] if self.qk is not None else 0

    @property
    def num_pages(self) -> int:
        return self.native_pages + self.quant_pages

    @property
    def page_size(self) -> int:
        return (self.k if self.k is not None else self.qk).shape[-3]

    def layer(self, i: int) -> "PagedKVPool":
        return PagedKVPool(*(None if t is None else t[i] for t in self))


def paged_pool_init(num_pages: int, page_size: int, cfg: ModelConfig, device,
                    layers: Optional[int] = None,
                    native_pages: Optional[int] = None) -> PagedKVPool:
    """Zeroed pool; ``layers`` adds a leading layer axis. Under a quantized
    ``cfg.kv_precision`` the top ``num_pages - native_pages`` ids form the
    quantized region (``native_pages`` None: every page quantized; at
    native precision: none)."""
    prec = resolve_kv_precision(cfg.kv_precision, cfg.cache_dtype)
    if native_pages is None:
        native_pages = 0 if prec.is_quantized else num_pages
    nq = num_pages - native_pages
    if nq and not prec.is_quantized:
        raise ValueError("a quantized page region needs a quantized kv_precision")
    lead = (layers,) if layers is not None else ()
    kw = {}
    if native_pages:
        shape = (*lead, native_pages, page_size, cfg.n_kv_heads, cfg.head_dim_)
        kw.update(k=torch.zeros(shape, dtype=cdtype(cfg), device=device),
                  v=torch.zeros(shape, dtype=cdtype(cfg), device=device))
    else:
        kw.update(k=None, v=None)
    if nq:
        shape = (*lead, nq, page_size, cfg.n_kv_heads, cfg.head_dim_)
        qdt = qdtype_of(prec)
        kw.update(qk=torch.zeros(shape, dtype=qdt, device=device),
                  qv=torch.zeros(shape, dtype=qdt, device=device),
                  k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                  v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device))
    return PagedKVPool(**kw)


def _pool_precision(pool: PagedKVPool) -> KVPrecision:
    """The quantized region's spec, from its code dtype."""
    return parse_kv_precision(str(pool.qk.dtype).removeprefix("torch."))


def _quant_write(pool: PagedKVPool, index: tuple, k: torch.Tensor, v: torch.Tensor) -> None:
    """Quantize K and V rows (..., KVH, hd) and write codes and scales into
    the quantized region in place, at ``index``: leading slices over the
    pool's layer axes, then region-local page ids (and rows in the page).
    One quantization covers K and V stacked."""
    codes, scale = quantize_kv(torch.stack((k, v)), _pool_precision(pool))
    pool.qk[index] = codes[0]
    pool.qv[index] = codes[1]
    pool.k_scale[index] = scale[0]
    pool.v_scale[index] = scale[1]


class PagedWrites(NamedTuple):
    """Where one decode step writes each row's new K/V: only the rows whose
    position falls in an allocated page of their block table, split by the
    page's region (quantized pages by their region-local id)."""

    rows: torch.Tensor    # (k,) int64 batch rows that write a native page
    pages: torch.Tensor   # (k,) int64 native page of each
    offs: torch.Tensor    # (k,) int64 row inside the page
    qrows: torch.Tensor   # (kq,) int64 batch rows that write a quantized page
    qpages: torch.Tensor  # (kq,) int64 its id minus native_pages
    qoffs: torch.Tensor   # (kq,) int64


def paged_write_targets(block_table: torch.Tensor, pos: torch.Tensor, native_pages: int,
                        num_pages: int, page_size: int) -> PagedWrites:
    """The rows of ``block_table`` (B, MP) that write position ``pos`` (B,),
    by region.

    The reference scatters every row into each region and drops the ids
    outside it (an inactive row's -1 page becomes id num_pages,
    ``mode="drop"``). PyTorch has no dropping scatter, and clamping would
    overwrite a page another request owns, so the rows are selected: an
    inactive row (all -1), a position past the table or an unallocated page
    writes nowhere. One stable sort orders the rows native first, then
    quantized, then the rest, and the two counts are read back to the host
    together: one readback per decode step, whatever the pool's regions
    (all layers share the result).
    """
    MP = block_table.shape[1]
    lp = torch.div(pos, page_size, rounding_mode="floor")
    page = block_table.gather(1, lp.clamp(0, MP - 1).long()[:, None])[:, 0].long()
    ok = (lp < MP) & (page >= 0) & (page < num_pages)
    key = torch.where(ok, (page >= native_pages).long(), 2)   # 0 native, 1 quantized
    order = torch.argsort(key, stable=True)
    n_native, n_quant = torch.stack(((key == 0).sum(), (key == 1).sum())).tolist()
    rows, qrows = order[:n_native], order[n_native:n_native + n_quant]
    offs = pos.long() % page_size
    return PagedWrites(rows, page[rows], offs[rows],
                       qrows, page[qrows] - native_pages, offs[qrows])


def attn_decode_paged(p: Attention, x: torch.Tensor, pool: PagedKVPool,
                      block_table: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig,
                      writes: Optional[PagedWrites] = None) -> torch.Tensor:
    """One decode step against the paged pool: rope at pos, write the new
    row into its block-table page in place (quantized there when the page
    lies in the quantized region), then attend over the row's pages. x
    (B, D); block_table (B, MP) int32 (-1 = unallocated); pos (B,) int32,
    the position of the new token. ``writes`` (from
    ``paged_write_targets``) lets the layers of one step share the
    selection.

    Mirrors ``attn_decode`` op for op, so with a native pool and
    MP * page_size == cache_len the two paths are bit-identical on the CPU:
    the plain paged attention gathers exactly the dense cache and its mask
    equals the dense one. On the card the kernels read the pages in place
    (K3 for a native pool, K3q for one with a quantized region, dequantizing
    as they load); nothing is gathered.
    """
    q, k, v = p.qkv(x, cfg)
    q = apply_rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    k = apply_rope(k[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    if writes is None:
        writes = paged_write_targets(block_table, pos, pool.native_pages, pool.num_pages,
                                     pool.page_size)
    if writes.rows.numel():
        pool.k[writes.pages, writes.offs] = k[writes.rows].to(pool.k.dtype)
        pool.v[writes.pages, writes.offs] = v[writes.rows].to(pool.v.dtype)
    if writes.qrows.numel():
        _quant_write(pool, (writes.qpages, writes.qoffs), k[writes.qrows], v[writes.qrows])
    if pool.qk is None:
        o = ops.paged_decode_attention(q, pool.k, pool.v, block_table, pos)
    else:
        o = ops.paged_decode_attention_quant(q, pool.k, pool.v, pool.qk, pool.qv,
                                             pool.k_scale, pool.v_scale, block_table, pos)
    return p.out(o)


def paged_splice_prompt(pool: PagedKVPool, cache: KVCache, page_idx: np.ndarray) -> None:
    """Copy a prefill-built dense cache into the page pool, in place.

    cache k/v: (..., B, P, KVH, hd) with the prompt in slots 0..P-1
    (prefill with cache_len == P never wraps), at the compute dtype; pool
    leaves (..., N, ps, KVH, hd) with the same leading (layer) axes.
    page_idx (B, P // ps), on the host: the physical page of each prompt
    block; pad rows and blocks past a prompt's pages carry an id outside
    [0, N). Those entries are left out (the reference's scatter drops
    them), so only the listed pages change. Blocks bound for the quantized
    region are quantized there; the ids are on the host, so the split by
    region costs no readback.
    """
    B, P = cache.k.shape[-4], cache.k.shape[-3]
    npp = page_idx.shape[1]
    ps = P // npp
    nn = pool.native_pages
    dev = (pool.k if pool.k is not None else pool.qk).device
    k_blocks = cache.k.unflatten(-3, (npp, ps))          # (..., B, npp, ps, KVH, hd)
    v_blocks = cache.v.unflatten(-3, (npp, ps))
    for quant, lo, hi in ((False, 0, nn), (True, nn, pool.num_pages)):
        rows, cols = np.nonzero((page_idx >= lo) & (page_idx < hi))
        if not len(rows):
            continue
        idx = torch.as_tensor(np.stack([rows, cols, page_idx[rows, cols] - lo]).astype(np.int64),
                              device=dev)
        kb = k_blocks[..., idx[0], idx[1], :, :, :]
        vb = v_blocks[..., idx[0], idx[1], :, :, :]
        if not quant:
            pool.k[..., idx[2], :, :, :] = kb.to(pool.k.dtype)
            pool.v[..., idx[2], :, :, :] = vb.to(pool.v.dtype)
        else:
            _quant_write(pool, (slice(None),) * (pool.qk.dim() - 4) + (idx[2],), kb, vb)
