"""Self-attention with GQA, optional qk-norm, RoPE and the ring KV cache.

Shapes follow the reference package: x (B, S, D); q (B, S, H, hd); k, v
(B, S, KVH, hd); caches (B, cache_len, KVH, hd) with slot_pos
(B, cache_len) int32 (-1 = empty). The cache is a ring: each slot stores
the absolute position it holds, so slot validity comes from slot_pos, not
layout. Prefill attention goes to ``kernels.ops.flash_attention`` and
decode attention to ``kernels.ops.decode_attention`` and chunked-prefill
attention to ``kernels.ops.chunk_attention`` (the hand-written kernels on
the card, their plain versions on the CPU).

Under a quantized KV precision (int8, fp8) the dense ring holds codes with
one float32 scale per token and KV head, written by quantizing each K/V
row as it enters, and the decode reads them through the dequantizing ring
kernel (K2q); native staging buffers beside the ring carry the chunked
prompt phase, as the reference's ``KVCache`` does. Under an unscaled
storage cast (the legacy ``cache_dtype``, or ``kv_precision`` naming a
float dtype) the ring and the native page region hold that dtype, each
row cast as it is written (``cast_to_storage``, the reference's XLA rule)
and each stored value rounded to the compute dtype as it is read (K2q's,
K3q's and K4p's unscaled routes on the card); the staging buffers carry
the chunked prompt phase as under a quantized precision.

The paged path keeps K/V in a shared pool of pages (``PagedKVPool``) that
block tables index; its decode attention goes to
``kernels.ops.paged_decode_attention`` (a native pool) or
``kernels.ops.paged_decode_attention_quant`` (a pool with a quantized
region), and its chunked-prefill attention to
``kernels.ops.paged_chunk_attention`` (any pool, with the staging buffers
of a lossy one), which read the pages through the tables and so replace
the reference's ``_pool_read`` gather and dequantization.

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
    wo (H,hd,D); q_norm/k_norm (hd,) float32 when the config has qk-norm
    (never on a ``cross`` attention, as the reference's ``attn_init``)."""

    def __init__(self, cfg: ModelConfig, device, cross: bool = False):
        super().__init__()
        D, H, KVH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        dt = cdtype(cfg)
        self.wq = param((D, H, hd), dt, device)
        self.wk = param((D, KVH, hd), dt, device)
        self.wv = param((D, KVH, hd), dt, device)
        self.wo = param((H, hd, D), dt, device)
        self.qk_norm = cfg.qk_norm and not cross
        if self.qk_norm:
            self.q_norm = param((hd,), torch.float32, device)
            self.k_norm = param((hd,), torch.float32, device)

    def _proj(self, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        D = x.shape[-1]
        return (x @ w.view(D, -1)).view(*x.shape[:-1], *w.shape[1:])

    def qkv(self, x: torch.Tensor, cfg: ModelConfig):
        """x (..., D) -> q (..., H, hd), k and v (..., KVH, hd), before RoPE."""
        q, k, v = self._proj(self.wq, x), self._proj(self.wk, x), self._proj(self.wv, x)
        if self.qk_norm:
            q = rmsnorm(self.q_norm, q, cfg.norm_eps)
            k = rmsnorm(self.k_norm, k, cfg.norm_eps)
        return q, k, v

    def out(self, o: torch.Tensor) -> torch.Tensor:
        """o (..., H, hd) -> (..., D)."""
        H, hd, D = self.wo.shape
        return o.reshape(*o.shape[:-2], H * hd) @ self.wo.view(H * hd, D)


class KVCache(NamedTuple):
    """Dense ring cache. In a DecodeState each leaf carries a leading layer
    axis; the attention functions take one layer's view of it.

    Under a quantized precision k/v hold int8 or fp8 codes and
    k_scale/v_scale the per-token-per-head float32 scales; under a lossy
    one stage_k/stage_v carry the chunked prompt phase's native staging
    buffers (``_staged``). The optional leaves are None at native
    precision, as the reference's are."""

    k: torch.Tensor          # (B, L, KVH, hd) — RoPE already applied
    v: torch.Tensor          # (B, L, KVH, hd)
    slot_pos: torch.Tensor   # (B, L) int32, absolute position held; -1 empty
    k_scale: Optional[torch.Tensor] = None  # (B, L, KVH) float32, quantized only
    v_scale: Optional[torch.Tensor] = None
    stage_k: Optional[torch.Tensor] = None  # (B, L, KVH, hd) compute dtype, staged only
    stage_v: Optional[torch.Tensor] = None

    @property
    def cache_len(self) -> int:
        return self.k.shape[-3]

    def layer(self, i: int) -> "KVCache":
        return KVCache(*(None if t is None else t[i] for t in self))


def _staged(prec: KVPrecision) -> bool:
    """Does the chunked prompt phase need native staging buffers? Exactly
    when the storage is lossy: chunk N re-reads chunk N-1's K/V, which must
    be the values a one-shot prefill attends."""
    return prec.lossy and prec.staging == "auto"


def kv_cache_init(batch: int, cache_len: int, cfg: ModelConfig, device,
                  layers: Optional[int] = None) -> KVCache:
    """Empty cache at ``cfg.kv_precision``: codes with scales under a
    quantized precision, the cast dtype under a cast, and the staging
    buffers under a lossy one, a cast to the compute dtype too (on
    every dense cache, whatever the loop, as the reference allocates
    them). ``layers`` adds a leading layer axis."""
    prec = resolve_kv_precision(cfg.kv_precision, cfg.cache_dtype)
    lead = (layers,) if layers is not None else ()
    shape = (*lead, batch, cache_len, cfg.n_kv_heads, cfg.head_dim_)
    store = storage_dtype(prec, cfg)
    kw = {}
    if prec.is_quantized:
        kw.update(k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                  v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device))
    if _staged(prec):
        kw.update(stage_k=torch.zeros(shape, dtype=cdtype(cfg), device=device),
                  stage_v=torch.zeros(shape, dtype=cdtype(cfg), device=device))
    return KVCache(
        k=torch.zeros(shape, dtype=store, device=device),
        v=torch.zeros(shape, dtype=store, device=device),
        slot_pos=torch.full((*lead, batch, cache_len), -1, dtype=torch.int32,
                            device=device),
        **kw)


# the unscaled storage casts the port serves (the kernels read each of them)
CAST_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
               "float32": torch.float32, "float8_e4m3fn": torch.float8_e4m3fn}
# XLA's cast to float8_e4m3fn rounds to nearest even and gives NaN past the
# largest finite value's rounding range: |x| > 464 (a tie at 464 rounds to
# 448), and inf. torch's cast saturates there to +-448.
_E4M3_NAN_ABOVE = 464.0


def cast_dtype_of(prec: KVPrecision) -> torch.dtype:
    """The torch dtype of an unscaled storage cast; ValueError for a dtype
    the port does not serve."""
    dt = CAST_DTYPES.get(prec.dtype)
    if dt is None:
        raise ValueError(f"unscaled KV storage cast {prec.dtype!r} is not served: the cast "
                         f"dtypes are {sorted(CAST_DTYPES)}")
    return dt


def storage_dtype(prec: KVPrecision, cfg: ModelConfig) -> torch.dtype:
    """What a ring or native page region holds: codes under a quantized
    precision, the cast dtype under a cast, else the compute dtype."""
    if prec.is_quantized:
        return qdtype_of(prec)
    if prec.is_cast:
        return cast_dtype_of(prec)
    return cdtype(cfg)


def cast_to_storage(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` cast to the storage ``dtype`` as the reference's
    ``x.astype(dtype)`` casts it: round to nearest even, and for
    float8_e4m3fn NaN of x's sign (byte 0x7F, 0xFF) where |x| > 464, x is
    inf or x is NaN, where torch's cast would saturate to +-448. Every
    site that writes a cast ring or page goes through it; a copy of
    stored values (a splice of a cast prefill, a fork) gives the same
    bytes back."""
    y = x.to(dtype)
    if dtype != torch.float8_e4m3fn:
        return y
    xf = x.float()
    over = (xf.abs() > _E4M3_NAN_ABOVE) | torch.isnan(xf)
    nan = torch.where(torch.signbit(xf), 0xFF, 0x7F).to(torch.uint8)
    return torch.where(over, nan, y.view(torch.uint8)).view(dtype)


def _code_precision(codes: torch.Tensor) -> KVPrecision:
    """The quantized spec of a ring or page region, from its code dtype."""
    return parse_kv_precision(str(codes.dtype).removeprefix("torch."))


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """fp8 codes or cast values as raw bytes, a view (any other tensor as
    it is): copies and selections of them go through it, since not every
    fp8 op is implemented on every device. The byte 0 is the code of 0.0."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _quant_write(targets: tuple, index: tuple, k: torch.Tensor, v: torch.Tensor,
                 keep: Optional[torch.Tensor] = None) -> None:
    """Quantize K and V rows (..., KVH, hd) per token and head, one
    quantization for both, and write codes and scales in place into
    ``targets`` = (k codes, v codes, k scales, v scales) at ``index``.
    ``keep`` (the rows' leading shape) zeroes codes and scales of the rows
    it is False for AFTER the quantize, so a kept row's codes never depend
    on the others."""
    codes, scale = quantize_kv(torch.stack((k, v)), _code_precision(targets[0]))
    codes = as_bytes(codes)
    if keep is not None:
        codes = torch.where(keep[..., None, None], codes, torch.zeros((), dtype=codes.dtype,
                                                                      device=codes.device))
        scale = torch.where(keep[..., None], scale, torch.zeros((), dtype=scale.dtype,
                                                                device=scale.device))
    qk, qv, ks, vs = targets
    as_bytes(qk)[index] = codes[0]
    as_bytes(qv)[index] = codes[1]
    ks[index] = scale[0]
    vs[index] = scale[1]


def _ring_codes(cache: KVCache) -> tuple:
    return cache.k, cache.v, cache.k_scale, cache.v_scale


def attn_prefill(p: Attention, x: torch.Tensor, cfg: ModelConfig, cache: KVCache,
                 *, window: Optional[int] = None,
                 seq_lens: Optional[torch.Tensor] = None,
                 prefix_len: int = 0) -> torch.Tensor:
    """Causal self-attention over the prompt; fills the empty ``cache``.

    Stores the last ``cache_len`` roped K/V into the ring so that slot index
    = absolute_pos % cache_len. ``seq_lens`` (B,) int32 makes the prefill
    length-aware (ragged): attention runs the ragged kernel, and cache slots
    at or beyond a row's real length stay empty (zero K/V, slot_pos -1) so
    padding never enters decode attention.

    ``prefix_len`` > 0 makes the first ``prefix_len`` positions (a VLM's
    image patches) visible to every query (the prefix-LM mask).

    A quantized ring stores each row quantized per token and head; pad rows
    are zeroed after the quantize (codes and scales), so a real row's codes
    never depend on the bucket. A cast ring stores each row cast
    (``cast_to_storage``). Staging buffers get the native rows. The
    attention itself attends the prompt's native K/V, as the reference's
    does.
    """
    B, S, _ = x.shape
    q, k, v = p.qkv(x, cfg)
    pos = torch.arange(S, device=x.device)[None, :]
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    o = ops.flash_attention(q, k, v, seq_lens, causal=True, window=window,
                            prefix_len=prefix_len)
    y = p.out(o)

    L = cache.cache_len
    n = min(S, L)
    tail = torch.arange(S - n, S, device=x.device)   # absolute positions kept
    slots = tail % L                                  # ring placement
    spw = tail.to(torch.int32)[None, :].expand(B, n)
    keep = None
    if seq_lens is not None:
        keep = tail[None, :] < seq_lens[:, None]
        spw = torch.where(keep, spw, -1).to(torch.int32)

    def kept(t):
        if keep is None:
            return t
        return torch.where(keep[..., None, None], t, torch.zeros((), dtype=t.dtype,
                                                                device=t.device))
    if cache.k_scale is not None:
        _quant_write(_ring_codes(cache), (slice(None), slots), k[:, S - n:], v[:, S - n:],
                     keep)
    else:   # a pad row casts to zeros: the cast of 0 is the byte 0
        as_bytes(cache.k)[:, slots] = as_bytes(cast_to_storage(kept(k[:, S - n:]), cache.k.dtype))
        as_bytes(cache.v)[:, slots] = as_bytes(cast_to_storage(kept(v[:, S - n:]), cache.v.dtype))
    if cache.stage_k is not None:
        cache.stage_k[:, slots] = kept(k[:, S - n:].to(cache.stage_k.dtype))
        cache.stage_v[:, slots] = kept(v[:, S - n:].to(cache.stage_v.dtype))
    cache.slot_pos[:, slots] = spw
    return y


def attn_decode(p: Attention, x: torch.Tensor, cache: KVCache, pos: torch.Tensor,
                cfg: ModelConfig, *, window: Optional[int] = None) -> torch.Tensor:
    """One decode step: rope at pos, write K/V into the ring in place, then
    attend over the valid slots. x (B, D); pos (B,) int32. A quantized
    ring takes the token quantized (codes and scales at ``pos % L``) and
    is read through the dequantizing decode (K2q on the card); a cast ring
    takes it cast and is read through K2q's unscaled route."""
    B = x.shape[0]
    q, k, v = p.qkv(x, cfg)
    q = apply_rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    k = apply_rope(k[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    slot = pos % cache.cache_len
    b_idx = torch.arange(B, device=x.device)
    if cache.k_scale is not None:
        _quant_write(_ring_codes(cache), (b_idx, slot), k, v)
    else:
        as_bytes(cache.k)[b_idx, slot] = as_bytes(cast_to_storage(k, cache.k.dtype))
        as_bytes(cache.v)[b_idx, slot] = as_bytes(cast_to_storage(v, cache.v.dtype))
    cache.slot_pos[b_idx, slot] = pos
    o = ops.decode_attention(q, cache.k, cache.v, cache.slot_pos, pos,
                             k_scale=cache.k_scale, v_scale=cache.v_scale, window=window)
    return p.out(o)


def attn_forward(p: Attention, x: torch.Tensor, cfg: ModelConfig, *,
                 window: Optional[int] = None) -> torch.Tensor:
    """An encoder's non-causal self-attention with no cache, x (B, S, D) ->
    (B, S, D), RoPE at 0..S-1: K1 with ``causal=False`` on the card."""
    S = x.shape[1]
    q, k, v = p.qkv(x, cfg)
    pos = torch.arange(S, device=x.device)[None, :]
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    o = ops.flash_attention(q, k, v, causal=False, window=window)
    return p.out(o)


def cross_attn_cache(p: Attention, enc_out: torch.Tensor, cache: KVCache) -> None:
    """Fill ``cache`` (one layer's view) with the cross-attention K/V of the
    encoder output (B, Se, D), as the reference's ``cross_attn_cache``: a
    fully valid fixed ring whose slot s holds position s, so decode reads
    it through K2 at pos Se - 1 (``cross_attn_decode``)."""
    cache.k.copy_(p._proj(p.wk, enc_out))
    cache.v.copy_(p._proj(p.wv, enc_out))
    cache.slot_pos.copy_(torch.arange(cache.cache_len, dtype=torch.int32,
                                      device=enc_out.device).expand_as(cache.slot_pos))


def cross_attn_cache_init(batch: int, enc_seq: int, cfg: ModelConfig, device,
                          layers: Optional[int] = None) -> KVCache:
    """An empty cross-attention cache in the compute dtype (the reference's
    {"k", "v"} is never quantized or cast), with a leading layer axis."""
    return kv_cache_init(batch, enc_seq, cfg.replace(kv_precision="", cache_dtype=""), device,
                         layers=layers)


def cross_attn_prefill(p: Attention, x: torch.Tensor, xcache: KVCache) -> torch.Tensor:
    """Cross-attention of the prompt x (B, S, D) over the filled cross cache
    (the reference's ``attn_forward`` with ``kv_x``: no RoPE, no mask): K1
    with ``causal=False`` on the card, Sq the prompt, Sk the encoder's."""
    q = p._proj(p.wq, x)
    o = ops.flash_attention(q, xcache.k, xcache.v, causal=False, window=None)
    return p.out(o)


def cross_attn_decode(p: Attention, x: torch.Tensor, xcache: KVCache,
                      cfg: ModelConfig) -> torch.Tensor:
    """One-token cross-attention x (B, D) over the fixed encoder K/V: K2
    over the fully valid cache (every slot_pos <= pos = Se - 1, no window)
    on the card, the plain softmax over all slots on the CPU."""
    q = p._proj(p.wq, x)
    pos = torch.full((x.shape[0],), xcache.cache_len - 1, dtype=torch.int32, device=x.device)
    o = ops.decode_attention(q, xcache.k, xcache.v, xcache.slot_pos, pos)
    return p.out(o)


class ChunkWrites(NamedTuple):
    """Where one chunk dispatch writes K/V: W = min(C, cache_len) targets
    per row at a fixed shape (B, W), the chunk column each takes, its ring
    slot and absolute position, and whether it is written. Computed on the
    device from pos0 and valid, and shared by all layers."""

    slots: torch.Tensor   # (B, W) int64 ring slots, (pos0 + c) % cache_len
    pos: torch.Tensor     # (B, W) int32 absolute positions pos0 + c
    keep: torch.Tensor    # (B, W) bool, w < valid
    cols: Optional[torch.Tensor] = None   # (B, W) int64 column c; None: c = w


def chunk_write_targets(pos0: torch.Tensor, valid: torch.Tensor, C: int,
                        cache_len: int) -> ChunkWrites:
    """The targets of a chunk of C columns: column c of row b lands at
    position pos0[b] + c and is valid for c < valid[b]. The reference
    scatters every pair and drops the invalid ones (``mode="drop"``);
    PyTorch has no dropping scatter, so each write gathers the old values
    at all targets, selects the new ones where valid and scatters the
    whole block back (``_masked_put``). Nothing is read back, so the write
    fits a CUDA graph.

    No scatter index may repeat (its order is not defined), so a row has
    one target per ring slot it can reach: W = min(C, cache_len) targets,
    whose slots are distinct modulo cache_len, and rows differ. For C <=
    cache_len target w takes column w. A chunk wider than the ring sends
    target w the last valid column c = w (mod cache_len), what writing the
    columns one by one would leave in that slot; columns at or past
    cache_len are valid only when valid > cache_len."""
    W = min(C, cache_len)
    w = torch.arange(W, device=pos0.device)[None, :]
    c = w
    if C > cache_len:
        c = w + cache_len * torch.div((valid[:, None] - 1 - w).clamp(min=0), cache_len,
                                      rounding_mode="floor")
    pos = pos0[:, None] + c
    return ChunkWrites((pos % cache_len).long(), pos.to(torch.int32), w < valid[:, None],
                       None if C <= cache_len else c.long())


def _columns(t: torch.Tensor, writes: ChunkWrites) -> torch.Tensor:
    """A chunk tensor t (B, C, ...) at the write targets' columns (B, W, ...)."""
    if writes.cols is None:
        return t
    return t[torch.arange(t.shape[0], device=t.device)[:, None], writes.cols]


def _masked_put(t: torch.Tensor, index: tuple, new: torch.Tensor,
                keep: torch.Tensor) -> None:
    """``t[index] = new`` where ``keep`` is True and the old value
    elsewhere, in place: a gather, a select and one scatter, each of a
    fixed shape. ``index`` must not repeat (the scatter's order is not
    defined), and ``keep`` has the leading shape of ``new``."""
    t, new = as_bytes(t), as_bytes(new)
    keep = keep.reshape(keep.shape + (1,) * (new.dim() - keep.dim()))
    t[index] = torch.where(keep, new.to(t.dtype), t[index])


def attn_chunk(p: Attention, x: torch.Tensor, cache: KVCache, pos0: torch.Tensor,
               valid: torch.Tensor, cfg: ModelConfig, writes: ChunkWrites, *,
               reset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Chunked-prefill attention: rope the chunk at pos0 + arange(C), write
    its valid K/V and slot_pos into the ring in place (``writes``, from
    ``chunk_write_targets``: a fixed-shape masked write), then
    attend the chunk's queries over the row's whole cache, earlier chunks
    and the chunk itself. x (B, C, D); pos0 and valid (B,) int32.

    ``reset`` (B,) bool marks rows whose cache still holds a previous
    tenant: their slot_pos is invalidated before the write (stale K/V need
    no zeroing, an invalid slot's weight is exactly 0). Query rows at or
    beyond ``valid`` come out as zeros; the caller never reads them.

    A quantized ring takes the chunk quantized, a cast ring cast, and with
    staging buffers the chunk's native rows land there too; the prompt
    phase then attends
    staging, not the rounded ring, with the reference's purely causal mask
    ``arange(L) <= qpos``: during the prompt every position up to a query's
    was written by the row's current tenant (chunks are contiguous from 0),
    so staging slot j holds position j. The staging buffers are not reset.
    """
    B, C, _ = x.shape
    q, k, v = p.qkv(x, cfg)
    pos = pos0[:, None] + torch.arange(C, device=x.device)[None, :]
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    if reset is not None:
        cache.slot_pos.masked_fill_(reset[:, None], -1)
    at = (torch.arange(B, device=x.device)[:, None], writes.slots)
    kc, vc = _columns(k, writes), _columns(v, writes)
    if cache.k_scale is not None:
        codes, scale = quantize_kv(torch.stack((kc, vc)), _code_precision(cache.k))
        for t, new in zip(_ring_codes(cache), (codes[0], codes[1], scale[0], scale[1])):
            _masked_put(t, at, new, writes.keep)
    else:
        _masked_put(cache.k, at, cast_to_storage(kc, cache.k.dtype), writes.keep)
        _masked_put(cache.v, at, cast_to_storage(vc, cache.v.dtype), writes.keep)
    _masked_put(cache.slot_pos, at, writes.pos, writes.keep)
    if cache.stage_k is None:
        o = ops.chunk_attention(q, cache.k, cache.v, cache.slot_pos, pos0, valid)
        return p.out(o)
    _masked_put(cache.stage_k, at, kc, writes.keep)
    _masked_put(cache.stage_v, at, vc, writes.keep)
    # K4 over staging with slot_pos = arange(L) on every row: its mask
    # 0 <= slot_pos <= qpos is then exactly the reference's arange(L) <= qpos
    # (no window on this branch), so no kernel of its own is needed
    L = cache.cache_len
    causal = torch.arange(L, dtype=torch.int32, device=x.device).repeat(B, 1)
    o = ops.chunk_attention(q, cache.stage_k, cache.stage_v, causal, pos0, valid)
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
    k/v at the compute dtype (or an unscaled cast's dtype, when the pool
    has no other region); ids [native_pages, num_pages) live in qk/qv
    as int8 or fp8 codes with k_scale/v_scale, one float32 scale per token
    and KV head. Either region may be empty (its leaves None); a pool with
    no quantized region is the native pool of two leaves.

    Each region holds one page more than its ids: a scratch page past its
    last id, which no block table lists. Every write the reference drops
    (``mode="drop"``: an inactive row, a position past the table, an
    unallocated page, a row bound for the other region) lands there
    instead, so each pool write has a fixed shape and reads nothing back to
    the host. No kernel reads the scratch page, since no table names it.

    ``stage_k``/``stage_v`` (rows, stage_len + 1, KVH, hd), at the compute
    dtype, are the native staging buffers of the chunked prompt phase over
    a lossy pool (None otherwise), with a scratch row past stage_len.
    """

    k: Optional[torch.Tensor]             # (native_pages + 1, ps, KVH, hd), RoPE applied
    v: Optional[torch.Tensor]
    qk: Optional[torch.Tensor] = None     # (quant_pages + 1, ps, KVH, hd) codes
    qv: Optional[torch.Tensor] = None
    k_scale: Optional[torch.Tensor] = None  # (quant_pages + 1, ps, KVH) float32
    v_scale: Optional[torch.Tensor] = None
    stage_k: Optional[torch.Tensor] = None  # (rows, stage_len + 1, KVH, hd)
    stage_v: Optional[torch.Tensor] = None

    @property
    def native_pages(self) -> int:
        return self.k.shape[-4] - 1 if self.k is not None else 0

    @property
    def quant_pages(self) -> int:
        return self.qk.shape[-4] - 1 if self.qk is not None else 0

    @property
    def num_pages(self) -> int:
        return self.native_pages + self.quant_pages

    @property
    def page_size(self) -> int:
        return (self.k if self.k is not None else self.qk).shape[-3]

    def layer(self, i: int) -> "PagedKVPool":
        return PagedKVPool(*(None if t is None else t[i] for t in self))

    def regions(self) -> tuple:
        """The two regions without their scratch pages, as views: native
        k, v, then the quantized codes qk, qv and scales k_scale, v_scale
        (None where a region is absent)."""
        def cut(t, n, trailing):
            return None if t is None else t.narrow(t.dim() - trailing, 0, n)
        nn, nq = self.native_pages, self.quant_pages
        return (cut(self.k, nn, 4), cut(self.v, nn, 4), cut(self.qk, nq, 4),
                cut(self.qv, nq, 4), cut(self.k_scale, nq, 3), cut(self.v_scale, nq, 3))


def paged_pool_init(num_pages: int, page_size: int, cfg: ModelConfig, device,
                    layers: Optional[int] = None, native_pages: Optional[int] = None,
                    stage_rows: int = 0, stage_len: int = 0) -> PagedKVPool:
    """Zeroed pool; ``layers`` adds a leading layer axis. Under a quantized
    ``cfg.kv_precision`` the top ``num_pages - native_pages`` ids form the
    quantized region (``native_pages`` None: every page quantized; at
    native precision or under a cast: none; a cast pool's pages hold the
    cast dtype). ``stage_rows`` > 0 under a lossy precision adds the
    staging buffers, ``stage_len`` positions per row."""
    prec = resolve_kv_precision(cfg.kv_precision, cfg.cache_dtype)
    if native_pages is None:
        native_pages = 0 if prec.is_quantized else num_pages
    nq = num_pages - native_pages
    if nq and not prec.is_quantized:
        raise ValueError("a quantized page region needs a quantized kv_precision")
    lead = (layers,) if layers is not None else ()
    KVH, hd = cfg.n_kv_heads, cfg.head_dim_
    kw = {}
    ndt = cdtype(cfg) if prec.is_quantized else storage_dtype(prec, cfg)
    if native_pages:
        shape = (*lead, native_pages + 1, page_size, KVH, hd)
        kw.update(k=torch.zeros(shape, dtype=ndt, device=device),
                  v=torch.zeros(shape, dtype=ndt, device=device))
    else:
        kw.update(k=None, v=None)
    if nq:
        shape = (*lead, nq + 1, page_size, KVH, hd)
        qdt = qdtype_of(prec)
        kw.update(qk=torch.zeros(shape, dtype=qdt, device=device),
                  qv=torch.zeros(shape, dtype=qdt, device=device),
                  k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                  v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device))
    if stage_rows and _staged(prec):
        shape = (*lead, stage_rows, stage_len + 1, KVH, hd)
        kw.update(stage_k=torch.zeros(shape, dtype=cdtype(cfg), device=device),
                  stage_v=torch.zeros(shape, dtype=cdtype(cfg), device=device))
    return PagedKVPool(**kw)


def _pool_codes(pool: PagedKVPool) -> tuple:
    return pool.qk, pool.qv, pool.k_scale, pool.v_scale


class PagedWrites(NamedTuple):
    """Where one step writes its K/V rows: per written position the page of
    each region (a region-local id, or that region's scratch page where the
    reference drops the write) and the row inside the page; for a chunk
    over a pool with staging buffers, the staging row too (its scratch row
    for pad columns). Every field has the shape of the positions, (B,) for
    a decode step and (B, C) for a chunk, and all layers share them."""

    pages: torch.Tensor                   # native region page, or native_pages
    qpages: torch.Tensor                  # quantized region page, or quant_pages
    offs: torch.Tensor                    # row inside the page
    stage: Optional[torch.Tensor] = None  # (B, C) staging row, or stage_len


def paged_write_targets(block_table: torch.Tensor, pos: torch.Tensor, native_pages: int,
                        quant_pages: int, page_size: int,
                        keep: Optional[torch.Tensor] = None) -> PagedWrites:
    """The write targets of positions ``pos`` (B,) or (B, C) through
    ``block_table`` (B, MP), by region.

    The reference scatters every position into each region and drops the
    ids outside it (``mode="drop"``). PyTorch has no dropping scatter, and
    clamping would overwrite a page another request owns, so a position
    that writes nowhere (``keep`` False, an inactive row's -1 page, a
    position past the table, an unallocated page) and a position bound for
    the other region write the region's scratch page. Computed on the
    device from the device's positions: nothing is read back, and a row
    whose position froze on the device (a finished row of the sync-free
    loop) writes where that position says.
    """
    MP = block_table.shape[1]
    lp = torch.div(pos, page_size, rounding_mode="floor")
    idx = lp.clamp(0, MP - 1).long()
    page = block_table.gather(1, idx if pos.dim() == 2 else idx[:, None])
    page = (page if pos.dim() == 2 else page[:, 0]).long()
    ok = (pos >= 0) & (lp < MP) & (page >= 0) & (page < native_pages + quant_pages)
    if keep is not None:
        ok = ok & keep
    return PagedWrites(torch.where(ok & (page < native_pages), page, native_pages),
                       torch.where(ok & (page >= native_pages), page - native_pages,
                                   quant_pages),
                       (pos % page_size).long())


def paged_chunk_targets(block_table: torch.Tensor, pos0: torch.Tensor, valid: torch.Tensor,
                        pool: PagedKVPool, C: int) -> PagedWrites:
    """``paged_write_targets`` of a chunk: column c of row b writes position
    pos0[b] + c when c < valid[b]. Over a pool with staging buffers the
    valid columns also name their staging row (the position) and the rest
    the scratch row."""
    cols = torch.arange(C, device=pos0.device)[None, :]
    pos = pos0[:, None] + cols
    keep = cols < valid[:, None]
    w = paged_write_targets(block_table, pos, pool.native_pages, pool.quant_pages,
                            pool.page_size, keep)
    if pool.stage_k is None:
        return w
    SL = pool.stage_k.shape[-3] - 1
    return w._replace(stage=torch.where(keep & (pos < SL), pos, SL).long())


def _paged_write(pool: PagedKVPool, writes: PagedWrites, k: torch.Tensor,
                 v: torch.Tensor) -> None:
    """Write K/V rows (..., KVH, hd), shaped like ``writes``' fields, into
    both regions in place: at the native region's dtype (cast there under
    a cast), quantized into the quantized one; each region's other rows
    land on its scratch page."""
    if pool.k is not None:
        as_bytes(pool.k)[writes.pages, writes.offs] = as_bytes(cast_to_storage(k, pool.k.dtype))
        as_bytes(pool.v)[writes.pages, writes.offs] = as_bytes(cast_to_storage(v, pool.v.dtype))
    if pool.qk is not None:
        _quant_write(_pool_codes(pool), (writes.qpages, writes.offs), k, v)


def attn_decode_paged(p: Attention, x: torch.Tensor, pool: PagedKVPool,
                      block_table: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig,
                      writes: Optional[PagedWrites] = None) -> torch.Tensor:
    """One decode step against the paged pool: rope at pos, write the new
    row into its block-table page in place (quantized there when the page
    lies in the quantized region), then attend over the row's pages. x
    (B, D); block_table (B, MP) int32 (-1 = unallocated); pos (B,) int32,
    the position of the new token. ``writes`` (from
    ``paged_write_targets``) lets the layers of one step share the targets.

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
        writes = paged_write_targets(block_table, pos, pool.native_pages, pool.quant_pages,
                                     pool.page_size)
    _paged_write(pool, writes, k, v)
    kn, vn, qk, qv, ks, vs = pool.regions()
    if qk is None:
        o = ops.paged_decode_attention(q, kn, vn, block_table, pos)
    else:
        o = ops.paged_decode_attention_quant(q, kn, vn, qk, qv, ks, vs, block_table, pos)
    return p.out(o)


def attn_chunk_paged(p: Attention, x: torch.Tensor, pool: PagedKVPool,
                     block_table: torch.Tensor, pos0: torch.Tensor, valid: torch.Tensor,
                     cfg: ModelConfig, writes: PagedWrites,
                     base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``attn_chunk`` over the shared page pool: rope the chunk at pos0 +
    arange(C), write its valid K/V rows into their block-table pages in
    place (``writes``, from ``paged_chunk_targets``), then attend the
    chunk's queries over the row's logical cache with the validity mask
    ``allocated & (j <= qpos)``. x (B, C, D); block_table (B, MP) int32;
    pos0 and valid (B,) int32. No slot_pos reset is needed: a previous
    tenant's rows survive only at logical slots this request has not yet
    written, all of them at j > qpos.

    Over a lossy pool (``pool.stage_k`` present) the chunk's rows also
    land in the native staging buffers, and the prompt phase reads pool
    pages only for the prefix-cache hit [0, ``base``) (positions an
    earlier tenant wrote, already rounded) and staging for [base, qpos]:
    chunk N re-reads chunk N-1 exactly. ``base`` (B,) int32, None: 0.
    Query rows at or beyond ``valid`` come out as zeros; the caller never
    reads them. The attention is ``ops.paged_chunk_attention``: K4p on the
    card, which reads both sources in place (dequantizing quantized pages
    as it loads, K4q's arithmetic) where the reference gathers the pool
    and concatenates staging.
    """
    B, C, _ = x.shape
    q, k, v = p.qkv(x, cfg)
    pos = pos0[:, None] + torch.arange(C, device=x.device)[None, :]
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    _paged_write(pool, writes, k, v)
    if pool.stage_k is not None:
        rows = torch.arange(B, device=x.device)[:, None]
        pool.stage_k[rows, writes.stage] = k.to(pool.stage_k.dtype)
        pool.stage_v[rows, writes.stage] = v.to(pool.stage_v.dtype)
        if base is None:
            base = torch.zeros_like(pos0)
    kn, vn, qk, qv, ks, vs = pool.regions()
    o = ops.paged_chunk_attention(q, kn, vn, qk, qv, ks, vs, block_table, pos0, valid,
                                  stage_k=pool.stage_k, stage_v=pool.stage_v, base=base)
    return p.out(o)


def paged_splice_prompt(pool: PagedKVPool, cache: KVCache, page_idx) -> None:
    """Copy a prefill-built dense cache into the page pool, in place, at a
    fixed shape.

    cache k/v: (..., B, P, KVH, hd) with the prompt in slots 0..P-1
    (prefill with cache_len == P never wraps), at the compute dtype or the
    pool's cast dtype; pool
    leaves (..., N, ps, KVH, hd) with the same leading (layer) axes.
    page_idx (B, P // ps), a tensor on the pool's device (a host array is
    copied there): the physical page of each prompt block; pad rows,
    blocks past a prompt's pages and blocks a shared prefix page already
    holds carry an id outside [0, N). The reference's scatter drops those
    entries; here every block is written, and each one the reference
    drops, or one bound for the other region, lands on its region's
    scratch page, so only the listed pages of ``regions()`` change and
    nothing is read back to the host (the admission's CUDA graph). Blocks
    bound for the quantized region are quantized there, each token and
    head on its own, so a listed block's codes do not depend on the rest.
    """
    B, P = cache.k.shape[-4], cache.k.shape[-3]
    dev = (pool.k if pool.k is not None else pool.qk).device
    idx = (page_idx if isinstance(page_idx, torch.Tensor)
           else host_to_device(np.asarray(page_idx), dev)).to(torch.int64).reshape(-1)
    npp = idx.shape[0] // B
    ps = P // npp
    nn, nq = pool.native_pages, pool.quant_pages
    # (..., B * npp, ps, KVH, hd): block j of row b at b * npp + j, as idx
    k_blocks = cache.k.unflatten(-3, (npp, ps)).flatten(-5, -4)
    v_blocks = cache.v.unflatten(-3, (npp, ps)).flatten(-5, -4)
    if pool.k is not None:   # a cast prefill's rows are already cast: the same bytes
        dst = torch.where((idx >= 0) & (idx < nn), idx, nn)
        as_bytes(pool.k)[..., dst, :, :, :] = as_bytes(cast_to_storage(k_blocks, pool.k.dtype))
        as_bytes(pool.v)[..., dst, :, :, :] = as_bytes(cast_to_storage(v_blocks, pool.v.dtype))
    if pool.qk is not None:
        dst = torch.where((idx >= nn) & (idx < nn + nq), idx - nn, nq)
        if pool.qk.dim() == 4:
            _quant_write(_pool_codes(pool), (dst,), k_blocks, v_blocks)
            return
        # a layer at a time: every block is quantized, pads too, so the
        # quantize's float32 temporaries of all layers at once would be
        # several times the prefill's own caches
        for i in range(pool.qk.shape[0]):
            _quant_write(tuple(t[i] for t in _pool_codes(pool)), (dst,), k_blocks[i],
                         v_blocks[i])


def fork_pages(pool: PagedKVPool, src: torch.Tensor, dst: torch.Tensor) -> None:
    """Copy whole pages src -> dst (copy-on-write forks) in place, in every
    layer of ``pool``. src, dst (F,) int64 physical ids on the pool's
    device; a pad entry's dst lies outside [0, num_pages) and its copy
    lands on the scratch page, so one fixed-shape copy per leaf forks any
    number of pages. Forks never cross regions (the allocator hands out a
    dst in the src's region), so each region copies on its own, quantized
    pages with their scales, byte for byte. The copy is whole-page: rows
    past the fork point are overwritten by the new holder's chunks, and
    rows past its position are masked."""
    nn, nq = pool.native_pages, pool.quant_pages
    for leaves, lo, n, trailing in (((pool.k, pool.v), 0, nn, (4, 4)),
                                    ((pool.qk, pool.qv, pool.k_scale, pool.v_scale), nn, nq,
                                     (4, 4, 3, 3))):
        if leaves[0] is None:
            continue
        d = torch.where((dst >= lo) & (dst < lo + n), dst - lo, n)
        s = (src - lo).clamp(0, n - 1)
        for t, tr in zip(leaves, trailing, strict=True):
            axis = t.dim() - tr
            t = as_bytes(t)   # fp8 copied as bytes: no fp8 index_copy_ on the CPU
            t.index_copy_(axis, d, t.index_select(axis, s))
