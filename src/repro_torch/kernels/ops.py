"""Kernel entry points (attention, the SSD scan) that choose by device.

A CPU tensor goes to the plain version (``repro_torch.kernels.ref``); a
CUDA tensor goes to the hand-written kernel, whose wrapper raises on
anything it does not take. There is no fallback from the card to the plain
version: a kernel that fails to build or launch fails the call.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import chunk_attention as _ca
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import paged_attention_quant as _paq
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels.ref import (attention_ref, chunk_attention_ref,
                                     decode_attention_ref, paged_decode_attention_mixed_ref,
                                     paged_decode_attention_quant_ref,
                                     paged_decode_attention_ref, ssd_chunked)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    seq_lens: Optional[torch.Tensor] = None, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Prefill attention; ``seq_lens`` selects the ragged (length-aware) path."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             seq_lens=seq_lens)
    return _fa.flash_attention(q, k, v, seq_lens, causal=causal, window=window)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     slot_pos: torch.Tensor, pos: torch.Tensor, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """One-token attention over the ring cache."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, slot_pos, pos, window=window)
    return _da.decode_attention(q, k, v, slot_pos, pos, window=window)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           pos: torch.Tensor) -> torch.Tensor:
    """One-token attention over the paged pool, through the block tables."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, block_tables, pos)
    return _pa.paged_decode_attention(q, k_pages, v_pages, block_tables, pos)


def paged_decode_attention_quant(q: torch.Tensor, k_pages: Optional[torch.Tensor],
                                 v_pages: Optional[torch.Tensor], qk_pages: torch.Tensor,
                                 qv_pages: torch.Tensor, k_scale: torch.Tensor,
                                 v_scale: torch.Tensor, block_tables: torch.Tensor,
                                 pos: torch.Tensor) -> torch.Tensor:
    """One-token attention over a pool with a quantized region: codes
    ``qk_pages``/``qv_pages`` with per-token-per-head ``k_scale``/
    ``v_scale``, beside native pages ``k_pages``/``v_pages`` (None when every
    page is quantized). Table ids below the native page count read the
    native region, the rest the quantized one at ``id - N_n``."""
    if q.device.type == "cpu":
        if k_pages is None:
            return paged_decode_attention_quant_ref(q, qk_pages, qv_pages, k_scale, v_scale,
                                                    block_tables, pos)
        return paged_decode_attention_mixed_ref(q, k_pages, v_pages, qk_pages, qv_pages,
                                                k_scale, v_scale, block_tables, pos)
    return _paq.paged_decode_attention_quant(q, k_pages, v_pages, qk_pages, qv_pages,
                                             k_scale, v_scale, block_tables, pos)


def chunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    slot_pos: torch.Tensor, pos0: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Chunked-prefill attention: each row's chunk queries (at positions
    pos0 ..) over the row's cache, which already holds the chunk."""
    if q.device.type == "cpu":
        return chunk_attention_ref(q, k, v, slot_pos, pos0, valid)
    return _ca.chunk_attention(q, k, v, slot_pos, pos0, valid)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, *, chunk: int,
        init_state: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-2 SSD chunked scan: y (B,S,H,P) in x's dtype and the final
    state (B,H,P,N) float32, from ``init_state`` (None: zeros)."""
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, Bm, Cm, chunk, init_state)
    return _ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, init_state=init_state)
