"""Attention entry points that choose by device.

A CPU tensor goes to the plain version (``repro_torch.kernels.ref``); a
CUDA tensor goes to the hand-written kernel, whose wrapper raises on
anything it does not take. There is no fallback from the card to the plain
version: a kernel that fails to build or launch fails the call.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels.ref import (attention_ref, decode_attention_ref,
                                     paged_decode_attention_ref)


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
