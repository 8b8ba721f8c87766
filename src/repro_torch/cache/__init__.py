"""Paged KV-cache subsystem: block-table page allocation for serving.

``PageAllocator`` (host-side refcounted page ownership) pairs with the
device-side ``PagedKVPool`` (repro_torch.models.attention) and the paged
decode-attention kernel (repro_torch.kernels.paged_attention). The prefix
index comes with prefix sharing (ROADMAP.md queue 1 item 8).
"""
from repro_torch.cache.paged import AllocStats, PageAllocator, PageEntry, pages_for
from repro_torch.cache.precision import (KVPrecision, parse_kv_precision,
                                         resolve_kv_precision)

__all__ = ["AllocStats", "KVPrecision", "PageAllocator", "PageEntry", "pages_for",
           "parse_kv_precision", "resolve_kv_precision"]
