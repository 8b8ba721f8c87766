"""Paged KV-cache subsystem: block-table page allocation for serving.

``PageAllocator`` (host-side refcounted page ownership) pairs with the
device-side ``PagedKVPool`` (repro_torch.models.attention) and the paged
decode-attention kernel (repro_torch.kernels.paged_attention); ``PrefixIndex``
maps resident prompt prefixes onto shared pages (prefix sharing).
"""
from repro_torch.cache.paged import AllocStats, PageAllocator, PageEntry, pages_for
from repro_torch.cache.prefix import PrefixHit, PrefixIndex
from repro_torch.cache.precision import (KVPrecision, parse_kv_precision,
                                         resolve_kv_precision)

__all__ = ["AllocStats", "KVPrecision", "PageAllocator", "PageEntry", "PrefixHit",
           "PrefixIndex", "pages_for", "parse_kv_precision", "resolve_kv_precision"]
