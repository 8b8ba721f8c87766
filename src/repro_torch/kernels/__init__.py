"""The attention kernels, the SSD scan and the RG-LRU scan: hand-written
CUDA for Hopper, their plain versions, and the launch counts that show a
run went through the kernels."""
from typing import Optional

from repro_torch.kernels import (chunk_attention, decode_attention, flash_attention,
                                 paged_attention, paged_attention_quant,
                                 paged_chunk_attention, rglru_scan, ssd_scan)

_COUNTERS = (flash_attention.launches, decode_attention.launches,
             paged_attention.launches, paged_attention_quant.launches,
             chunk_attention.launches, paged_chunk_attention.launches, ssd_scan.launches,
             rglru_scan.launches)


def launch_counts() -> dict:
    """Launches per kernel name since the last ``reset_launch_counts``."""
    out = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for name in c:
            c[name] = 0


# the kernel function a counter's wrapper launches, where it is not the
# counter's own name + "_kernel": K1's kernel serves K1, K1r, K1q and K1rq
# (its wide-head route, flash_attention_wide_kernel, K1 and K1r at hd 128
# and 256),
# K2q's and K3q's serve their unscaled routes, and K4p's serves K4q, K4p,
# K4p over quantized pages and K4p over cast pages. ``ssd_scan``
# counts K6's calls, which launch the kernels of the route they take, each
# counted by that kernel's own counter: it maps to no function.
_FUNCTION = {"flash_attention_ragged": "flash_attention_kernel",
             "flash_attention_wide_ragged": "flash_attention_wide_kernel",
             "flash_attention_quant": "flash_attention_kernel",
             "flash_attention_quant_ragged": "flash_attention_kernel",
             "chunk_attention_quant": "paged_chunk_attention_kernel",
             "paged_chunk_attention_quant": "paged_chunk_attention_kernel",
             "paged_chunk_attention_cast": "paged_chunk_attention_kernel",
             "decode_attention_cast": "decode_attention_quant_kernel",
             "paged_decode_attention_cast": "paged_decode_attention_quant_kernel",
             "ssd_scan": None, "ssd_scan_f32": "ssd_scan_kernel"}


def kernel_function(counter: str) -> Optional[str]:
    """The kernel function (unqualified, its Hopper variant's ``_wgmma``
    suffix dropped) that the wrapper of ``counter`` launches, or None for a
    counter of calls matched against no kernel."""
    return _FUNCTION.get(counter, f"{counter}_kernel")


def graph_launch_counts(functions: dict) -> dict:
    """A CUDA graph's kernel nodes per port kernel function, from its nodes
    counted by function name (``runtime/graph.py``): a Hopper variant
    (``_wgmma``) counts with its kernel; nodes of other functions (matmuls,
    elementwise ops) count nowhere."""
    ours = {kernel_function(k) for c in _COUNTERS for k in c} - {None}
    out: dict = {}
    for f, n in functions.items():
        f = f.removesuffix("_wgmma")
        if f in ours:
            out[f] = out.get(f, 0) + n
    return out


def function_counts(counts: dict) -> dict:
    """Launch counts per counter (kernel name -> launches) summed per
    kernel function, the keys of ``graph_launch_counts``."""
    out: dict = {}
    for k, n in counts.items():
        f = kernel_function(k)
        if n and f is not None:
            out[f] = out.get(f, 0) + n
    return out


def add_launch_counts(counts: dict) -> None:
    """Add ``counts`` (kernel name -> launches) to the counters: a CUDA
    graph's kernel nodes, once per replay (``runtime/graph.py``)."""
    for c in _COUNTERS:
        for name in c:
            c[name] += counts.get(name, 0)
