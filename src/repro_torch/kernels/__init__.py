"""The attention kernels and the SSD scan: hand-written CUDA for Hopper,
their plain versions, and the launch counts that show a run went through
the kernels."""
from repro_torch.kernels import (chunk_attention, decode_attention, flash_attention,
                                 paged_attention, paged_attention_quant,
                                 paged_chunk_attention, ssd_scan)

_COUNTERS = (flash_attention.launches, decode_attention.launches,
             paged_attention.launches, paged_attention_quant.launches,
             chunk_attention.launches, paged_chunk_attention.launches, ssd_scan.launches)


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
# counter's own name + "_kernel": K1's kernel serves K1, K1r, K1q and K1rq,
# and K4p's serves K4q, K4p and K4p over quantized pages
_FUNCTION = {"flash_attention_ragged": "flash_attention_kernel",
             "flash_attention_quant": "flash_attention_kernel",
             "flash_attention_quant_ragged": "flash_attention_kernel",
             "chunk_attention_quant": "paged_chunk_attention_kernel",
             "paged_chunk_attention_quant": "paged_chunk_attention_kernel"}


def kernel_function(counter: str) -> str:
    """The kernel function (unqualified, its Hopper variant's ``_wgmma``
    suffix dropped) that the wrapper of ``counter`` launches."""
    return _FUNCTION.get(counter, f"{counter}_kernel")


def graph_launch_counts(functions: dict) -> dict:
    """A CUDA graph's kernel nodes per port kernel function, from its nodes
    counted by function name (``runtime/graph.py``): a Hopper variant
    (``_wgmma``) counts with its kernel; nodes of other functions (matmuls,
    elementwise ops) count nowhere."""
    ours = {kernel_function(k) for c in _COUNTERS for k in c}
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
        if n:
            out[kernel_function(k)] = out.get(kernel_function(k), 0) + n
    return out


def add_launch_counts(counts: dict) -> None:
    """Add ``counts`` (kernel name -> launches) to the counters: a CUDA
    graph's kernel nodes, once per replay (``runtime/graph.py``)."""
    for c in _COUNTERS:
        for name in c:
            c[name] += counts.get(name, 0)
