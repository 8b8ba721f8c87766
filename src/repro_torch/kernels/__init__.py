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


def graph_launch_counts(functions: dict) -> dict:
    """A CUDA graph's launches per counter, from its kernel nodes counted
    by kernel function name (``runtime/graph.py``): counter ``k`` counts the
    nodes of the function ``k_kernel``; nodes of other functions (matmuls,
    elementwise ops) count nowhere."""
    names = {f"{k}_kernel": k for c in _COUNTERS for k in c}
    return {names[f]: n for f, n in functions.items() if f in names}


def add_launch_counts(counts: dict) -> None:
    """Add ``counts`` (kernel name -> launches) to the counters: a CUDA
    graph's kernel nodes, once per replay (``runtime/graph.py``)."""
    for c in _COUNTERS:
        for name in c:
            c[name] += counts.get(name, 0)
