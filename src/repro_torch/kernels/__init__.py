"""The attention kernels and the SSD scan: hand-written CUDA for Hopper,
their plain versions, and the launch counts that show a run went through
the kernels."""
from repro_torch.kernels import (chunk_attention, decode_attention, flash_attention,
                                 paged_attention, paged_attention_quant, ssd_scan)

_COUNTERS = (flash_attention.launches, decode_attention.launches,
             paged_attention.launches, paged_attention_quant.launches,
             chunk_attention.launches, ssd_scan.launches)


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
