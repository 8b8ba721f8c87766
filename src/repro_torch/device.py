"""Where the port runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device with no card raises: the port
    never carries on on the CPU unless the CPU was asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def host_to_device(a, device: torch.device) -> torch.Tensor:
    """A copy of the host array ``a`` (numpy or CPU tensor) on ``device``.

    To a card it goes through pinned memory with ``non_blocking=True``: a
    copy from pageable memory would synchronize the stream, and PyTorch's
    caching host allocator keeps the pinned block until the copy has run.
    On the CPU it is an ordinary copy."""
    t = torch.as_tensor(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()
