"""Modality frontends: seeded stand-ins, as the reference package's.

The audio and VLM architectures specify the transformer backbone only; the
mel-spectrogram and conv feature extractor (audio) and the SigLIP ViT and
projector (VLM) are not implemented. These draw embeddings of the shapes
those frontends would give, 0.02 times a standard normal: audio frames
(B, T, D) for an encoder-decoder's ``prefill(frames=)`` and image patches
(B, P, D) for a VLM's ``prefill(patches=)``. They draw from a
``torch.Generator(seed)``, not the reference's jax.random keys; the tests
carry the reference's arrays across as numpy instead.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import cdtype


def _normal(shape: tuple, cfg: ModelConfig, seed: int, device) -> torch.Tensor:
    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
    return (0.02 * x).to(cdtype(cfg))


def audio_frame_embeddings(batch: int, cfg: ModelConfig, n_frames: Optional[int] = None, *,
                           seed: int = 0, device=None) -> torch.Tensor:
    """Stand-in for the mel-spectrogram and conv encoder's output:
    (B, n_frames or cfg.enc_seq, D) in the compute dtype."""
    return _normal((batch, n_frames or cfg.enc_seq, cfg.d_model), cfg, seed, device)


def vision_patch_embeddings(batch: int, cfg: ModelConfig, *, seed: int = 0,
                            device=None) -> torch.Tensor:
    """Stand-in for SigLIP and the projector's output: (B,
    cfg.num_prefix_tokens, D) in the compute dtype."""
    return _normal((batch, cfg.num_prefix_tokens, cfg.d_model), cfg, seed, device)
