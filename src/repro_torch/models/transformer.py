"""Stack builder: the model as a list of segments of blocks.

The segment plan is the reference package's (``plan_segments``). The port
runs the ``attn`` segment (self-attention + dense MLP) and the ``ssm``
segment (a Mamba-2 block, no FFN), and keeps one block module per layer,
where the reference stacks each segment's layers on a leading axis for
``lax.scan``. Decode caches, recurrent states and page pools keep that
leading layer axis, so a decode state compares leaf by leaf with the
reference's. Any other segment kind raises NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.cache.precision import resolve_kv_precision
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import cdtype, mlp, param, rmsnorm

_ZOO = "ROADMAP.md queue 1 item 11 (the model zoo beyond dense)"


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str
    n: int


def plan_segments(cfg: ModelConfig, role: str = "decoder") -> tuple[Segment, ...]:
    """Derive the segment plan for a config. role: decoder | encoder."""
    if role == "encoder":
        return (Segment("attn", cfg.n_enc_layers),)
    if cfg.is_encdec:
        return (Segment("dec", cfg.n_layers),)
    if cfg.is_hybrid:
        plen = len(cfg.block_pattern)
        n_groups, rem = divmod(cfg.n_layers, plen)
        segs = []
        if n_groups:
            segs.append(Segment("group", n_groups))
        for i in range(rem):  # trailing partial pattern, one segment per layer
            kind = cfg.block_pattern[i]
            segs.append(Segment("rec" if kind == "rec" else "attn", 1))
        return tuple(segs)
    if cfg.is_ssm:
        return (Segment("ssm", cfg.n_layers),)
    if cfg.is_moe:
        segs = []
        if cfg.first_k_dense:
            segs.append(Segment("attn", cfg.first_k_dense))
        segs.append(Segment("attn_moe", cfg.n_layers - cfg.first_k_dense))
        return tuple(segs)
    return (Segment("attn", cfg.n_layers),)


def ragged_prefill_supported(cfg: ModelConfig) -> bool:
    """Ragged (length-aware) prefill covers pure dense-attention stacks:
    they are per-position outside the causally masked attention, so pads at
    the end of a prompt never reach a real row."""
    if cfg.is_encdec or cfg.arch_type in ("vlm", "audio"):
        return False
    return all(s.kind == "attn" for s in plan_segments(cfg, "decoder"))


def chunked_prefill_supported(cfg: ModelConfig) -> bool:
    """Chunked (continuous-batching) prefill covers the ragged-prefill
    archs: per-position outside attention, so chunk boundaries cannot
    change a row's arithmetic."""
    return ragged_prefill_supported(cfg)


def check_supported(cfg: ModelConfig) -> None:
    """The port's models run dense decoder-only attention stacks, whose own
    caches hold K/V at the compute dtype or as int8 or fp8 codes with
    per-token-per-head scales (``kv_precision``), and pure Mamba-2 stacks."""
    dense = cfg.arch_type == "dense" and ragged_prefill_supported(cfg)
    ssm = cfg.arch_type == "ssm" and plan_segments(cfg) == (Segment("ssm", cfg.n_layers),)
    if not (dense or ssm):
        raise NotImplementedError(
            f"{cfg.name}: arch_type {cfg.arch_type!r} with segments "
            f"{[s.kind for s in plan_segments(cfg)]} is not ported yet; see {_ZOO}")
    if resolve_kv_precision(cfg.kv_precision, cfg.cache_dtype).is_cast:
        raise NotImplementedError(
            f"{cfg.name}: the unscaled KV storage cast "
            f"{cfg.kv_precision or cfg.cache_dtype!r} is not ported yet (int8 and fp8 "
            "are); see ROADMAP.md queue 1 item 9 (the legacy unscaled casts)")
    if not cfg.tie_embeddings or cfg.attn_logit_softcap or cfg.act != "silu":
        raise NotImplementedError(
            f"{cfg.name}: untied embeddings, logit softcap and non-SiLU MLPs are "
            f"not ported yet; see {_ZOO}")


class Block(nn.Module):
    """One ``attn`` layer: ln1 -> attention -> residual -> ln2 -> MLP -> residual."""
    kind = "attn"

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        D, Fd, dt = cfg.d_model, cfg.d_ff, cdtype(cfg)
        self.ln1 = param((D,), torch.float32, device)
        self.attn = A.Attention(cfg, device)
        self.ln2 = param((D,), torch.float32, device)
        self.w_gate = param((D, Fd), dt, device)
        self.w_up = param((D, Fd), dt, device)
        self.w_down = param((Fd, D), dt, device)


class SSMBlock(nn.Module):
    """One ``ssm`` layer: ln1 -> Mamba-2 block -> residual (no FFN)."""
    kind = "ssm"

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = param((cfg.d_model,), torch.float32, device)
        self.ssm = SSM.SSM(cfg, device)


_BLOCKS = {"attn": Block, "ssm": SSMBlock}


def stack_init(cfg: ModelConfig, device) -> nn.ModuleList:
    """Per-segment lists of per-layer blocks (parameters uninitialised)."""
    return nn.ModuleList(
        nn.ModuleList(_BLOCKS[seg.kind](cfg, device) for _ in range(seg.n))
        for seg in plan_segments(cfg, "decoder"))


def _ffn(p: Block, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return h + mlp(p.w_gate, p.w_up, p.w_down, rmsnorm(p.ln2, h, cfg.norm_eps))


def prefill_hidden(stack: nn.ModuleList, h: torch.Tensor, cfg: ModelConfig, *,
                   cache_len: int, shape_window: Optional[int] = None,
                   seq_lens: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, list]:
    """Full-prompt pass building the decode caches. Returns (h, caches),
    one layer-stacked KVCache (``attn``) or SSMState (``ssm``) per segment.
    A recurrent state integrates every position, pads included, so
    ``seq_lens`` on an ``ssm`` segment raises ValueError."""
    B = h.shape[0]
    caches = []
    for seg in stack:
        if seg[0].kind == "ssm":
            if seq_lens is not None:
                raise ValueError("ragged prefill is not supported for 'ssm' blocks")
            states = []
            for p in seg:
                y, st = SSM.ssm_forward_with_state(p.ssm, rmsnorm(p.ln1, h, cfg.norm_eps), cfg)
                h = h + y
                states.append(st)
            caches.append(SSM.SSMState(conv=torch.stack([s.conv for s in states]),
                                       ssd=torch.stack([s.ssd for s in states])))
            continue
        cache = A.kv_cache_init(B, cache_len, cfg, h.device, layers=len(seg))
        for i, p in enumerate(seg):
            a = A.attn_prefill(p.attn, rmsnorm(p.ln1, h, cfg.norm_eps), cfg,
                               cache.layer(i), window=shape_window,
                               seq_lens=seq_lens)
            h = _ffn(p, h + a, cfg)
        caches.append(cache)
    return h, caches


def decode_hidden(stack: nn.ModuleList, h: torch.Tensor, caches: list,
                  pos: torch.Tensor, cfg: ModelConfig, *,
                  shape_window: Optional[int] = None) -> torch.Tensor:
    """One-token pass. h: (B, D). Writes each layer's cache or recurrent
    state in place."""
    for seg, cache in zip(stack, caches, strict=True):
        for i, p in enumerate(seg):
            if p.kind == "ssm":
                h = h + SSM.ssm_decode(p.ssm, rmsnorm(p.ln1, h, cfg.norm_eps),
                                       cache.layer(i), cfg)
                continue
            a = A.attn_decode(p.attn, rmsnorm(p.ln1, h, cfg.norm_eps),
                              cache.layer(i), pos, cfg, window=shape_window)
            h = _ffn(p, h + a, cfg)
    return h


def chunk_hidden(stack: nn.ModuleList, h: torch.Tensor, caches: list,
                 pos0: torch.Tensor, valid: torch.Tensor, reset: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """One prompt-chunk pass over h (B, C, D) with ``prefill_hidden``'s
    per-layer order (attention -> residual -> MLP); ``attn_chunk`` writes
    each layer's cache in place at the per-row offsets, every layer at the
    same fixed-shape targets."""
    writes = A.chunk_write_targets(pos0, valid, h.shape[1], caches[0].cache_len)
    for seg, cache in zip(stack, caches, strict=True):
        for i, p in enumerate(seg):
            a = A.attn_chunk(p.attn, rmsnorm(p.ln1, h, cfg.norm_eps), cache.layer(i),
                             pos0, valid, cfg, writes, reset=reset)
            h = _ffn(p, h + a, cfg)
    return h


def paged_segments_supported(cfg: ModelConfig) -> bool:
    """Paged decode covers pure-attention stacks (dense and MoE FFN blocks):
    recurrent segments carry state, not a KV cache, and enc-dec carries
    cross-attention state; those archs stay on the dense engine."""
    if cfg.is_encdec or cfg.arch_type in ("vlm", "audio"):
        return False
    return all(s.kind in ("attn", "attn_moe") for s in plan_segments(cfg, "decoder"))


def paged_pools_init(cfg: ModelConfig, num_pages: int, page_size: int, device,
                     native_pages: Optional[int] = None, stage_rows: int = 0,
                     stage_len: int = 0) -> list:
    """Per-segment page pools with leaves stacked on the layer axis: k/v
    (n, native_pages + 1, page_size, KVH, hd) and, under a quantized
    ``cfg.kv_precision``, codes and scales for the other
    ``num_pages - native_pages`` ids (``native_pages`` None: all of them),
    each region with its scratch page; under a lossy precision
    ``stage_rows`` > 0 adds the staging buffers (n, stage_rows,
    stage_len + 1, KVH, hd). All layers share page indexing (one block
    table per request serves the whole stack)."""
    if not paged_segments_supported(cfg):
        raise ValueError(
            f"paged decode requires an all-attention stack; {cfg.name} has "
            f"segments {[s.kind for s in plan_segments(cfg, 'decoder')]}")
    return [A.paged_pool_init(num_pages, page_size, cfg, device, layers=seg.n,
                              native_pages=native_pages, stage_rows=stage_rows,
                              stage_len=stage_len)
            for seg in plan_segments(cfg, "decoder")]


def decode_hidden_paged(stack: nn.ModuleList, h: torch.Tensor, pools: list,
                        block_table: torch.Tensor, pos: torch.Tensor,
                        cfg: ModelConfig) -> torch.Tensor:
    """One-token pass over the paged pools. h: (B, D). Mirrors
    ``decode_hidden`` with ``attn_decode_paged`` in place of
    ``attn_decode``; the block table is shared by every layer, so the write
    targets are computed once for the step, on the device."""
    pool0 = pools[0]
    writes = A.paged_write_targets(block_table, pos, pool0.native_pages, pool0.quant_pages,
                                   pool0.page_size)
    for seg, pool in zip(stack, pools, strict=True):
        for i, p in enumerate(seg):
            a = A.attn_decode_paged(p.attn, rmsnorm(p.ln1, h, cfg.norm_eps),
                                    pool.layer(i), block_table, pos, cfg, writes)
            h = _ffn(p, h + a, cfg)
    return h


def chunk_hidden_paged(stack: nn.ModuleList, h: torch.Tensor, pools: list,
                       block_table: torch.Tensor, pos0: torch.Tensor, valid: torch.Tensor,
                       cfg: ModelConfig, base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One prompt-chunk pass over the paged pools, h (B, C, D): ``chunk_hidden``
    with ``attn_chunk_paged`` (one block table for the whole stack, so the
    write targets are computed once). ``base`` (B,) is each row's
    prefix-cache hit length: over a lossy pool it splits attention between
    pool pages [0, base) and the staging buffers."""
    writes = A.paged_chunk_targets(block_table, pos0, valid, pools[0], h.shape[1])
    for seg, pool in zip(stack, pools, strict=True):
        for i, p in enumerate(seg):
            a = A.attn_chunk_paged(p.attn, rmsnorm(p.ln1, h, cfg.norm_eps), pool.layer(i),
                                   block_table, pos0, valid, cfg, writes, base)
            h = _ffn(p, h + a, cfg)
    return h
