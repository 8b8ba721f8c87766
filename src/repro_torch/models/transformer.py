"""Stack builder: the model as a list of segments of blocks.

The segment plan is the reference package's (``plan_segments``). The port
runs the ``attn`` segment (self-attention + dense MLP), the ``attn_moe``
segment (self-attention + the MoE FFN of ``models/moe.py``), the ``ssm``
segment (a Mamba-2 block, no FFN) and the hybrid Griffin stack's ``group``
segment (the pattern's sub-blocks in order: RG-LRU blocks of
``models/rglru.py`` and local attention, each with its GeLU MLP), ``rec``
remainder segments, and the encoder-decoder's ``dec`` segment
(self-attention, cross-attention over the encoder output, MLP) over an
``encoder`` stack of non-causal ``attn`` layers, and keeps one block
module per layer, where the
reference stacks each segment's layers on a leading axis for
``lax.scan``. Decode caches, recurrent states and page pools keep that
leading layer axis, so a decode state compares leaf by leaf with the
reference's: a ``group`` segment's cache is the reference's dict, one
``RecState`` or ``KVCache`` per sub-block (``"b0"``, ``"b1"``, ...), its
attention ring ``min(cache_len, local_window)`` slots long, and a ``dec``
segment's the reference's ``{"self", "cross"}``: the self-attention ring
and the cross-attention K/V of the encoder output, held as a fully valid
ring (slot s at position s) that decode reads through K2. Any other
segment kind raises NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.cache.precision import resolve_kv_precision
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import cdtype, mlp, param, rmsnorm

_ZOO = "ROADMAP.md queue 1 item 11 (the model zoo beyond dense, MoE, SSM and hybrid)"
_R12 = ("ROADMAP.md R12: the reference's engine cannot serve the encoder-decoder (its "
        "prefill reads frames the engine never passes), so it runs at model level only; "
        "see ROADMAP.md queue 1 item 11")


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
    """The port's models run dense decoder-only attention stacks, MoE
    attention stacks (with a leading dense segment under
    ``first_k_dense``), pure Mamba-2 stacks, hybrid Griffin stacks
    (RG-LRU and local attention, GeLU MLPs), the VLM's attention stack
    (image patches prepended as a bidirectional prefix) and the
    encoder-decoder (a non-causal encoder over audio frames, a decoder of
    ``dec`` blocks). Their KV caches hold K/V at the compute dtype, as int8
    or fp8 codes with per-token-per-head scales, or under an unscaled
    storage cast (``attention.CAST_DTYPES``; another cast dtype raises
    ValueError)."""
    kinds = {s.kind for s in plan_segments(cfg)}
    dense = cfg.arch_type == "dense" and ragged_prefill_supported(cfg)
    moe = cfg.arch_type == "moe" and kinds <= {"attn", "attn_moe"}
    ssm = cfg.arch_type == "ssm" and plan_segments(cfg) == (Segment("ssm", cfg.n_layers),)
    hybrid = cfg.arch_type == "hybrid" and kinds <= {"group", "rec", "attn"}
    vlm = cfg.arch_type == "vlm" and kinds == {"attn"}
    audio = cfg.arch_type == "audio" and cfg.is_encdec and kinds == {"dec"}
    if not (dense or moe or ssm or hybrid or vlm or audio):
        raise NotImplementedError(
            f"{cfg.name}: arch_type {cfg.arch_type!r} with segments "
            f"{[s.kind for s in plan_segments(cfg)]} is not ported yet; see {_ZOO}")
    prec = resolve_kv_precision(cfg.kv_precision, cfg.cache_dtype)
    if prec.is_cast:
        A.cast_dtype_of(prec)
    if not cfg.tie_embeddings or cfg.attn_logit_softcap or cfg.act not in ("silu", "gelu"):
        raise NotImplementedError(
            f"{cfg.name}: untied embeddings, logit softcap and MLPs other than SiLU and "
            f"GeLU are not ported yet; see {_ZOO}")


def check_servable(cfg: ModelConfig) -> None:
    """The engines and the launcher serve every supported stack but the
    encoder-decoder, which the reference's engine cannot serve (R12):
    NotImplementedError naming R12 and queue 1 item 11."""
    if cfg.is_encdec:
        raise NotImplementedError(f"{cfg.name}: {_R12}")


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


class MoEBlock(nn.Module):
    """One ``attn_moe`` layer: ln1 -> attention -> residual -> ln2 -> MoE
    FFN -> residual."""
    kind = "attn_moe"

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        D = cfg.d_model
        self.ln1 = param((D,), torch.float32, device)
        self.attn = A.Attention(cfg, device)
        self.ln2 = param((D,), torch.float32, device)
        self.moe = MOE.MoE(cfg, device)


class SSMBlock(nn.Module):
    """One ``ssm`` layer: ln1 -> Mamba-2 block -> residual (no FFN)."""
    kind = "ssm"

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = param((cfg.d_model,), torch.float32, device)
        self.ssm = SSM.SSM(cfg, device)


class RecBlock(nn.Module):
    """One ``rec`` layer: ln1 -> RG-LRU block -> residual -> ln2 -> MLP ->
    residual."""
    kind = "rec"

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        D, Fd, dt = cfg.d_model, cfg.d_ff, cdtype(cfg)
        self.ln1 = param((D,), torch.float32, device)
        self.rec = RG.RGLRU(cfg, device)
        self.ln2 = param((D,), torch.float32, device)
        self.w_gate = param((D, Fd), dt, device)
        self.w_up = param((D, Fd), dt, device)
        self.w_down = param((Fd, D), dt, device)


class DecBlock(nn.Module):
    """One ``dec`` layer: ln1 -> causal self-attention -> residual -> lnx ->
    cross-attention over the encoder output -> residual -> ln2 -> MLP ->
    residual."""
    kind = "dec"

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        D, Fd, dt = cfg.d_model, cfg.d_ff, cdtype(cfg)
        self.ln1 = param((D,), torch.float32, device)
        self.attn = A.Attention(cfg, device)
        self.lnx = param((D,), torch.float32, device)
        self.xattn = A.Attention(cfg, device, cross=True)
        self.ln2 = param((D,), torch.float32, device)
        self.w_gate = param((D, Fd), dt, device)
        self.w_up = param((D, Fd), dt, device)
        self.w_down = param((Fd, D), dt, device)


class GroupBlock(nn.Module):
    """One ``group`` layer: the hybrid pattern's sub-blocks in order, named
    as the reference's leaves (``b0_rec``, ``b1_rec``, ``b2_attn`` for
    recurrentgemma's (rec, rec, attn)), each a ``RecBlock`` or an attention
    ``Block``."""
    kind = "group"

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.names = []
        for i, bk in enumerate(cfg.block_pattern):
            sub = "rec" if bk == "rec" else "attn"
            self.names.append(f"b{i}_{sub}")
            self.add_module(self.names[-1], (RecBlock if sub == "rec" else Block)(cfg, device))

    def subs(self) -> list:
        """(cache key ``b{i}``, sub-block) in the pattern's order."""
        return [(n.split("_")[0], getattr(self, n)) for n in self.names]


_BLOCKS = {"attn": Block, "attn_moe": MoEBlock, "ssm": SSMBlock, "rec": RecBlock,
           "group": GroupBlock, "dec": DecBlock}


def stack_init(cfg: ModelConfig, device, role: str = "decoder") -> nn.ModuleList:
    """Per-segment lists of per-layer blocks (parameters uninitialised) of
    the ``role`` stack (decoder | encoder)."""
    return nn.ModuleList(
        nn.ModuleList(_BLOCKS[seg.kind](cfg, device) for _ in range(seg.n))
        for seg in plan_segments(cfg, role))


def _ffn(p, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The residual FFN of an ``attn`` or ``rec`` block (the dense MLP) or
    an ``attn_moe`` block (MoE); serving discards the MoE's auxiliary
    terms, as the reference's does."""
    x = rmsnorm(p.ln2, h, cfg.norm_eps)
    if p.kind == "attn_moe":
        return h + MOE.moe_ffn(p.moe, x, cfg)[0]
    return h + mlp(p.w_gate, p.w_up, p.w_down, x, cfg.act)


def _window_for(cfg: ModelConfig, shape_window: Optional[int]) -> Optional[int]:
    """Attention's window: a hybrid stack's local window, else
    ``shape_window`` (the reference's ``_window_for``)."""
    return cfg.local_window if cfg.is_hybrid else shape_window


def _require_chunkable(seg: nn.ModuleList) -> None:
    """Chunk boundaries would change an MoE block's capacity assignment
    (a cumulative count over the whole token block), and recurrent blocks
    carry no ring, as the reference's ``chunk_hidden`` refuses."""
    if seg[0].kind != "attn":
        raise ValueError(f"chunked prefill is not supported for {seg[0].kind!r} blocks")


def _stack_states(states: list):
    """Per-layer recurrent states as one state with the layer axis first."""
    return type(states[0])(*(torch.stack(leaves) for leaves in zip(*states)))


def encode_hidden(stack: nn.ModuleList, h: torch.Tensor, cfg: ModelConfig, *,
                  shape_window: Optional[int] = None) -> torch.Tensor:
    """The encoder stack over h (B, T, D): ``attn`` layers whose
    self-attention is non-causal (K1 with ``causal=False`` on the card)."""
    window = _window_for(cfg, shape_window)
    for seg in stack:
        for p in seg:
            a = A.attn_forward(p.attn, rmsnorm(p.ln1, h, cfg.norm_eps), cfg, window=window)
            h = _ffn(p, h + a, cfg)
    return h


def prefill_hidden(stack: nn.ModuleList, h: torch.Tensor, cfg: ModelConfig, *,
                   cache_len: int, shape_window: Optional[int] = None,
                   seq_lens: Optional[torch.Tensor] = None,
                   prefix_len: int = 0,
                   enc_out: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, list]:
    """Full-prompt pass building the decode caches. Returns (h, caches),
    one layer-stacked KVCache (``attn``), SSMState (``ssm``), RecState
    (``rec``) or dict of them (``group``; ``dec``: the self ring and the
    cross-attention cache of ``enc_out``) per segment. A recurrent state
    integrates every position, pads included, so ``seq_lens`` on a
    recurrent segment raises ValueError. ``prefix_len`` > 0 gives the
    ``attn`` segments' attention the prefix-LM mask."""
    B = h.shape[0]
    window = _window_for(cfg, shape_window)
    caches = []
    for seg in stack:
        kind = seg[0].kind
        if kind in ("ssm", "rec", "group", "dec") and seq_lens is not None:
            raise ValueError(f"ragged prefill is not supported for {kind!r} blocks")
        if kind == "dec":
            cache = A.kv_cache_init(B, cache_len, cfg, h.device, layers=len(seg))
            cross = A.cross_attn_cache_init(B, enc_out.shape[1], cfg, h.device,
                                            layers=len(seg))
            for i, p in enumerate(seg):
                h = h + A.attn_prefill(p.attn, rmsnorm(p.ln1, h, cfg.norm_eps), cfg,
                                       cache.layer(i), window=window)
                A.cross_attn_cache(p.xattn, enc_out, cross.layer(i))
                x = A.cross_attn_prefill(p.xattn, rmsnorm(p.lnx, h, cfg.norm_eps),
                                         cross.layer(i))
                h = _ffn(p, h + x, cfg)
            caches.append({"self": cache, "cross": cross})
            continue
        if kind == "ssm":
            states = []
            for p in seg:
                y, st = SSM.ssm_forward_with_state(p.ssm, rmsnorm(p.ln1, h, cfg.norm_eps), cfg)
                h = h + y
                states.append(st)
            caches.append(_stack_states(states))
            continue
        if kind == "rec":
            states = []
            for p in seg:
                a, st = RG.rglru_forward_with_state(p.rec, rmsnorm(p.ln1, h, cfg.norm_eps), cfg)
                h = _ffn(p, h + a, cfg)
                states.append(st)
            caches.append(_stack_states(states))
            continue
        if kind == "group":
            ring = min(cache_len, cfg.local_window)
            subs = dict(seg[0].subs())
            rings = {key: A.kv_cache_init(B, ring, cfg, h.device, layers=len(seg))
                     for key, sub in subs.items() if sub.kind == "attn"}
            states = {key: [] for key, sub in subs.items() if sub.kind == "rec"}
            for i, p in enumerate(seg):
                for key, sub in p.subs():
                    x = rmsnorm(sub.ln1, h, cfg.norm_eps)
                    if sub.kind == "rec":
                        a, st = RG.rglru_forward_with_state(sub.rec, x, cfg)
                        states[key].append(st)
                    else:
                        a = A.attn_prefill(sub.attn, x, cfg, rings[key].layer(i),
                                           window=cfg.local_window)
                    h = _ffn(sub, h + a, cfg)
            caches.append({key: rings[key] if key in rings else _stack_states(states[key])
                           for key in subs})
            continue
        cache = A.kv_cache_init(B, cache_len, cfg, h.device, layers=len(seg))
        for i, p in enumerate(seg):
            a = A.attn_prefill(p.attn, rmsnorm(p.ln1, h, cfg.norm_eps), cfg,
                               cache.layer(i), window=window,
                               seq_lens=seq_lens, prefix_len=prefix_len)
            h = _ffn(p, h + a, cfg)
        caches.append(cache)
    return h, caches


def _decode_block(p, h: torch.Tensor, cache, pos: torch.Tensor, cfg: ModelConfig,
                  window: Optional[int]) -> torch.Tensor:
    """One layer's decode step over its cache or recurrent state (one
    layer's view), in place."""
    if p.kind == "ssm":
        return h + SSM.ssm_decode(p.ssm, rmsnorm(p.ln1, h, cfg.norm_eps), cache, cfg)
    if p.kind == "group":
        for key, sub in p.subs():
            h = _decode_block(sub, h, cache[key], pos, cfg, cfg.local_window)
        return h
    if p.kind == "dec":
        h = h + A.attn_decode(p.attn, rmsnorm(p.ln1, h, cfg.norm_eps), cache["self"], pos, cfg,
                              window=window)
        x = A.cross_attn_decode(p.xattn, rmsnorm(p.lnx, h, cfg.norm_eps), cache["cross"], cfg)
        return _ffn(p, h + x, cfg)
    x = rmsnorm(p.ln1, h, cfg.norm_eps)
    if p.kind == "rec":
        a = RG.rglru_decode(p.rec, x, cache, cfg)
    else:
        a = A.attn_decode(p.attn, x, cache, pos, cfg, window=window)
    return _ffn(p, h + a, cfg)


def _layer_cache(cache, i: int):
    """Layer i's view of a segment's cache (a KVCache, a recurrent state or
    a group's dict of them)."""
    if isinstance(cache, dict):
        return {key: c.layer(i) for key, c in cache.items()}
    return cache.layer(i)


def decode_hidden(stack: nn.ModuleList, h: torch.Tensor, caches: list,
                  pos: torch.Tensor, cfg: ModelConfig, *,
                  shape_window: Optional[int] = None) -> torch.Tensor:
    """One-token pass. h: (B, D). Writes each layer's cache or recurrent
    state in place."""
    window = _window_for(cfg, shape_window)
    for seg, cache in zip(stack, caches, strict=True):
        for i, p in enumerate(seg):
            h = _decode_block(p, h, _layer_cache(cache, i), pos, cfg, window)
    return h


def chunk_hidden(stack: nn.ModuleList, h: torch.Tensor, caches: list,
                 pos0: torch.Tensor, valid: torch.Tensor, reset: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """One prompt-chunk pass over h (B, C, D) with ``prefill_hidden``'s
    per-layer order (attention -> residual -> MLP); ``attn_chunk`` writes
    each layer's cache in place at the per-row offsets, every layer at the
    same fixed-shape targets."""
    for seg in stack:
        _require_chunkable(seg)
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
        _require_chunkable(seg)
        for i, p in enumerate(seg):
            a = A.attn_chunk_paged(p.attn, rmsnorm(p.ln1, h, cfg.norm_eps), pool.layer(i),
                                   block_table, pos0, valid, cfg, writes, base)
            h = _ffn(p, h + a, cfg)
    return h
