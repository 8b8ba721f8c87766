"""Top-level model API used by the serving engine.

  init_params(cfg, seed, device)                  -> Model (seeded weights)
  prefill(model, tokens, cache_len, ..., patches=, frames=)
                                                  -> (last_logits, DecodeState)
  encode(model, frames)                           -> encoder output (B, T, D)
  decode_step(model, state, tokens, ...)          -> (logits, DecodeState)
  decode_step_paged(model, state, tokens)         -> (logits, PagedDecodeState)
  chunk_step(model, state, tokens, pos0, valid, reset)
                                                  -> (logits, DecodeState)
  chunk_step_paged(model, state, tokens, pos0, valid, base)
                                                  -> (logits, PagedDecodeState)
  paged_splice_prompt(pools, caches, page_idx)    -> pools (prefill -> pages)
  fork_pages(pools, src, dst)                     -> pools (copy-on-write forks)

``Model`` keeps the reference package's parameter layouts (see
``models/convert.py`` for the mapping). A VLM's ``prefill`` takes image
patches (B, P, D) prepended to the text as a bidirectional prefix
(``prefix_len`` P); the encoder-decoder's takes audio frames (B, T, D),
which the encoder stack turns into the decoder's cross-attention input
(``models/frontends.py`` draws seeded stand-ins for both).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.models.layers import cdtype, embed, param, rmsnorm, unembed
from repro_torch.models.rglru import RGLRU, RGLRU_CONSTANTS, rglru_constants
from repro_torch.models.ssm import SSM, SSM_CONSTANTS, ssm_constants


class DecodeState(NamedTuple):
    caches: list             # per-segment KVCache, SSMState, RecState or a group's dict of
                             # them, leaves (n_layers, B, ...)
    pos: torch.Tensor        # (B,) int32 next absolute position to write
    last_tok: torch.Tensor   # (B,) int32 last emitted/fed token


class PagedDecodeState(NamedTuple):
    """Decode state over the shared page pool. ``block_tables`` maps each
    row's logical pages to physical ones (shared by all layers; -1 =
    unallocated, inactive rows are all -1). Page ownership lives on the
    host in ``repro_torch.cache.PageAllocator``; this carries what a decode
    step needs."""

    pools: list                 # per-segment PagedKVPool, leaves (n_layers, N, ...)
    block_tables: torch.Tensor  # (B, MP) int32
    pos: torch.Tensor           # (B,) int32 next absolute position to write
    last_tok: torch.Tensor      # (B,) int32


class Encoder(nn.Module):
    """The encoder-decoder's encoder: ``stack`` (non-causal ``attn``
    layers) and its final norm ``ln_f`` (D,) float32, the reference's
    ``params["encoder"]``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.stack = T.stack_init(cfg, device, "encoder")
        self.ln_f = param((cfg.d_model,), torch.float32, device)


class Model(nn.Module):
    """Decoder: tied embedding ``tok`` (V, D), per-layer blocks (attention,
    Mamba-2, RG-LRU, a hybrid group or an encoder-decoder ``dec`` block),
    final norm ``ln_f`` (D,) float32, and for an encoder-decoder its
    ``encoder``. Parameters are allocated uninitialised; use
    ``init_params`` or ``convert.params_from_numpy`` to fill them."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        T.check_supported(cfg)
        self.cfg = cfg
        self.tok = param((cfg.vocab_size, cfg.d_model), cdtype(cfg), device)
        self.stack = T.stack_init(cfg, device)
        self.ln_f = param((cfg.d_model,), torch.float32, device)
        self.encoder = Encoder(cfg, device) if cfg.is_encdec else None

    @property
    def device(self) -> torch.device:
        return self.tok.device


_NORMS = ("ln1", "ln2", "lnx", "ln_f", "q_norm", "k_norm")


@torch.no_grad()
def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Model:
    """A model with weights drawn from ``torch.Generator(seed)`` on its
    device, scaled as the reference initialises them: N(0, 1/d_in) for the
    projections, the MoE router and each expert's matrices (drawn in
    float32 one leaf at a time, cast to the leaf's dtype), N(0, 0.02^2)
    for the embedding, N(0, 0.1^2) for a Mamba-2 or RG-LRU conv weight,
    N(0, 1/bs) for the RG-LRU's block-diagonal gates (nb, bs, bs), ones for
    the norms, and the reference's constants for the other Mamba-2 and
    RG-LRU leaves (``ssm.ssm_constants``, ``rglru.rglru_constants``). The
    draws differ from the reference's jax.random ones; the tests carry
    weights across with ``convert.params_from_numpy`` instead."""
    model = Model(cfg, device)
    g = torch.Generator(device=model.device).manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in SSM_CONSTANTS or leaf in RGLRU_CONSTANTS:
            continue
        if leaf in _NORMS:
            p.fill_(1.0)
            continue
        if leaf == "tok":
            scale = 0.02
        elif leaf == "wo":
            scale = (p.shape[0] * p.shape[1]) ** -0.5
        elif leaf == "conv_w":
            scale = 0.1
        elif p.dim() == 3 and (".moe.w_" in name or leaf in ("w_a", "w_x")):
            # an expert stack (E, d_in, d_out) or RG-LRU gate blocks (nb, bs, bs)
            scale = p.shape[1] ** -0.5
        else:
            scale = p.shape[0] ** -0.5
        w = torch.randn(p.shape, generator=g, device=p.device, dtype=torch.float32)
        p.copy_((w * scale).to(p.dtype))
    for mod in model.modules():
        if isinstance(mod, SSM):
            ssm_constants(mod, cfg)
        elif isinstance(mod, RGLRU):
            rglru_constants(mod, cfg)
    return model


def _embed(model: Model, tokens: torch.Tensor) -> torch.Tensor:
    h = embed(model.tok, tokens)
    if model.cfg.arch_type not in ("dense", "vlm", "audio"):
        return h
    # dense-family scaling; the factor is rounded to h's dtype first, as the
    # reference's h * asarray(sqrt(d_model), h.dtype)
    # (``full`` copies nothing from the host, so it does not block the stream)
    return h * torch.full((), model.cfg.d_model ** 0.5, dtype=h.dtype, device=h.device)


@torch.no_grad()
def encode(model: Model, frames: torch.Tensor) -> torch.Tensor:
    """The encoder over audio frames (B, T, D) (cast to the compute
    dtype): its non-causal stack and final norm, the reference's
    ``_encode``."""
    cfg = model.cfg
    h = T.encode_hidden(model.encoder.stack, frames.to(model.tok.dtype), cfg)
    return rmsnorm(model.encoder.ln_f, h, cfg.norm_eps)


def _embed_inputs(model: Model, tokens: torch.Tensor, patches: Optional[torch.Tensor],
                  frames: Optional[torch.Tensor]) -> tuple:
    """Token embedding with a VLM's patches prepended (after the gemma
    scale) and an encoder-decoder's frames encoded, the reference's
    ``_embed_inputs``: (h, prefix_len, enc_out)."""
    cfg = model.cfg
    h = _embed(model, tokens)
    prefix_len, enc_out = 0, None
    if cfg.arch_type == "vlm" and patches is not None:
        h = torch.cat([patches.to(h.dtype), h], dim=1)
        prefix_len = patches.shape[1]
    if cfg.is_encdec:
        if frames is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder prefill needs frames (B, T, D)")
        enc_out = encode(model, frames)
    return h, prefix_len, enc_out


@torch.no_grad()
def prefill(model: Model, tokens: torch.Tensor, cache_len: int, *,
            shape_window: Optional[int] = None,
            prompt_lens: Optional[torch.Tensor] = None,
            kv_precision: Optional[str] = None,
            patches: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, DecodeState]:
    """Process the prompt (B, S) int; build decode caches; return
    last-position logits (B, V).

    prompt_lens (B,) int32: real prompt lengths — the ragged length-aware
    path. Logits are taken at each row's real last token, decode resumes at
    ``pos = len``, and cache slots beyond ``len`` stay empty.

    patches (B, P, D), a VLM's: prepended to the text and attended as a
    bidirectional prefix (the prefix-LM mask); decode resumes at
    ``pos = S + P``. frames (B, T, D), an encoder-decoder's (required
    there): encoded, then attended by every decoder layer's
    cross-attention. Neither goes with ``prompt_lens``.

    kv_precision ("native", "int8", "fp8"; None: the model config's) sets
    the storage of the caches built: a quantized ring stores codes and
    scales, which ``decode_step`` and ``chunk_step`` read and write as the
    cache's own leaves say.
    """
    cfg = model.cfg
    if kv_precision is not None:
        cfg = cfg.replace(kv_precision=kv_precision)
        T.check_supported(cfg)
    B, S = tokens.shape
    h, prefix_len, enc_out = _embed_inputs(model, tokens, patches, frames)
    if prompt_lens is not None:
        if prefix_len or enc_out is not None:
            raise ValueError("ragged prefill takes no patches or frames (decoder-only)")
        prompt_lens = prompt_lens.to(device=tokens.device, dtype=torch.int32)
        h, caches = T.prefill_hidden(model.stack, h, cfg, cache_len=cache_len,
                                     shape_window=shape_window,
                                     seq_lens=prompt_lens)
        last = torch.clamp(prompt_lens - 1, 0, S - 1).long()
        rows = torch.arange(B, device=tokens.device)
        hl = rmsnorm(model.ln_f, h[rows, last], cfg.norm_eps)
        state = DecodeState(caches=caches, pos=prompt_lens.clone(),
                            last_tok=tokens[rows, last].to(torch.int32))
        return unembed(model.tok, hl), state
    h, caches = T.prefill_hidden(model.stack, h, cfg, cache_len=cache_len,
                                 shape_window=shape_window, prefix_len=prefix_len,
                                 enc_out=enc_out)
    hl = rmsnorm(model.ln_f, h[:, -1], cfg.norm_eps)
    state = DecodeState(
        caches=caches,
        pos=torch.full((B,), S + prefix_len, dtype=torch.int32, device=tokens.device),
        last_tok=tokens[:, -1].to(torch.int32))
    return unembed(model.tok, hl), state


@torch.no_grad()
def decode_step(model: Model, state: DecodeState, tokens: torch.Tensor, *,
                shape_window: Optional[int] = None) -> tuple[torch.Tensor, DecodeState]:
    """One decode step for the whole batch. tokens: (B,) int32. The caches
    are written in place: the returned state shares them with ``state``."""
    cfg = model.cfg
    h = _embed(model, tokens)
    h = T.decode_hidden(model.stack, h, state.caches, state.pos, cfg,
                        shape_window=shape_window)
    logits = unembed(model.tok, rmsnorm(model.ln_f, h, cfg.norm_eps))
    return logits, DecodeState(caches=state.caches, pos=state.pos + 1,
                               last_tok=tokens.to(torch.int32))


@torch.no_grad()
def chunk_step(model: Model, state: DecodeState, tokens: torch.Tensor,
               pos0: torch.Tensor, valid: torch.Tensor,
               reset: torch.Tensor) -> tuple[torch.Tensor, DecodeState]:
    """Process one prompt chunk per row against the decode caches, in place.

    tokens (B, C) int32: up to C prompt tokens per row, written at
    positions [pos0, pos0 + valid); a row with valid 0 does no chunk work
    (its logits are garbage the caller masks). ``reset`` (B,) bool marks
    rows whose cache still holds a previous tenant. Every shape is fixed
    and nothing is read back, so the step fits a CUDA graph. Returns the logits at each row's *last valid* chunk position —
    for a row finishing its prompt, the length-aware prefill's last-token
    logits — and a state whose ``pos`` is pos0 + valid and ``last_tok``
    the chunk's last token for chunk rows, unchanged elsewhere.
    """
    cfg = model.cfg
    B, C = tokens.shape
    h = _embed(model, tokens)
    h = T.chunk_hidden(model.stack, h, state.caches, pos0, valid, reset, cfg)
    last = torch.clamp(valid - 1, 0, C - 1).long()
    rows = torch.arange(B, device=tokens.device)
    logits = unembed(model.tok, rmsnorm(model.ln_f, h[rows, last], cfg.norm_eps))
    chunked = valid > 0
    return logits, DecodeState(
        caches=state.caches,
        pos=torch.where(chunked, pos0 + valid, state.pos),
        last_tok=torch.where(chunked, tokens[rows, last].to(torch.int32), state.last_tok))


@torch.no_grad()
def decode_step_paged(model: Model, state: PagedDecodeState,
                      tokens: torch.Tensor) -> tuple[torch.Tensor, PagedDecodeState]:
    """One decode step for the whole batch against the paged pools; mirrors
    ``decode_step`` (same embed, norm and unembed). tokens: (B,) int32. The
    pools are written in place: the returned state shares them."""
    cfg = model.cfg
    h = _embed(model, tokens)
    h = T.decode_hidden_paged(model.stack, h, state.pools, state.block_tables,
                              state.pos, cfg)
    logits = unembed(model.tok, rmsnorm(model.ln_f, h, cfg.norm_eps))
    return logits, PagedDecodeState(pools=state.pools, block_tables=state.block_tables,
                                    pos=state.pos + 1, last_tok=tokens.to(torch.int32))


@torch.no_grad()
def chunk_step_paged(model: Model, state: PagedDecodeState, tokens: torch.Tensor,
                     pos0: torch.Tensor, valid: torch.Tensor,
                     base: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, PagedDecodeState]:
    """``chunk_step`` against the paged pools, in place: the chunk writes
    only into pages its rows already own (page allocation is the host's),
    so the block tables are unchanged. ``base`` (B,) is each row's
    prefix-cache hit length, read by the staging split of a lossy pool.
    Returns the logits at each row's last valid chunk position and a state
    whose ``pos`` is pos0 + valid and ``last_tok`` the chunk's last token
    for chunk rows, unchanged elsewhere."""
    cfg = model.cfg
    B, C = tokens.shape
    h = _embed(model, tokens)
    h = T.chunk_hidden_paged(model.stack, h, state.pools, state.block_tables, pos0, valid, cfg,
                             base)
    last = torch.clamp(valid - 1, 0, C - 1).long()
    rows = torch.arange(B, device=tokens.device)
    logits = unembed(model.tok, rmsnorm(model.ln_f, h[rows, last], cfg.norm_eps))
    chunked = valid > 0
    return logits, PagedDecodeState(
        pools=state.pools, block_tables=state.block_tables,
        pos=torch.where(chunked, pos0 + valid, state.pos),
        last_tok=torch.where(chunked, tokens[rows, last].to(torch.int32), state.last_tok))


@torch.no_grad()
def paged_splice_prompt(pools: list, caches: list, page_idx) -> list:
    """Copy prefill-built dense caches (cache_len == prompt bucket) into the
    page pools, in place, at a fixed shape. page_idx (B, P // ps), a tensor
    on the pools' device (or a host array): each row's physical pages; ids
    outside the pool (pad rows, shared pages) land on the scratch pages,
    which no block table lists."""
    for pool, cache in zip(pools, caches, strict=True):
        A.paged_splice_prompt(pool, cache, page_idx)
    return pools


@torch.no_grad()
def fork_pages(pools: list, src: torch.Tensor, dst: torch.Tensor) -> list:
    """Copy-on-write page forks across every segment's pools, in place: one
    fixed-shape copy per leaf forks all of a slot's pages. src, dst (F,)
    int64 physical ids on the pools' device (pad: a dst outside the pool)."""
    for pool in pools:
        A.fork_pages(pool, src, dst)
    return pools
