"""Carry the reference package's weights and page pools into the port.

The reference keeps its parameters as a pytree of arrays and stacks each
segment's layers on a leading axis; ``params_from_numpy`` takes that tree
as nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``) and
returns the port's ``Model`` with the same values, one block per layer.
``paged_pool_from_numpy`` carries a reference ``PagedKVPool``'s arrays into
the port's pool layout, scratch pages and rows included, and
``kv_cache_from_numpy`` a reference dense ``KVCache``'s (codes, scales and
staging buffers included, a hybrid group's quantized ring too, and a ring
or pool under an unscaled cast in its stored dtype) and
``rec_state_from_numpy`` a reference RG-LRU ``RecState``'s, so both
packages can start from one cache state. Like
every entry point of the port they place what they build on the card
unless the caller asks for the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import KVCache, PagedKVPool
from repro_torch.models.model import Model
from repro_torch.models.rglru import RecState


def _put(p: torch.Tensor, arr, name: str) -> None:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":   # numpy has no bf16: widen exactly
        a = a.astype(np.float32)
    if tuple(a.shape) != tuple(p.shape):
        raise ValueError(f"{name}: shape {a.shape} != {tuple(p.shape)}")
    p.copy_(torch.tensor(a).to(p.dtype))


def _first_leaf(tree):
    return _first_leaf(next(iter(tree.values()))) if isinstance(tree, dict) else tree


def _put_attn(attn, leaves: dict, i: int, at: str) -> None:
    """Layer i of an attention's stacked leaves (its norms where it has
    them: never on a cross-attention)."""
    for name in ("wq", "wk", "wv", "wo") + (("q_norm", "k_norm") if attn.qk_norm else ()):
        _put(getattr(attn, name), leaves[name][i], f"{at}.{name}")


def _put_stack(stack, tree: list, at: str, cfg: ModelConfig) -> None:
    """A reference stack (per-segment leaves, layers stacked) into the
    port's per-layer blocks."""
    for s, (seg, leaves) in enumerate(zip(stack, tree, strict=True)):
        n = np.asarray(_first_leaf(leaves)).shape[0]
        if n != len(seg):
            raise ValueError(f"{at}[{s}]: {n} layers in the tree, {len(seg)} in the model")
        for i, blk in enumerate(seg):
            _put_block(blk, leaves, i, f"{at}[{s}][{i}]", cfg)


def _put_block(blk, leaves: dict, i: int, at: str, cfg: ModelConfig) -> None:
    """Layer i of a segment's stacked leaves into the port's block."""
    if blk.kind == "group":
        for name in blk.names:
            _put_block(getattr(blk, name), leaves[name], i, f"{at}.{name}", cfg)
        return
    _put(blk.ln1, leaves["ln1"]["scale"][i], f"{at}.ln1")
    if blk.kind in ("ssm", "rec"):
        mod = getattr(blk, blk.kind)
        names = [n for n, _ in mod.named_parameters()]
        if sorted(names) != sorted(leaves[blk.kind]):
            raise ValueError(f"{at}.{blk.kind}: leaves {sorted(leaves[blk.kind])} != "
                             f"{sorted(names)}")
        for name in names:
            _put(getattr(mod, name), leaves[blk.kind][name][i], f"{at}.{blk.kind}.{name}")
        if blk.kind == "ssm":
            return
    else:
        _put_attn(blk.attn, leaves["attn"], i, f"{at}.attn")
    if blk.kind == "dec":
        _put(blk.lnx, leaves["lnx"]["scale"][i], f"{at}.lnx")
        _put_attn(blk.xattn, leaves["xattn"], i, f"{at}.xattn")
    _put(blk.ln2, leaves["ln2"]["scale"][i], f"{at}.ln2")
    if blk.kind == "attn_moe":
        moe, m = blk.moe, leaves["moe"]
        if (moe.shared is None) != ("shared" not in m):
            raise ValueError(f"{at}.moe: shared experts in only one of tree and model")
        for name in ("router", "w_gate", "w_up", "w_down"):
            _put(getattr(moe, name), m[name][i], f"{at}.moe.{name}")
        for name in ("w_gate", "w_up", "w_down") if moe.shared is not None else ():
            _put(getattr(moe.shared, name), m["shared"][name][i], f"{at}.moe.shared.{name}")
        return
    for name in ("w_gate", "w_up", "w_down"):
        _put(getattr(blk, name), leaves["mlp"][name][i], f"{at}.mlp.{name}")


@torch.no_grad()
def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> Model:
    """``tree`` = {"embed": {"tok"}, "stack": [per-segment dict], "ln_f":
    {"scale"}} with segment leaves stacked on a leading layer axis: ``ln1``,
    ``attn``, ``ln2`` and ``mlp`` for an ``attn`` segment, ``moe`` in place
    of ``mlp`` for an ``attn_moe`` segment (``router``, ``w_gate``,
    ``w_up``, ``w_down`` and, with shared experts, ``shared``), ``ln1``
    and ``ssm`` for an ``ssm`` segment, ``rec`` (the RG-LRU's leaves) in
    place of ``attn`` for a ``rec`` segment, and for a hybrid ``group``
    segment one such sub-dict per pattern entry (``b0_rec``, ``b1_rec``,
    ``b2_attn``), each stacked over the groups; a ``dec`` segment adds
    ``lnx`` and the cross-attention ``xattn`` to an ``attn`` segment's
    leaves, and an encoder-decoder's tree has ``encoder`` = {"stack",
    "ln_f"}."""
    model = Model(cfg, device)
    _put(model.tok, tree["embed"]["tok"], "embed.tok")
    _put(model.ln_f, tree["ln_f"]["scale"], "ln_f.scale")
    _put_stack(model.stack, tree["stack"], "stack", cfg)
    if (model.encoder is None) != ("encoder" not in tree):
        raise ValueError("an encoder in only one of tree and model")
    if model.encoder is not None:
        _put_stack(model.encoder.stack, tree["encoder"]["stack"], "encoder.stack", cfg)
        _put(model.encoder.ln_f, tree["encoder"]["ln_f"]["scale"], "encoder.ln_f.scale")
    return model


def _torch(a) -> torch.Tensor:
    """A numpy array as a tensor of its dtype: bfloat16 widened exactly and
    narrowed back, fp8 codes carried as raw bytes."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":
        return torch.tensor(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.tensor(a)


@torch.no_grad()
def paged_pool_from_numpy(k=None, v=None, qk=None, qv=None, k_scale=None, v_scale=None,
                          stage_k=None, stage_v=None, device=None) -> PagedKVPool:
    """The port's pool holding the reference pool's contents, the leaves of
    a reference ``PagedKVPool`` as numpy arrays (None where the reference
    has none; any leading layer axes). Each region gains its scratch page
    (zeros) past its last page, and each staging buffer its scratch row
    past its last position, as ``attention.paged_pool_init`` lays them
    out. ``device`` None: the card."""
    device = resolve_device(device)

    def pad(a, axis):
        if a is None:
            return None
        t = _torch(a)
        axis = t.dim() + axis
        zero = torch.zeros((*t.shape[:axis], 1, *t.shape[axis + 1:]), dtype=t.dtype)
        return torch.cat([t, zero], dim=axis).to(device)
    return PagedKVPool(k=pad(k, -4), v=pad(v, -4), qk=pad(qk, -4), qv=pad(qv, -4),
                       k_scale=pad(k_scale, -3), v_scale=pad(v_scale, -3),
                       stage_k=pad(stage_k, -3), stage_v=pad(stage_v, -3))


@torch.no_grad()
def kv_cache_from_numpy(k, v, slot_pos, k_scale=None, v_scale=None, stage_k=None,
                        stage_v=None, device=None) -> KVCache:
    """The port's dense ring cache holding a reference ``KVCache``'s
    contents, its leaves as numpy arrays (None where the reference has
    none: the scales at native precision, the staging buffers unless the
    storage is lossy; any leading layer axes). ``device`` None: the card."""
    device = resolve_device(device)

    def put(a):
        return None if a is None else _torch(a).to(device)
    return KVCache(k=put(k), v=put(v), slot_pos=put(slot_pos), k_scale=put(k_scale),
                   v_scale=put(v_scale), stage_k=put(stage_k), stage_v=put(stage_v))


@torch.no_grad()
def rec_state_from_numpy(conv, h, device=None) -> RecState:
    """The port's RG-LRU state holding a reference ``RecState``'s contents
    (conv (..., B, W-1, R) in the compute dtype, h (..., B, R) float32; any
    leading layer axes). ``device`` None: the card."""
    device = resolve_device(device)
    return RecState(conv=_torch(conv).to(device), h=_torch(h).to(device))
