"""Carry the reference package's weights and page pools into the port.

The reference keeps its parameters as a pytree of arrays and stacks each
segment's layers on a leading axis; ``params_from_numpy`` takes that tree
as nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``) and
returns the port's ``Model`` with the same values, one block per layer.
``paged_pool_from_numpy`` carries a reference ``PagedKVPool``'s arrays into
the port's pool layout, scratch pages and rows included.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import PagedKVPool
from repro_torch.models.model import Model


def _put(p: torch.Tensor, arr, name: str) -> None:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":   # numpy has no bf16: widen exactly
        a = a.astype(np.float32)
    if tuple(a.shape) != tuple(p.shape):
        raise ValueError(f"{name}: shape {a.shape} != {tuple(p.shape)}")
    p.copy_(torch.tensor(a).to(p.dtype))


@torch.no_grad()
def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> Model:
    """``tree`` = {"embed": {"tok"}, "stack": [per-segment dict], "ln_f":
    {"scale"}} with segment leaves stacked on a leading layer axis: ``ln1``,
    ``attn``, ``ln2`` and ``mlp`` for an ``attn`` segment, ``ln1`` and
    ``ssm`` for an ``ssm`` segment."""
    model = Model(cfg, device)
    _put(model.tok, tree["embed"]["tok"], "embed.tok")
    _put(model.ln_f, tree["ln_f"]["scale"], "ln_f.scale")
    for s, (seg, leaves) in enumerate(zip(model.stack, tree["stack"], strict=True)):
        n = np.asarray(leaves["ln1"]["scale"]).shape[0]
        if n != len(seg):
            raise ValueError(f"segment {s}: {n} layers in the tree, {len(seg)} in the model")
        for i, blk in enumerate(seg):
            at = f"stack[{s}][{i}]"
            _put(blk.ln1, leaves["ln1"]["scale"][i], f"{at}.ln1")
            if blk.kind == "ssm":
                names = [n for n, _ in blk.ssm.named_parameters()]
                if sorted(names) != sorted(leaves["ssm"]):
                    raise ValueError(f"{at}.ssm: leaves {sorted(leaves['ssm'])} != {sorted(names)}")
                for name in names:
                    _put(getattr(blk.ssm, name), leaves["ssm"][name][i], f"{at}.ssm.{name}")
                continue
            _put(blk.ln2, leaves["ln2"]["scale"][i], f"{at}.ln2")
            for name in ("wq", "wk", "wv", "wo") + (("q_norm", "k_norm") if cfg.qk_norm else ()):
                _put(getattr(blk.attn, name), leaves["attn"][name][i], f"{at}.attn.{name}")
            for name in ("w_gate", "w_up", "w_down"):
                _put(getattr(blk, name), leaves["mlp"][name][i], f"{at}.mlp.{name}")
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
                          stage_k=None, stage_v=None, device="cpu") -> PagedKVPool:
    """The port's pool holding the reference pool's contents, the leaves of
    a reference ``PagedKVPool`` as numpy arrays (None where the reference
    has none; any leading layer axes). Each region gains its scratch page
    (zeros) past its last page, and each staging buffer its scratch row
    past its last position, as ``attention.paged_pool_init`` lays them
    out."""
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
