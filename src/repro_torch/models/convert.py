"""Carry the reference package's weights into the port.

The reference keeps its parameters as a pytree of arrays and stacks each
segment's layers on a leading axis; ``params_from_numpy`` takes that tree
as nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``) and
returns the port's ``Model`` with the same values, one block per layer.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
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
