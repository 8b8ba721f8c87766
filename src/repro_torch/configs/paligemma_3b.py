"""paligemma-3b [vlm] — SigLIP + gemma [arXiv:2407.07726].

Assigned: 18L d_model=2048 8H (GQA kv=1 => MQA) d_ff=16384 vocab=257216.
The SigLIP vision encoder + projector is a STUB — ``input_specs`` provides
256 precomputed patch embeddings at d_model, prepended to the text tokens
(prefix-LM style). This package implements the gemma-style language tower.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="paligemma-3b",
        arch_type="vlm",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=257216,
        act="gelu",
        num_prefix_tokens=256,
        attn_window=4096,
        tie_embeddings=True,
    ),
    smoke=ModelConfig(
        name="paligemma-3b-smoke",
        arch_type="vlm",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=1,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        act="gelu",
        num_prefix_tokens=16,
        attn_window=64,
        dtype="float32",
    ),
)
