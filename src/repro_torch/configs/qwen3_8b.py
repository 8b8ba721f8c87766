"""qwen3-8b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B].

Assigned: 36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936.
qk_norm: per-head RMSNorm applied to q and k before RoPE (Qwen3).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen3-8b",
        arch_type="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=12288,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        attn_window=4096,
        tie_embeddings=True,
    ),
    smoke=ModelConfig(
        name="qwen3-8b-smoke",
        arch_type="dense",
        n_layers=2,
        d_model=256,
        n_heads=8,
        n_kv_heads=2,
        head_dim=32,
        d_ff=512,
        vocab_size=512,
        qk_norm=True,
        attn_window=64,
        dtype="float32",
    ),
)
