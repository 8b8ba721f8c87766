"""granite-3-2b [dense] — GQA [hf:ibm-granite/granite-3.0-2b-base].

Assigned: 40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="granite-3-2b",
        arch_type="dense",
        n_layers=40,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=49155,
        attn_window=4096,
        tie_embeddings=True,
    ),
    smoke=ModelConfig(
        name="granite-3-2b-smoke",
        arch_type="dense",
        n_layers=2,
        d_model=256,
        n_heads=8,
        n_kv_heads=2,
        d_ff=512,
        vocab_size=512,
        attn_window=64,
        dtype="float32",
    ),
)
