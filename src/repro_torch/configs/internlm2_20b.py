"""internlm2-20b [dense] — GQA [arXiv:2403.17297].

Assigned: 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544.
Largest dense arch — the TP/ZeRO stress test of the fleet.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="internlm2-20b",
        arch_type="dense",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab_size=92544,
        attn_window=4096,
        tie_embeddings=True,
    ),
    smoke=ModelConfig(
        name="internlm2-20b-smoke",
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
