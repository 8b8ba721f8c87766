"""olmoe-1b-7b [moe] — 64 experts top-8 [arXiv:2409.02060].

Assigned: 16L d_model=2048 16H (GQA kv=16 => MHA) d_ff=1024 vocab=50304,
MoE 64e top-8. d_ff=1024 is the per-expert hidden size; every FFN is MoE
(no shared experts, no leading dense layers).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="olmoe-1b-7b",
        arch_type="moe",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=0,
        vocab_size=50304,
        n_experts=64,
        top_k=8,
        moe_d_ff=1024,
        qk_norm=True,
        attn_window=4096,
        tie_embeddings=True,
    ),
    smoke=ModelConfig(
        name="olmoe-1b-7b-smoke",
        arch_type="moe",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=512,
        n_experts=4,
        top_k=2,
        moe_d_ff=64,
        qk_norm=True,
        attn_window=64,
        dtype="float32",
    ),
)
