"""recurrentgemma-2b [hybrid] — RG-LRU + local attn, 1:2 [arXiv:2402.19427].

Assigned: 26L d_model=2560 10H (GQA kv=1 => MQA) d_ff=7680 vocab=256000.
Griffin pattern: (rec, rec, attn) repeated — 1 local-attention layer per 2
RG-LRU layers; window 2048. lru_width=2560, block-diagonal gates w/ 10 heads.
Sub-quadratic (recurrent state + bounded window) => long_500k runs natively.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="recurrentgemma-2b",
        arch_type="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256000,
        act="gelu",
        block_pattern=("rec", "rec", "attn"),
        lru_width=2560,
        lru_heads=10,
        local_window=2048,
        conv_width=4,
        tie_embeddings=True,
    ),
    smoke=ModelConfig(
        name="recurrentgemma-2b-smoke",
        arch_type="hybrid",
        n_layers=3,
        d_model=128,
        n_heads=4,
        n_kv_heads=1,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        act="gelu",
        block_pattern=("rec", "rec", "attn"),
        lru_width=128,
        lru_heads=4,
        local_window=32,
        conv_width=4,
        dtype="float32",
    ),
)
