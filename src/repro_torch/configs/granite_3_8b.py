"""granite-3-8b [dense] — GQA [hf:ibm-granite/granite-3.0-2b-base family].

Assigned: 40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.
long_500k uses the sliding-window variant (attn_window set; full-attention
decode is exercised by decode_32k) — see DESIGN.md §4.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="granite-3-8b",
        arch_type="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=12800,
        vocab_size=49155,
        attn_window=4096,   # applied only for the long_500k shape (see dryrun)
        tie_embeddings=True,
    ),
    smoke=ModelConfig(
        name="granite-3-8b-smoke",
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
