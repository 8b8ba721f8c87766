"""mamba2-130m [ssm] — SSD, state-space duality [arXiv:2405.21060].

Assigned: 24L d_model=768 (attn-free) d_ff=0 vocab=50280, ssm_state=128.
Mamba-2 block: expand=2 (d_inner=1536), headdim=64 (24 SSD heads), conv4.
Sub-quadratic by construction => long_500k runs natively (O(1) decode state).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="mamba2-130m",
        arch_type="ssm",
        n_layers=24,
        d_model=768,
        n_heads=1,             # unused (attn-free)
        n_kv_heads=1,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_expand=2,
        ssm_headdim=64,
        ssm_chunk=128,
        conv_width=4,
        tie_embeddings=True,
    ),
    smoke=ModelConfig(
        name="mamba2-130m-smoke",
        arch_type="ssm",
        n_layers=2,
        d_model=128,
        n_heads=1,
        n_kv_heads=1,
        d_ff=0,
        vocab_size=512,
        ssm_state=32,
        ssm_expand=2,
        ssm_headdim=32,
        ssm_chunk=16,
        conv_width=4,
        dtype="float32",
    ),
)
