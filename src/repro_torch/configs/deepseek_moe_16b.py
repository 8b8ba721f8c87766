"""deepseek-moe-16b [moe] — fine-grained experts [arXiv:2401.06066].

Assigned: 28L d_model=2048 16H (GQA kv=16 => MHA) d_ff=1408 vocab=102400,
MoE 64e top-6, 2 shared experts. Per the paper, the first layer keeps a
dense FFN (first_k_dense=1); shared experts are always-on and added to the
routed top-6 output. d_ff=1408 is the fine-grained per-expert hidden size;
the dense first layer uses 4*1408*... = standard deepseek dense d_ff 10944,
approximated here as (top_k + shared) * moe_d_ff to keep FLOP parity.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="deepseek-moe-16b",
        arch_type="moe",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=11264,            # dense FFN of the first layer: (6+2)*1408
        vocab_size=102400,
        n_experts=64,
        top_k=6,
        n_shared_experts=2,
        moe_d_ff=1408,
        first_k_dense=1,
        attn_window=4096,
        tie_embeddings=True,
    ),
    smoke=ModelConfig(
        name="deepseek-moe-16b-smoke",
        arch_type="moe",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        n_experts=4,
        top_k=2,
        n_shared_experts=1,
        moe_d_ff=32,
        first_k_dense=1,
        attn_window=64,
        dtype="float32",
    ),
)
