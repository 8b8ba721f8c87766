"""seamless-m4t-large-v2 [audio] — enc-dec, multimodal [arXiv:2308.11596].

Assigned: 24L d_model=1024 16H (GQA kv=16 => MHA) d_ff=8192 vocab=256206.
The single total-layer count "24L" is split 12 encoder + 12 decoder (see
DESIGN.md §4). The mel-spectrogram + conformer feature frontend is a STUB —
``input_specs`` provides precomputed frame embeddings (B, enc_seq, 1024);
this package implements the transformer encoder over those frames and the
text decoder (self-attn + cross-attn).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="seamless-m4t-large-v2",
        arch_type="audio",
        n_layers=12,           # decoder layers (12 enc + 12 dec = assigned 24L)
        n_enc_layers=12,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=8192,
        vocab_size=256206,
        enc_seq=1024,
        tie_embeddings=True,
        attn_window=4096,      # decoder sliding-window variant for long_500k
    ),
    smoke=ModelConfig(
        name="seamless-m4t-large-v2-smoke",
        arch_type="audio",
        n_layers=2,
        n_enc_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        enc_seq=32,
        attn_window=64,
        dtype="float32",
    ),
)
