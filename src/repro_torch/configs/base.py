"""ModelConfig — one dataclass covering all assigned architecture families.

Frozen + hashable so configs can be static args to jit'd builders. Every
assigned architecture gets a module in this package defining CONFIG (the
exact assigned spec, citation in the docstring) and SMOKE (a reduced variant
of the same family: <=2 layers, d_model<=512, <=4 experts) for CPU tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None            # default: d_model // n_heads
    qk_norm: bool = False                     # per-head RMSNorm on q,k (qwen3)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    act: str = "silu"                         # mlp activation (gemma: gelu)
    attn_window: Optional[int] = None         # None = full causal; int = sliding window
    attn_logit_softcap: Optional[float] = None
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0                 # deepseek shared experts (always on)
    moe_d_ff: int = 0                         # per-expert hidden size
    first_k_dense: int = 0                    # deepseek: first k layers use dense FFN
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # dispatch at most this many tokens per MoE gather/scatter block; long
    # prefills scan over blocks so (E,C,D) buffers stay bounded (§Perf).
    moe_block: int = 131072
    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0                        # N (state size); >0 selects SSM blocks
    ssm_expand: int = 2
    ssm_headdim: int = 64                     # P
    ssm_chunk: int = 128                      # SSD chunk length Q
    conv_width: int = 4
    # --- hybrid (RecurrentGemma) ---
    block_pattern: tuple = ()                 # e.g. ("rec", "rec", "attn")
    lru_width: Optional[int] = None           # RG-LRU recurrent width
    lru_heads: int = 1                        # block-diagonal gate heads
    local_window: int = 2048                  # window of "attn" blocks in pattern
    # --- encoder-decoder (audio) ---
    n_enc_layers: int = 0                     # >0 => enc-dec model
    enc_seq: int = 1024                       # stub audio-frame count (encoder input)
    # --- multimodal prefix (VLM) ---
    num_prefix_tokens: int = 0                # vision patch tokens prepended
    # --- numerics ---
    dtype: str = "bfloat16"
    remat: bool = True
    # "full" recomputes everything per layer in bwd; "dots" saves matmul
    # outputs (jax dots_with_no_batch_dims_saveable) trading HBM for FLOPs —
    # a §Perf knob for compute-bound training.
    remat_policy: str = "full"
    # KV-cache storage dtype; "float8_e4m3fn" halves decode memory traffic
    # (§Perf knob for memory-bound decode). DEPRECATED: an unscaled cast,
    # subsumed by kv_precision (resolve_kv_precision warns when only this
    # is set).
    cache_dtype: str = ""  # "" => same as dtype
    # KV-cache precision spec (DESIGN.md §14): "" / "native" (store the
    # compute dtype), "int8" / "fp8" (scaled per-token-per-head storage,
    # dequantized on read), or any raw dtype string (legacy cast). Parsed
    # by repro.cache.precision.parse_kv_precision; kept a plain string so
    # the config stays hashable and jax-free.
    kv_precision: str = ""
    # >0: vocab-blocked flash cross-entropy (never materialize (T,V) logits);
    # the actual block is the largest divisor of vocab_size <= this value.
    loss_vocab_block: int = 0

    # ------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.ssm_state > 0 and not self.block_pattern

    @property
    def is_hybrid(self) -> bool:
        return bool(self.block_pattern)

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def lru_width_(self) -> int:
        return self.lru_width if self.lru_width is not None else self.d_model

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (used by roofline's 6ND MODEL_FLOPS)."""
        D, hd = self.d_model, self.head_dim_
        emb = self.vocab_size * D * (1 if self.tie_embeddings else 2)
        per_attn = D * (self.n_heads * hd) + 2 * D * (self.n_kv_heads * hd) + (self.n_heads * hd) * D
        per_mlp = 3 * D * self.d_ff if self.d_ff else 0
        per_moe = 0
        if self.is_moe:
            per_moe = self.n_experts * 3 * D * self.moe_d_ff + D * self.n_experts
            per_moe += self.n_shared_experts * 3 * D * self.moe_d_ff
        per_ssm = 0
        if self.ssm_state:
            di, N, H = self.d_inner, self.ssm_state, self.n_ssm_heads
            per_ssm = D * (2 * di + 2 * N + H) + di * D + self.conv_width * (di + 2 * N) + 3 * H + di
        per_rec = 0
        if self.is_hybrid:
            R = self.lru_width_
            nb = self.lru_heads
            per_rec = 2 * D * R + R * D + self.conv_width * R + 2 * nb * (R // nb) ** 2 + 3 * R
        total = emb
        if self.is_hybrid:
            n_rec = sum(1 for i in range(self.n_layers) if self.pattern_at(i) == "rec")
            n_att = self.n_layers - n_rec
            total += n_rec * (per_rec + per_mlp) + n_att * (per_attn + per_mlp)
        elif self.is_ssm:
            total += self.n_layers * per_ssm
        elif self.is_moe:
            dense_layers = self.first_k_dense
            moe_layers = self.n_layers - dense_layers
            dense_ff = 3 * D * self.d_ff if self.d_ff else 3 * D * (self.moe_d_ff * self.top_k)
            total += dense_layers * (per_attn + dense_ff) + moe_layers * (per_attn + per_moe)
        else:
            total += self.n_layers * (per_attn + per_mlp)
        if self.is_encdec:
            # encoder layers (attn+mlp) + decoder cross-attn
            total += self.n_enc_layers * (per_attn + per_mlp) + self.n_layers * per_attn
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if not self.is_moe:
            return self.param_count()
        D = self.d_model
        per_moe_all = self.n_experts * 3 * D * self.moe_d_ff
        per_moe_active = (self.top_k + self.n_shared_experts) * 3 * D * self.moe_d_ff
        moe_layers = self.n_layers - self.first_k_dense
        return self.param_count() - moe_layers * (per_moe_all + self.n_shared_experts * 3 * D * self.moe_d_ff - per_moe_active)

    def pattern_at(self, i: int) -> str:
        if not self.block_pattern:
            return "ssm" if self.is_ssm else "attn"
        return self.block_pattern[i % len(self.block_pattern)]


_REGISTRY: dict = {}


def register(cfg: ModelConfig, smoke: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = (cfg, smoke)
    return cfg


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name][1 if smoke else 0]


def list_archs() -> list:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    if _REGISTRY:
        return
    import importlib

    for mod in (
        "seamless_m4t_large_v2",
        "mamba2_130m",
        "granite_3_8b",
        "qwen3_8b",
        "paligemma_3b",
        "recurrentgemma_2b",
        "olmoe_1b_7b",
        "granite_3_2b",
        "deepseek_moe_16b",
        "internlm2_20b",
    ):
        importlib.import_module(f"repro_torch.configs.{mod}")
