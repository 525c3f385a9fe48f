"""Model/architecture configuration.

One ``ModelConfig`` covers every assigned family (dense / moe / ssm /
hybrid / vlm / audio / dit); family-specific fields are simply unused by
the others.  Every config file in this package cites its source in the
module docstring, and provides

    CONFIG          — the full assigned architecture
    reduced()       — the smoke-test variant (≤2 layers, d_model ≤ 512,
                      ≤4 experts) of the same family
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio", "dit"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 2
    n_shared_experts: int = 0  # qwen2-moe: shared experts always active
    dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    moe_d_ff: int = 0  # routed-expert hidden size
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001  # load-balance loss weight


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_size: int = 16
    expand: int = 2  # d_inner = expand * d_model (mamba-style)
    n_ssm_heads: int = 0  # rwkv: heads for WKV; hymba: mamba heads
    dt_rank: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int  # 0 for attention-free archs (rwkv6)
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # --- positional / attention flavour ---
    rope: Literal["rope", "mrope", "rope2d", "sinusoidal", "none"] = "rope"
    rope_theta: float = 10000.0
    rope_pct: float = 1.0  # stablelm: partial rotary
    qkv_bias: bool = False
    causal: bool = True
    window: int | None = None  # sliding-window attention (tokens)
    global_attn_every: int = 0  # hymba: every k-th layer is global
    # --- families ---
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    encoder_layers: int = 0  # whisper: encoder depth (decoder = n_layers)
    encoder_seq: int = 1536  # whisper: frames after conv frontend (padded for SP)
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    act: Literal["swiglu", "gelu", "geglu"] = "swiglu"
    tie_embeddings: bool = False
    # --- numerics / sharding ---
    dtype: str = "bfloat16"
    # logical-axis -> mesh-axes rules; see models/sharding.py
    sharding_overrides: tuple[tuple[str, tuple[str, ...]], ...] = ()
    citation: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.n_heads == 0

    def params_dense_estimate(self) -> float:
        """Rough total parameter count (for roofline MODEL_FLOPS = 6·N·D)."""
        d, ff, l = self.d_model, self.d_ff, self.n_layers
        hd = self.resolved_head_dim
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.attention_free:
            attn = 2 * d * d  # rwkv time-mix approx
        gate = 3 if self.act in ("swiglu", "geglu") else 2
        mlp = gate * d * ff
        if self.moe:
            mlp = gate * d * self.moe.moe_d_ff * self.moe.n_experts
            mlp += gate * d * self.moe.moe_d_ff * self.moe.n_shared_experts
            if self.moe.dense_residual:
                mlp += gate * d * self.d_ff
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return float(l * (attn + mlp) + emb)

    def params_active_estimate(self) -> float:
        """Active parameters per token (MoE: top-k + shared + dense)."""
        if not self.moe:
            return self.params_dense_estimate()
        d, l = self.d_model, self.n_layers
        hd = self.resolved_head_dim
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        gate = 3 if self.act in ("swiglu", "geglu") else 2
        mlp = gate * d * self.moe.moe_d_ff * (self.moe.top_k + self.moe.n_shared_experts)
        if self.moe.dense_residual:
            mlp += gate * d * self.d_ff
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return float(l * (attn + mlp) + emb)
