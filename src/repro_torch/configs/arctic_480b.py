"""arctic-480b [moe] — 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base].

Dense-MoE hybrid: every layer has a dense FFN residual *in parallel* with
the routed top-2 MoE.  Expert weights are sharded expert-dim over 'model'
and hidden-dim over 'data' (sharding_overrides) so the 480B total fits
256 × 16 GiB chips.
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,  # dense-residual hidden size
    vocab=32000,
    rope="rope",
    act="swiglu",
    norm="rmsnorm",
    moe=MoEConfig(
        n_experts=128,
        top_k=2,
        dense_residual=True,
        moe_d_ff=4864,
        capacity_factor=1.25,
    ),
    sharding_overrides=(
        ("experts", ("model",)),
        ("expert_mlp", ("data",)),
        ("mlp", ("data",)),
        ("vocab", ("data",)),
        ("heads_flat", ("data",)),
        ("kv_heads_flat", ("data",)),
    ),
    citation="hf:Snowflake/snowflake-arctic-base",
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=128,
        vocab=512,
        moe=MoEConfig(n_experts=4, top_k=2, dense_residual=True, moe_d_ff=128),
        sharding_overrides=(),
    )
