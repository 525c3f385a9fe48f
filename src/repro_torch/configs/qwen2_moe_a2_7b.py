"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,  # routed-expert hidden size (assignment spec)
    vocab=151936,
    qkv_bias=True,
    rope="rope",
    rope_theta=1e6,
    act="swiglu",
    norm="rmsnorm",
    moe=MoEConfig(
        n_experts=60,
        top_k=4,
        n_shared_experts=4,
        moe_d_ff=1408,
        capacity_factor=1.25,
    ),
    sharding_overrides=(("vocab", ("data",)),),
    citation="hf:Qwen/Qwen1.5-MoE-A2.7B",
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=64,
        vocab=512,
        moe=MoEConfig(n_experts=4, top_k=2, n_shared_experts=1, moe_d_ff=64),
    )
