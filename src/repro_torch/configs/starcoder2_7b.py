"""starcoder2-7b [dense] — GQA kv=4, RoPE, sliding-window 4096
[arXiv:2402.19173]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab=49152,
    rope="rope",
    rope_theta=1e5,
    qkv_bias=True,
    act="gelu",
    norm="layernorm",
    window=4096,  # SWA makes long_500k natively sub-quadratic
    sharding_overrides=(("mlp", ("data",)), ("vocab", ("data",))),
    citation="arXiv:2402.19173",
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab=512,
        window=16,
        sharding_overrides=(),
    )
