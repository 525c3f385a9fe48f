"""chatglm3-6b [dense] — RoPE 2d (half-dim rotary), GQA kv=2
[arXiv:2406.12793]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=65024,
    rope="rope2d",  # rotary on half the head dim, interleaved pairs
    qkv_bias=True,
    act="swiglu",
    norm="rmsnorm",
    sharding_overrides=(("mlp", ("data",)), ("vocab", ("data",))),
    citation="arXiv:2406.12793",
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
        sharding_overrides=(),
    )
