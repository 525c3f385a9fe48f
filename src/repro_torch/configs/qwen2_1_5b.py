"""qwen2-1.5b [dense] — GQA, QKV bias [arXiv:2407.10671]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    rope="rope",
    rope_theta=1e6,
    act="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    sharding_overrides=(("vocab", ("data",)),),
    citation="arXiv:2407.10671",
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=512
    )
