"""stablelm-3b [dense] — partial rotary (25%), LayerNorm
[hf:stabilityai/stablelm-2-1_6b]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab=50304,
    rope="rope",
    rope_pct=0.25,
    act="swiglu",
    norm="layernorm",
    sharding_overrides=(("vocab", ("data",)),),
    citation="hf:stabilityai/stablelm-2-1_6b",
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256, vocab=512
    )
