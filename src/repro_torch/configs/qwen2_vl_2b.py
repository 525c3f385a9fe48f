"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191].

Transformer backbone only; the ViT vision tower + projector is the stubbed
modality frontend — ``input_specs()`` supplies precomputed patch embeddings
interleaved with text embeddings, plus the 3-component (temporal, h, w)
M-RoPE position ids.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    rope="mrope",
    rope_theta=1e6,
    act="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    sharding_overrides=(("vocab", ("data",)),),
    citation="arXiv:2409.12191",
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=512
    )
