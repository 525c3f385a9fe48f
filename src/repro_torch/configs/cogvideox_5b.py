"""cogvideox-5b [dit] — the paper's video-generation workload (§5.1)
[arXiv:2408.06072].

Per the paper's §5.1: 24 attention heads with head_dim 64 (attention width
1536 ≠ d_model — supported via explicit projections).  42 uniform adaLN
blocks at d=3072 ≈ 4.8B parameters.  3D-causal-VAE + patchify stubbed;
latent frame tokens arrive precomputed.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="cogvideox-5b",
    family="dit",
    n_layers=42,
    d_model=3072,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,  # attention width 1536, as in the paper's workload table
    d_ff=12288,
    vocab=0,
    rope="rope",
    causal=False,
    act="gelu",
    norm="layernorm",
    citation="CogVideoX [18]",
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256
    )
