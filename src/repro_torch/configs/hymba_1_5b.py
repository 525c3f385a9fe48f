"""hymba-1.5b [hybrid] — parallel attention + mamba heads per layer
[arXiv:2411.13676].

Each layer runs a GQA attention branch and an SSM (mamba-style selective
scan) branch in parallel on the same input, outputs mean-combined after
per-branch normalisation.  Layers {0, mid, last} use global attention, all
others sliding-window (Hymba §2.2).
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    rope="rope",
    act="swiglu",
    norm="rmsnorm",
    window=2048,  # SWA layers; global layers = {0, mid, last}
    ssm=SSMConfig(state_size=16, expand=1, n_ssm_heads=25),
    citation="arXiv:2411.13676",
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
        d_ff=256,
        vocab=512,
        window=16,
        ssm=SSMConfig(state_size=8, expand=1, n_ssm_heads=4),
    )
