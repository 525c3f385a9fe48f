"""flux-12b [dit] — the paper's image-generation workload (§5.1)
[Flux.1, arXiv:2506.15742 / Black Forest Labs 2025].

Approximation (documented): Flux interleaves 19 double-stream and 38
single-stream MM-DiT blocks; we model it as a uniform stack of 96 adaLN
DiT blocks at the same width (d=3072, 24 heads × head_dim 128 — the head
geometry the paper's §5.3 sweeps use), giving ~11B parameters.  Latent
tokens arrive pre-patchified (VAE + patchify stubbed per DESIGN.md §6);
conditioning is a precomputed text-embedding sequence + timestep.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="flux-12b",
    family="dit",
    n_layers=96,
    d_model=3072,
    n_heads=24,
    n_kv_heads=24,
    head_dim=128,
    d_ff=12288,
    vocab=0,  # continuous latents, no token embedding
    rope="rope",
    causal=False,
    act="gelu",
    norm="layernorm",
    citation="Flux.1 [8]",
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256
    )
