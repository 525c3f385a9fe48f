"""whisper-tiny [audio] — encoder-decoder, conv frontend stubbed
[arXiv:2212.04356].

``input_specs()`` supplies precomputed frame embeddings (the output of the
mel-spectrogram + 2-conv frontend) of shape [B, encoder_seq, d_model].
Decode shapes exercise the decoder backbone mechanically; 32k/500k KV far
exceeds Whisper's real 448-token decoder context and is shape-stress only
(DESIGN.md §5).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-tiny",
    family="audio",
    n_layers=4,  # decoder layers
    encoder_layers=4,
    encoder_seq=1536,  # 1500 real frames padded to 1536 for SP divisibility
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    rope="sinusoidal",
    qkv_bias=True,
    act="gelu",
    norm="layernorm",
    citation="arXiv:2212.04356",
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        encoder_layers=2,
        encoder_seq=64,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab=512,
    )
