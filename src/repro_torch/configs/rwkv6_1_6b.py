"""rwkv6-1.6b [ssm] — Finch, data-dependent decay, attention-free
[arXiv:2404.05892].

No attention ⇒ the paper's SP-attention technique is inapplicable
(DESIGN.md §5); sequence sharding instead uses a distributed
chunked-state prefix scan (log₂P ppermute rounds) over the WKV6
recurrence.  Decode is O(1)-state.
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=0,  # attention-free
    n_kv_heads=0,
    d_ff=7168,
    vocab=65536,
    rope="none",
    norm="layernorm",
    ssm=SSMConfig(state_size=64, n_ssm_heads=32),  # head_size 64 ⇒ 32 heads
    sharding_overrides=(("vocab", ("data",)),),
    citation="arXiv:2404.05892",
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        d_model=128,
        d_ff=256,
        vocab=512,
        ssm=SSMConfig(state_size=16, n_ssm_heads=8),
    )
