"""Displaced patch pipeline parallelism for DiT inference (PipeFusion,
arXiv:2405.14430): the configuration and the threaded KV state.

The displaced forward itself (``displaced_attention``, ``kv_drift``,
patch/stage partitioning) is not ported yet (ROADMAP Queue 1 item 5);
``SamplerConfig`` and the drift policy refer to these two types.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Patch-level pipeline parallelism knobs (PipeFusion).

    ``pp``           — pipeline stages; DiT blocks are split into ``pp``
                       contiguous groups along a ``pp_axis`` mesh axis.
    ``num_patches``  — latent patches streamed through the stages; 0 means
                       "same as pp" (the paper's default M = N choice).
    ``warmup_steps`` — leading sampler steps run fully synchronous (no
                       staleness) to populate the per-layer KV state; must
                       be >= 1.
    ``resync_every`` — after warmup, run one fully-synchronous re-sync step
                       every this many sampler steps.  0 = never; 1 = every
                       step synchronous (no staleness at all).
    ``pp_axis``      — mesh axis name holding the stages.
    """

    pp: int = 1
    num_patches: int = 0
    warmup_steps: int = 1
    resync_every: int = 0
    pp_axis: str = "pipe"

    def __post_init__(self):
        assert self.pp >= 1, self
        assert self.num_patches >= 0, self
        assert self.warmup_steps >= 1, "first step must populate the KV state"
        assert self.resync_every >= 0, self

    @property
    def patches(self) -> int:
        return self.num_patches or self.pp

    @property
    def enabled(self) -> bool:
        return self.pp > 1 or self.patches > 1

    def warm_step(self, i: int) -> bool:
        """Whether sampler step ``i`` runs fully synchronous: the warmup
        prefix, plus every ``resync_every``-th step after it."""
        if i < self.warmup_steps:
            return True
        if self.resync_every <= 0:
            return False
        return (i - self.warmup_steps + 1) % self.resync_every == 0


class KVState(NamedTuple):
    """Per-layer full-sequence attention KV from the previous sampler step.

    ``k`` is stored post-RoPE so stale rows can be attended directly.
    Shapes: [n_layers, B, T_total, Hkv, D] each, where T_total counts the
    conditioning tokens + latent tokens (models/dit.py concatenates them).
    """

    k: torch.Tensor
    v: torch.Tensor
