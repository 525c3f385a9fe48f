"""Model registry: one uniform API over the ported language models.

    bundle = get_model(cfg)
    params       = bundle.init(cfg, generator, device)
    logits       = bundle.apply(params, batch, cfg, ctx)              # prefill
    out, caches  = bundle.step(params, batch, caches, idx, cfg, ctx)  # decode
    caches       = bundle.init_caches(cfg, batch, max_len, dtype, device)

One bundle serves every LM family of the port (rwkv6, dense, vlm,
hybrid, moe), as the reference's ``LM_BUNDLE`` does.  Batches are plain
dicts: ``tokens``, and for the vlm family ``inputs_embeds`` (prefill) and
[3, B, L] M-RoPE ``positions``.  The reference's ``loss`` and
``input_specs`` come with training, whisper's bundle with the audio
family (both ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from ..configs.base import ModelConfig
from . import lm as lm_mod

@dataclasses.dataclass(frozen=True)
class ModelBundle:
    init: Callable
    apply: Callable  # prefill: (params, batch, cfg, ctx) -> logits
    step: Callable  # decode: (params, batch, caches, idx, cfg, ctx)
    init_caches: Callable


def _lm_apply(params, batch, cfg, ctx, last_only=False):
    logits, _, _ = lm_mod.lm_forward(
        params, cfg, ctx,
        tokens=batch.get("tokens"),
        inputs_embeds=batch.get("inputs_embeds"),
        positions=batch.get("positions"),
        last_only=last_only,
    )
    return logits


def _lm_step(params, batch, caches, cur_index, cfg, ctx):
    logits, _, new_caches = lm_mod.lm_forward(
        params, cfg, ctx,
        tokens=batch.get("tokens"),
        positions=batch.get("positions"),
        caches=caches, cur_index=cur_index,
    )
    return logits[:, -1], new_caches


LM_BUNDLE = ModelBundle(
    init=lm_mod.init_lm,
    apply=_lm_apply,
    step=_lm_step,
    init_caches=lm_mod.init_lm_caches,
)


def get_model(cfg: ModelConfig) -> ModelBundle:
    """The bundle of a language model.  The DiT is driven through
    ``models/dit.py:dit_forward`` and ``DiTServer``; whisper is not ported
    yet."""
    if cfg.family in ("audio", "dit"):
        raise NotImplementedError(f"no bundle for the {cfg.family} family: "
                                  f"{lm_mod.LM_ITEM}")
    return LM_BUNDLE
