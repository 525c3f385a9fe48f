"""Logical-axis → mesh-axis sharding rules (the rules part of
``src/repro/models/sharding.py``, copied; ``tests/test_torch_copies.py``
pins them).

The reference maps each parameter's logical axis names to mesh axes per
deployment mode and builds ``NamedSharding``s from them
(``param_shardings`` / ``param_pspecs``).  Those two have no counterpart
here: every virtual rank of a mesh lives on one device
(``launch/mesh.py``), so a parameter is one tensor and a rank's part of it
is a view taken where it is used.  Placing parts on other cards comes
with the multi-card transport (ROADMAP Queue 1 item 8).  What the port
reads is the rule table: ``models/moe.py`` asks ``rules_for(cfg,
"serve")`` whether the expert hidden dims are split over a data axis,
which selects the token-gather decode, as the reference's ``moe_block``
does.
"""
from __future__ import annotations

from ..configs.base import ModelConfig

# logical axis -> tuple of mesh axes ((), = replicated)
BASE_RULES: dict[str, tuple[str, ...]] = {
    "vocab": (),
    "embed": (),
    "embed_out": (),
    "embed_norm": (),
    "mlp": (),
    "heads_flat": (),
    "kv_heads_flat": (),
    "experts": ("model",),
    "expert_mlp": ("data",),
    "ssm_heads": (),
    "layers": (),
}

TRAIN_EXTRAS: dict[str, tuple[str, ...]] = {
    # shard the optimizer-dominant dims over data (ZeRO / weight FSDP).
    # "vocab" stays per-config (whisper/hymba vocabs aren't divisible by 16).
    "mlp": ("data",),
    "heads_flat": ("data",),
    "kv_heads_flat": ("data",),
}


def rules_for(cfg: ModelConfig, mode: str,
              extra_rules: dict[str, tuple[str, ...]] | None = None
              ) -> dict[str, tuple[str, ...]]:
    rules = dict(BASE_RULES)
    if mode == "train":
        rules.update(TRAIN_EXTRAS)
    rules.update({k: tuple(v) for k, v in cfg.sharding_overrides})
    if extra_rules:  # e.g. {"layers": ("pipe",)} for patch pipelining
        rules.update(extra_rules)
    return rules
