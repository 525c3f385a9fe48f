"""Architecture configs of the port: the models it serves (the flux-12b DiT
and the rwkv6-1.6b language model)."""
from __future__ import annotations

import importlib

from .base import ModelConfig

_MODULES = {
    "flux-12b": "flux_12b",
    "rwkv6-1.6b": "rwkv6_1_6b",
}

DIT_ARCHS = ("flux-12b",)
SSM_ARCHS = ("rwkv6-1.6b",)
ALL_ARCHS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f".{_MODULES[arch_id]}", __package__)
    return mod.CONFIG


def get_reduced(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f".{_MODULES[arch_id]}", __package__)
    return mod.reduced()


__all__ = [
    "ALL_ARCHS",
    "DIT_ARCHS",
    "SSM_ARCHS",
    "ModelConfig",
    "get_config",
    "get_reduced",
]
