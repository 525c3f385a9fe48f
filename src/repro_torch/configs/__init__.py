"""Architecture configs of the port: the DiT workloads it serves so far."""
from __future__ import annotations

import importlib

from .base import ModelConfig

_MODULES = {
    "flux-12b": "flux_12b",
}

DIT_ARCHS = ("flux-12b",)
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
    "ModelConfig",
    "get_config",
    "get_reduced",
]
