"""Architecture configs of the port: the models it serves (the flux-12b and
cogvideox-5b DiTs, the rwkv6-1.6b language model, the dense and
vision-language attention LMs, the hybrid hymba-1.5b, the MoE LMs and
the whisper-tiny encoder-decoder), and the input shapes (the paper's DiT workloads among them)."""
from __future__ import annotations

import importlib

from .base import ModelConfig
from .shapes import DIT_SHAPES, SHAPES, InputShape

_MODULES = {
    "flux-12b": "flux_12b",
    "cogvideox-5b": "cogvideox_5b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "qwen2-1.5b": "qwen2_1_5b",
    "stablelm-3b": "stablelm_3b",
    "starcoder2-7b": "starcoder2_7b",
    "chatglm3-6b": "chatglm3_6b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "hymba-1.5b": "hymba_1_5b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "arctic-480b": "arctic_480b",
    "whisper-tiny": "whisper_tiny",
}

DIT_ARCHS = ("flux-12b", "cogvideox-5b")
SSM_ARCHS = ("rwkv6-1.6b",)
# attention LMs: the dense family and the vision-language backbone
DENSE_ARCHS = ("qwen2-1.5b", "stablelm-3b", "starcoder2-7b", "chatglm3-6b",
               "qwen2-vl-2b")
# attention in parallel with an SSD branch per layer
HYBRID_ARCHS = ("hymba-1.5b",)
# routed experts: shared experts (qwen2-moe) or a dense residual (arctic)
MOE_ARCHS = ("qwen2-moe-a2.7b", "arctic-480b")
# encoder-decoder with cross-attention (the audio family)
AUDIO_ARCHS = ("whisper-tiny",)
ALL_ARCHS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f".{_MODULES[arch_id]}", __package__)
    return mod.CONFIG


def get_reduced(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f".{_MODULES[arch_id]}", __package__)
    return mod.reduced()


__all__ = [
    "ALL_ARCHS",
    "AUDIO_ARCHS",
    "DENSE_ARCHS",
    "DIT_ARCHS",
    "DIT_SHAPES",
    "HYBRID_ARCHS",
    "InputShape",
    "MOE_ARCHS",
    "ModelConfig",
    "SHAPES",
    "SSM_ARCHS",
    "get_config",
    "get_reduced",
]
