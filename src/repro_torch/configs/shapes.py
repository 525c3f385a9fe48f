"""Assigned input shapes (assignment block) + the paper's own workloads.

Decode shapes lower ``serve_step`` (ONE new token against a KV cache of
``seq_len``); train/prefill lower ``train_step``/``prefill_step``.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Kind = Literal["training", "prefill", "decode"]


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: Kind


TRAIN_4K = InputShape("train_4k", 4_096, 256, "training")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

SHAPES: dict[str, InputShape] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}

# Paper workloads (§5.1): DiT sampling is one prefill-like step per diffusion
# iteration over the full latent sequence.
#   Flux 3072x3072 image, patch 16x16 latents /8 VAE: (3072/8/2)^2 = 36864 tok
#   CogVideoX 20s 768x1360: ~48k visual tokens (paper's 96k-192k layerwise
#   sweep brackets these).
FLUX_3K = InputShape("flux_3072", 36_864, 1, "prefill")
FLUX_4K = InputShape("flux_4096", 65_536, 1, "prefill")
COGVIDEO_20S = InputShape("cogvideox_20s", 49_152, 1, "prefill")
COGVIDEO_40S = InputShape("cogvideox_40s", 98_304, 1, "prefill")

DIT_SHAPES = {
    s.name: s for s in (FLUX_3K, FLUX_4K, COGVIDEO_20S, COGVIDEO_40S)
}
