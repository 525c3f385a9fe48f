#!/usr/bin/env python3
"""Where one training step's time goes, for the families trained since
the rwkv6/hybrid/moe slice, on one NVIDIA GPU.

    python3 scripts/train_trace.py

For rwkv6-1.6b (24 layers) and hymba-1.5b (32 layers) at full width and
depth, and qwen2-moe-a2.7b at full width and 4 of its 24 layers (the
train-moe cell of chip_smoke.py), bf16, B 4 x L 1024, remat "full": one
step after two warm ones on the host clock, one traced by
torch.profiler (device busy ms, idle share, the device ms of K1, K1b,
K5, K5b, the GEMMs, the top kernels), then AdamW alone (CUDA events),
through chip_smoke.py's train_breakdown.  Prints the card's name and
power limit first.
"""
from __future__ import annotations

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
# (arch, layers or None for all)
CELLS = (("rwkv6-1.6b", None), ("hymba-1.5b", None), ("qwen2-moe-a2.7b", 4))


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke

    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    print(card, flush=True)
    for arch, layers in CELLS:
        chip_smoke.train_breakdown(card, arch, layers)
    return 0


if __name__ == "__main__":
    sys.exit(main())
