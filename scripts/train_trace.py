#!/usr/bin/env python3
"""Where one training step's time goes, for the families trained since
the rwkv6/hybrid/moe slice, on one NVIDIA GPU.

    python3 scripts/train_trace.py [CELL ...]     # default: every cell

For rwkv6-1.6b (24 layers) and hymba-1.5b (32 layers) at full width and
depth, qwen2-moe-a2.7b at full width and 4 of its 24 layers (the
train-moe cell of chip_smoke.py), and qwen2-1.5b (28 layers) over the
virtual mesh (pod 2, model 2) under swift_torus (the train-sp cell,
``qwen2-sp``), bf16, B 4 x L 1024, remat "full": one step after two warm
ones on the host clock, one traced by torch.profiler (device busy ms,
idle share, the device ms of K1 (and K2), K1b, K5, K5b, K3/K4, the
GEMMs, the top kernels), then AdamW alone (CUDA events), through
chip_smoke.py's train_breakdown.  Prints the card's name and power limit
first.
"""
from __future__ import annotations

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
# name: (arch, layers or None for all, virtual mesh or None)
CELLS = {"rwkv6": ("rwkv6-1.6b", None, None),
         "hymba": ("hymba-1.5b", None, None),
         "moe": ("qwen2-moe-a2.7b", 4, None),
         "qwen2-sp": ("qwen2-1.5b", None, ((2, 2), ("pod", "model")))}


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke

    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 1
    names = sys.argv[1:] or list(CELLS)
    unknown = [n for n in names if n not in CELLS]
    if unknown:
        print(f"unknown cells {unknown}; choose from {list(CELLS)}",
              file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    print(card, flush=True)
    for name in names:
        chip_smoke.train_breakdown(card, *CELLS[name])
    return 0


if __name__ == "__main__":
    sys.exit(main())
