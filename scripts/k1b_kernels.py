#!/usr/bin/env python3
"""Device time of each kernel of one K1b call (flash_mqkv_bwd, bf16), as
torch.profiler sees it, on one NVIDIA GPU.

    python3 scripts/k1b_kernels.py

At the qwen2-1.5b training shape (BH 48, 8 KV heads, L 1024, D 128,
causal), whisper-tiny's cross-attention (BH 24, Lq 448, Lk 1536, D 64)
and flux-12b's square (BH 24, L 4352, D 128), each from seeded inputs and
K1's forward on them: the tile plan (kernels/flash_mqkv.py:
bwd_tile_plan) and, over ten calls after three warm ones, the mean device
microseconds of each launch of the bf16 body (Δ, bounds, dK/dV, the
split sum, dQ).  Prints the card's name and power limit first.
"""
from __future__ import annotations

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
# (label, BH, BHkv, Lq, Lk, D, causal)
SHAPES = (("qwen2-train", 48, 8, 1024, 1024, 128, True),
          ("whisper-cross", 24, 24, 448, 1536, 64, False),
          ("flux", 24, 24, 4352, 4352, 128, False))
CALLS = 10


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import flash_mqkv as fm

    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda")
    for label, bh, bhkv, lq, lk, d, causal in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(0)
        mk = lambda *s: torch.randn(s, generator=gen, device=dev).to(
            torch.bfloat16)
        q, k, v, do = mk(bh, lq, d), mk(bhkv, lk, d), mk(bhkv, lk, d), \
            mk(bh, lq, d)
        q_pos = torch.arange(lk - lq, lk, dtype=torch.int32, device=dev)
        k_pos = torch.arange(lk, dtype=torch.int32, device=dev)
        kw = dict(group=bh // bhkv, scale=d ** -0.5, causal=causal,
                  window=None)
        o, l, m = fm.flash_mqkv(q, k, v, q_pos, k_pos, **kw)
        args = (q, k, v, o, do, m, l, q_pos, k_pos)
        for _ in range(3):
            fm.flash_mqkv_bwd(*args, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fm.flash_mqkv_bwd(*args, **kw)
            torch.cuda.synchronize()
        plan = fm.bwd_tile_plan(bh, bh // bhkv, lq, lk, d, causal)
        print(f"{label}: BH={bh}/{bhkv} Lq={lq} Lk={lk} D={d} "
              f"causal={causal}, {plan}")
        total = 0.0
        for e in prof.key_averages():
            if e.self_device_time_total > 0:
                us = e.self_device_time_total / e.count
                total += us * e.count / CALLS
                name = re.search(r"::(\w+(?:<[^>]*>)?)\(", e.key)
                print(f"  {name.group(1) if name else e.key[:60]} x{e.count}: "
                      f"{us:.1f} us")
        print(f"  per call: {total:.1f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
