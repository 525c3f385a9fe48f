#!/usr/bin/env python3
"""Time the RWKV6 WKV kernel K5 (csrc/rwkv6_wkv.cu) of one or more
checkouts of the port, in turns, on one NVIDIA GPU.

    python3 scripts/wkv_bench.py [TREE ...]

Each TREE is the root of a checkout (default: this one); naming the same
tree twice times it twice, so ``A B B A`` compares two trees in turns on
one card.  Each turn runs in its own process, which builds that tree's
kernels into its own build/ directory, holds K5 against the tree's plain
version at each shape, and times K5 through the model's entry point
(``rwkv6_wkv_heads``) at the rwkv6-1.6b prefill shapes B 4 x L 4096 and
B 1 x L 1024 (H 32, N 64, chunk 64; r, k, v, u bfloat16, w float32 in
RWKV6's decay range), over input sets that together exceed the L2 so that
every call reads from HBM.  Prints the card's name and power limit, then
one line per turn and shape.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = ((4, 4096), (1, 1024))  # (B, L) of the rwkv6-1.6b prefill


def worker(tree: pathlib.Path) -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # the timing helpers
    sys.path.insert(0, str(tree / "src"))
    import importlib

    import torch
    wkv = importlib.import_module("repro_torch.kernels.rwkv6_wkv")
    assert pathlib.Path(wkv.__file__).is_relative_to(tree), wkv.__file__
    h, n = 32, 64
    gen = torch.Generator(device="cuda").manual_seed(14)
    for b, l in SHAPES:
        one = b * l * h * n * (3 * 2 + 4)  # bytes of r, k, v, w
        sets = []
        for _ in range(max(2, -(-4 * cs.L2_BYTES // one))):
            mk = lambda: torch.randn((b, l, h, n), generator=gen,
                                     device="cuda").to(torch.bfloat16)
            sets.append((mk(), mk(), mk(),
                         cs.rwkv_decays(gen, (b, l, h, n), "cuda"),
                         (torch.randn((h, n), generator=gen, device="cuda")
                          * 0.5).to(torch.bfloat16)))
        got = wkv.rwkv6_wkv_heads(*sets[0])
        want = wkv.rwkv6_wkv_heads_plain(*sets[0])
        err = cs.rel_err(got, want, floor=0.0)
        del got, want
        ms, _ = cs.time_call(cs.rotating(
            [lambda a=a: wkv.rwkv6_wkv_heads(*a) for a in sets]), reps=30)
        print(json.dumps({"tree": str(tree), "b": b, "l": l, "ms": ms,
                          "sets": len(sets), "max_rel_err": err}), flush=True)
        del sets
        torch.cuda.empty_cache()


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--worker":
        worker(pathlib.Path(sys.argv[2]).resolve())
        return 0
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch
    if not torch.cuda.is_available():
        cs.fail("CUDA is not available")
    print(cs.card_line(), flush=True)
    trees = [pathlib.Path(t).resolve() for t in sys.argv[1:]] or [ROOT]
    for tree in trees:
        if not (tree / "src" / "repro_torch" / "csrc" / "rwkv6_wkv.cu").is_file():
            cs.fail(f"{tree} holds no csrc/rwkv6_wkv.cu")
        proc = subprocess.run([sys.executable, __file__, "--worker", str(tree)],
                              capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                r = json.loads(line)
                print(f"K5 {tree.name} B={r['b']} L={r['l']}: {r['ms']:.4f} ms "
                      f"({r['sets']} input sets), max|d|/max|ref| "
                      f"{r['max_rel_err']:.2e}", flush=True)
        if proc.returncode != 0:
            cs.fail(f"{tree}: {proc.stderr[-3000:]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
