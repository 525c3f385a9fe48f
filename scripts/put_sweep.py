#!/usr/bin/env python3
"""Sweep the tile plan of the put kernels K3/K4 (csrc/one_sided.cu) on one
NVIDIA GPU.

    python3 scripts/put_sweep.py [--plans 16384x4x2,8192x4x4,...]

Each plan TILExSTAGESxBLOCKS_PER_SM is built from a copy of
csrc/one_sided.cu with those three constants replaced (one nvcc per plan,
all started together), checked for bitwise delivery, and timed through the
port's own wrapper (``kernel_backend.remote_put``) at the serve-sp path's
two put shapes, K and V of 16 ranks at [2, 272, 3, 128] and [1, 80, 3, 128]
bf16, beside one ``Tensor.copy_`` of the same bytes.  Plans and copy_ take
turns over input sets that together touch four times the L2, so every call
reads from HBM.  A plan with the suffix "-noarrive" leaves the arrival
out (no signal word is set: an ablation that prices the signal protocol,
never a kernel to ship); "-gpuscope" release-stores the signal word at
``.gpu`` scope instead of ``.sys`` (prices the system scope, which a put
into another card's memory needs).  Prints one line per shape and plan.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import math
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402  (the timing helpers)

PLANS = ("16384x4x2,16384x4x2-noarrive,8192x4x2,8192x4x4,32768x3x2,"
         "16384x2x4,4096x4x8")


ARRIVAL = "if (need > 0 && landed[a] > 0) {"
SYS_STORE = "st.release.sys.global.u32"


def build_plan(plan: str) -> pathlib.Path:
    from repro_torch.kernels import _build

    sizes, _, ablation = plan.partition("-")
    src = (_build.CSRC / "one_sided.cu").read_text()
    for name, value in zip(("TILE", "STAGES", "BLOCKS_PER_SM"),
                           sizes.split("x")):
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {int(value)};", src)
        if n != 1:
            raise SystemExit(f"one_sided.cu has no single {name} constant")
    if ablation == "noarrive":
        if src.count(ARRIVAL) != 1:
            raise SystemExit("one_sided.cu: the arrival is not where expected")
        src = src.replace(ARRIVAL, "if (false) {")
    elif ablation == "gpuscope":
        if src.count(SYS_STORE) != 1:
            raise SystemExit("one_sided.cu: the signal store is not where "
                             "expected")
        src = src.replace(SYS_STORE, "st.release.gpu.global.u32")
    elif ablation:
        raise SystemExit(f"unknown ablation {ablation!r}")
    out = _build.BUILD_DIR / "put_sweep"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"one_sided_{plan}.cu"
    cu.write_text(src)
    lib = cu.with_suffix(".so")
    proc = subprocess.run(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
         str(lib), str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {cu.name}:\n{proc.stdout}")
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plans", default=PLANS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        cs.fail("CUDA is not available")
    from repro_torch.comm import kernel_backend as kb
    from repro_torch.kernels import _build

    card = cs.card_line()
    cs.log(card)
    plans = args.plans.split(",")
    with concurrent.futures.ThreadPoolExecutor(len(plans)) as pool:
        libs = dict(zip(plans, pool.map(build_plan, plans)))

    def use(plan) -> None:
        # the wrapper binds whatever library is loaded under this name
        _build._loaded["one_sided"] = ctypes.CDLL(str(libs[plan]))

    gen = torch.Generator(device="cuda").manual_seed(7)
    perm = [(r + 1) % cs.RANKS for r in range(cs.RANKS)]
    signal, arrive = cs.put_words(2 * cs.RANKS)
    for shape in (cs.SERVE_PUT_SHAPE, cs.SMALL_PUT_SHAPE):
        nbytes = 2 * cs.RANKS * 2 * math.prod(shape)
        n_sets = max(cs.ROTATE, -(-4 * cs.L2_BYTES // (2 * nbytes)))
        sets = []
        for _ in range(n_sets):
            src = [[torch.randn(shape, generator=gen, device="cuda")
                    .to(torch.bfloat16) for _ in range(2)]
                   for _ in range(cs.RANKS)]
            dst = [[torch.empty_like(t) for t in r] for r in src]
            flat = torch.cat([t.reshape(-1) for r in src for t in r])
            sets.append((src, dst, flat, torch.empty_like(flat)))
        bound_ms = 2 * nbytes / cs.HBM_BPS * 1e3
        copy = cs.rotating([lambda a=a, b=b: b.copy_(a) for *_, a, b in sets])
        copy_ms, plan_ms = [], {p: [] for p in plans}
        for turn in range(2):  # copy_, plans, plans reversed, copy_
            copy_ms.append(cs.cuda_ms(copy, reps=50))
            for plan in (plans if turn == 0 else plans[::-1]):
                use(plan)
                s0, d0 = sets[0][:2]
                for t in d0:
                    for x in t:
                        x.fill_(float("nan"))
                kb.remote_put(s0, d0, perm, signal=signal, arrive=arrive,
                              epoch=turn + 1)
                torch.cuda.synchronize()
                cs.judge_put(f"plan {plan}", s0, d0, perm, 0.0)
                if not plan.endswith("-noarrive"):
                    cs.judge_words(f"plan {plan}", signal, arrive, turn + 1)
                ms = cs.cuda_ms(cs.rotating(
                    [lambda s=s, d=d: kb.remote_put(
                        s, d, perm, signal=signal, arrive=arrive, epoch=9)
                     for s, d, *_ in sets]), reps=50)
                plan_ms[plan].append(ms)
        copy_ms.append(cs.cuda_ms(copy, reps=50))
        cs.log(f"shape 16 ranks x 2 x {shape} bf16, {nbytes} B, {n_sets} "
               f"sets: bound {bound_ms:.4f} ms, copy_ "
               f"{' / '.join(f'{m:.4f}' for m in copy_ms)} ms [{card}]")
        for plan, ms in plan_ms.items():
            cs.log(f"  remote_put plan {plan} (tile x stages x blocks per SM):"
                   f" {' / '.join(f'{m:.4f}' for m in ms)} ms, "
                   f"{bound_ms / min(ms):.3f} of the bound [{card}]")
        del sets
    return 0


if __name__ == "__main__":
    sys.exit(main())
