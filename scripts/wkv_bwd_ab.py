#!/usr/bin/env python3
"""K5b (csrc/rwkv6_wkv_bwd.cu) built from several source files, timed in
turns on one NVIDIA GPU.

    python3 scripts/wkv_bwd_ab.py A.cu B.cu [--order 0,1,1,0]

Each file is a whole rwkv6_wkv_bwd.cu with the same C interface (say, the
checkout's and an edited copy); they compile in parallel with the
checkout's flags and headers.  In the given order of their indices (by
default 0, 1, ..., then back), each is loaded in place of the checkout's
library and run through the wrapper at rwkv6-1.6b's training shape (B 4 x
L 1024, H 32, N 64, chunk 64): its largest error against the plain
version in float32 (of max|ref|), its time per call with the model's
dtypes on two input sets in turns (CUDA events), and each launch's device
time (torch.profiler).  Compare two builds only within one run.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import importlib
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402  (the timing helpers)

LAUNCH = re.compile(r"wkv_bwd_\w+")  # K5b's entries as the profiler names them


def build(src: pathlib.Path, i: int) -> pathlib.Path:
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR / "wkv_bwd_ab"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"librwkv6_wkv_bwd_{i}.so"
    proc = subprocess.run(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
         str(lib), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {src}:\n{proc.stdout}")
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("sources", nargs="+", type=pathlib.Path)
    ap.add_argument("--order", default=None,
                    help="indices of the sources, comma-separated")
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        cs.fail("CUDA is not available")
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    wkv = importlib.import_module("repro_torch.kernels.rwkv6_wkv")
    card = cs.card_line()
    cs.log(card)
    n = len(args.sources)
    with concurrent.futures.ThreadPoolExecutor(n) as pool:
        libs = [ctypes.CDLL(str(p)) for p in
                pool.map(build, args.sources, range(n))]
    order = ([int(x) for x in args.order.split(",")] if args.order
             else list(range(n)) + list(range(n))[::-1])
    label, b, l, h, n_ = cs.K5B_CASES[0]
    gen = torch.Generator(device="cuda").manual_seed(15)
    sets = [cs.k5b_inputs(gen, b, l, h, n_, torch.bfloat16)
            for _ in range(cs.K5B_SETS)]
    f32 = cs.k5b_inputs(gen, b, l, h, n_, torch.float32)
    want = wkv.rwkv6_wkv_heads_bwd_plain(*f32)
    for i in order:
        _build._loaded["rwkv6_wkv_bwd"] = libs[i]
        wkv._bound_bwd_library()  # binds the argument types
        err = max(cs.rel_err(g, w, floor=0.0)
                  for g, w in zip(wkv.rwkv6_wkv_heads_bwd(*f32), want))
        ms = cs.cuda_ms(cs.rotating([lambda a=a: wkv.rwkv6_wkv_heads_bwd(*a)
                                     for a in sets]), reps=20)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for j in range(4):
                wkv.rwkv6_wkv_heads_bwd(*sets[j % len(sets)])
            torch.cuda.synchronize()
        launches = ", ".join(
            f"{LAUNCH.search(e.key).group(0)} "
            f"{e.self_device_time_total / e.count / 1e3:.4f}"
            for e in prof.key_averages()
            if "wkv_bwd_" in e.key and e.self_device_time_total > 0)
        cs.log(f"{args.sources[i].name} ({i}): {ms:.4f} ms a call at {label} "
               f"B={b} L={l} H={h} N={n_} (bf16 r/k/v/u); float32 error "
               f"{err:.2e} of max|ref|; launches (ms): {launches} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
