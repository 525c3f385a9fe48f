#!/usr/bin/env python3
"""Where the WKV kernel K5 (csrc/rwkv6_wkv.cu), or with ``--bwd`` its
gradient K5b (csrc/rwkv6_wkv_bwd.cu), spends its clocks, phase by phase, on
one NVIDIA GPU.

    python3 scripts/wkv_phases.py [--bwd]

Builds the kernel with its phase probes compiled in (-DK5_PROBES: lane 0
of every warp adds clock64() deltas per phase of the chunk loop into a
device array, summed over blocks), runs it through the model's entry
point at the rwkv6-1.6b prefill shapes B 4 x L 4096 and B 1 x L 1024 (H
32, N 64, chunk 64; r, k, v, u bfloat16, w float32), and prints, per warp
role, the mean SM clocks per block and chunk in each phase, beside the
probed and the plain build's time per call.  The probes cost time
themselves: read the phases as shares, not as the plain build's clocks.

``--bwd`` builds K5b with -DK5B_PROBES and runs it at rwkv6-1.6b's
training shape (B 4 x L 1024, H 32, N 64, chunk 64; r, k, v, u bfloat16,
w and dO float32): per warp, the mean SM clocks per block and chunk of its
states' launch and per block of its chunk gradients', each phase ending at
a barrier (the phases are named in the source beside K5B_PROBES).
"""
from __future__ import annotations

import ctypes
import importlib
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402  (the timing helpers)

SHAPES = ((4, 4096), (1, 1024))  # (B, L)
PHASES = ("wait for the stage", "decays + operands", "operands barrier",
          "products", "S barrier + stores")
BWD_PHASES = (("store", "commit + fetch", "decays", "increment"),
              ("loads", "row sums", "decays", "S_in load", "products",
               "S_in.dS rows + wait", "dr_sc/dk_sc/log w", "scans",
               "dr/dk/dw"))


def build_probed(name: str = "rwkv6_wkv",
                 flag: str = "-DK5_PROBES") -> pathlib.Path:
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR / "wkv_phases"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"lib{name}_probes.so"
    proc = subprocess.run(
        [_build.nvcc(), *_build.NVCC_FLAGS, flag, "-o", str(lib),
         str(_build.CSRC / f"{name}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {name}.cu {flag}:\n{proc.stdout}")
    return lib


def bwd_phases(card: str) -> int:
    """K5b's phases at the training shape (see the module's docstring)."""
    import torch
    from repro_torch.kernels import _build
    wkv = importlib.import_module("repro_torch.kernels.rwkv6_wkv")
    plain = wkv._bound_bwd_library()
    probed = ctypes.CDLL(str(build_probed("rwkv6_wkv_bwd", "-DK5B_PROBES")))
    probed.rwkv6_wkv_bwd_probes.argtypes = [ctypes.c_void_p]
    label, b, l, h, n = cs.K5B_CASES[0]
    c, warps, probes = 64, 8, 9
    gen = torch.Generator(device="cuda").manual_seed(17)
    args = cs.k5b_inputs(gen, b, l, h, n, torch.bfloat16)
    times = {}
    for name, lib in (("plain build", plain), ("probed build", probed)):
        _build._loaded["rwkv6_wkv_bwd"] = lib
        wkv._bound_bwd_library()  # binds the argument types
        times[name] = cs.cuda_ms(lambda: wkv.rwkv6_wkv_heads_bwd(*args),
                                 reps=20)
    sums = (ctypes.c_ulonglong * (2 * warps * probes))()
    probed.rwkv6_wkv_bwd_probes(ctypes.addressof(sums))  # reset
    reps = 5
    _build._loaded["rwkv6_wkv_bwd"] = probed
    for _ in range(reps):
        wkv.rwkv6_wkv_heads_bwd(*args)
    torch.cuda.synchronize()
    probed.rwkv6_wkv_bwd_probes(ctypes.addressof(sums))
    _build._loaded["rwkv6_wkv_bwd"] = plain
    plan = wkv.k5b_plan(b, h, l, n, c,
                        torch.cuda.get_device_properties(0).multi_processor_count)
    nc = l // c
    cs.log(f"K5b phases {label} B={b} L={l} H={h} N={n} chunk {c} (bf16 "
           f"r/k/v/u; split {plan['split']}): plain build "
           f"{times['plain build']:.4f} ms, probed "
           f"{times['probed build']:.4f} ms per call [{card}]")
    for kernel, (what, per, nw) in enumerate((
            ("states: mean SM clocks per block and chunk",
             reps * b * h * plan["split"] * 2 * (nc - 1), 8),
            ("chunk gradients: mean SM clocks per block",
             reps * b * h * nc, 6))):
        cs.log(f"  {what}:")
        for w in range(nw):
            row = [sums[(kernel * warps + w) * probes + p] / per
                   for p in range(len(BWD_PHASES[kernel]))]
            cs.log(f"    warp {w} total {sum(row):9.0f}: " + ", ".join(
                f"{nm} {v:.0f}" for nm, v in zip(BWD_PHASES[kernel], row)))
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        cs.fail("CUDA is not available")
    from repro_torch.kernels import _build
    wkv = importlib.import_module("repro_torch.kernels.rwkv6_wkv")
    card = cs.card_line()
    cs.log(card)
    if "--bwd" in sys.argv[1:]:
        return bwd_phases(card)
    consts = cs.source_constants("rwkv6_wkv")
    warps, owarps, probes = consts["WARPS"], consts["OWARPS"], consts["PROBES"]
    plain = wkv._bound_library()
    probed = ctypes.CDLL(str(build_probed()))
    probed.rwkv6_wkv_probes.argtypes = [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    h, n, c = 32, 64, 64
    gen = torch.Generator(device="cuda").manual_seed(16)
    for b, l in SHAPES:
        mk = lambda: torch.randn((b, l, h, n), generator=gen,
                                 device="cuda").to(torch.bfloat16)
        args = (mk(), mk(), mk(), cs.rwkv_decays(gen, (b, l, h, n), "cuda"),
                (torch.randn((h, n), generator=gen, device="cuda") * 0.5
                 ).to(torch.bfloat16))
        times = {}
        for name, lib in (("plain build", plain), ("probed build", probed)):
            _build._loaded["rwkv6_wkv"] = lib
            wkv._bound_library()  # binds the argument types
            times[name] = cs.cuda_ms(lambda: wkv.rwkv6_wkv_heads(*args), reps=20)
        sums = (ctypes.c_ulonglong * (warps * probes))()
        probed.rwkv6_wkv_probes(ctypes.addressof(sums))  # reset
        reps = 5
        _build._loaded["rwkv6_wkv"] = probed
        for _ in range(reps):
            wkv.rwkv6_wkv_heads(*args)
        torch.cuda.synchronize()
        probed.rwkv6_wkv_probes(ctypes.addressof(sums))
        _build._loaded["rwkv6_wkv"] = plain
        split = wkv.value_split(b * h, n, sms)
        per = reps * b * h * split * (l // c)  # block-chunks
        cs.log(f"K5 phases B={b} L={l} (split {split}): plain build "
               f"{times['plain build']:.4f} ms, probed {times['probed build']:.4f}"
               f" ms per call [{card}]; mean SM clocks per block and chunk:")
        for w in range(warps):
            row = [sums[w * probes + p] / per for p in range(probes)]
            role = f"o warp {w}" if w < owarps else f"S warp {w - owarps}"
            cs.log(f"  {role:10s} total {sum(row):9.0f}: " + ", ".join(
                f"{nm} {v:.0f}" for nm, v in zip(PHASES, row)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
