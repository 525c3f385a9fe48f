#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py    # every phase, one card

Phases, each fatal on failure (non-zero exit, no result line):

  1. card    — require CUDA, print the card's name and power limit
               (nvidia-smi), turn TF32 off for the float32 phases.
  2. build   — compile every CUDA source of the port with nvcc (one
               process per source, all started together) and print
               ptxas's report.
  3. k1      — the flash_mqkv kernel (K1) against its plain PyTorch
               version on the same card tensors: the CPU test shapes in
               float32 and bfloat16 (GQA, padding, causal/window, carried
               state, unfinalized output) and the flux-12b shapes, where
               the finalized o and the unfinalized (o', l, m) are held to
               limits on both the largest error and the error's norm.
  4. block   — one flux-12b DiT block at full width (d 3072, 24 x 128
               heads, d_ff 12288), perturbed weights, L = 1280, float32 on
               the card through K1, against the same block in float32 on
               the CPU through the plain path.
  5. serve   — DiTServer on flux-12b at full width and depth (96 layers,
               bfloat16, random weights from a seed with the zero-init
               tensors perturbed): two 4096-latent requests batched and one
               1024-latent request, 4 steps, no guidance.  Outputs must be
               finite and moved from their noise, and K1's launch count
               must equal 96 x steps x forwards.
  6. numbers — K1's time per call at the two flux shapes beside its bound,
               the plain version and scaled_dot_product_attention (a
               yardstick the port never calls).

The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}.  Kernels are built from this checkout into
build/repro_torch/ on first use.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s (data sheet)
HBM_BPS = 3.35e12  # H100 SXM HBM3 bytes/s
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # K1 vs plain, relative to max|ref|
# K1 vs plain at the flux shapes, bfloat16, per output:
# (max|d| / max|ref|, ||d|| / ||ref||), 2-10x the largest seen on an H100
# (o 5.2e-3 / 2.5e-3, o' 1.6e-3 / 1.6e-3, l 1.3e-6 / 5.2e-7, m 4.8e-7 /
# 1.6e-7); one dropped 64-key tile at L 4352 gives ~0.12 on o, 1.5e-2 on l
FLUX_TOL = {"o": (1e-2, 5e-3), "o'": (5e-3, 5e-3), "l": (1e-5, 5e-6),
            "m": (5e-6, 5e-6)}
BLOCK_TOL = 1e-4  # block, card vs CPU, relative to max|out|
FLUX_SHAPES = ((24, 1280), (48, 1280), (24, 4352), (48, 4352))  # (BH, L)
STEPS = 4  # sampler steps of the serve phase


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def _finite_pair(a, b):
    """a and b at the finite entries of b, or None unless the non-finite
    entries (-inf maxima of fully masked rows) agree exactly."""
    import torch
    a, b = a.float(), b.float()
    fin = torch.isfinite(b)
    if (not torch.equal(fin, torch.isfinite(a))
            or not torch.equal(a[~fin], b[~fin])):
        return None
    return a[fin], b[fin]


def rel_err(a, b, floor: float = 1.0) -> float:
    """max|a - b| / max(floor, max|b|) over finite entries (see
    _finite_pair; inf when the non-finite entries disagree)."""
    pair = _finite_pair(a, b)
    if pair is None:
        return float("inf")
    a, b = pair
    if b.numel() == 0:
        return 0.0
    return float((a - b).abs().max()) / max(floor, float(b.abs().max()))


def norm_err(a, b) -> float:
    """||a - b|| / ||b|| over finite entries: every entry counts, so a
    dropped KV tile or a swapped row shows however small each value is."""
    pair = _finite_pair(a, b)
    if pair is None:
        return float("inf")
    a, b = pair
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 3: K1 against its plain version
# ---------------------------------------------------------------------------

def k1_inputs(gen, bh, bhkv, lq, lk, d, dtype):
    import torch
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dtype)
    return mk(bh, lq, d), mk(bhkv, lk, d), mk(bhkv, lk, d)


def k1_cases():
    """(label, bh, bhkv, lq, lk, d, kwargs): the shape sweep and GQA groups
    of tests/test_torch_kernels.py, plus a ragged case whose edges the
    kernel must mask from bounds."""
    cases = []
    for (b, lq, lk, hq, hkv, d) in ((1, 16, 16, 1, 1, 16), (2, 64, 64, 4, 2, 32),
                                    (1, 128, 256, 8, 8, 64),
                                    (2, 48, 80, 6, 3, 128)):
        for causal, window in ((False, None), (True, None), (True, 20)):
            lk_ = lq if causal else lk
            cases.append((f"sweep{(b, lq, lk_, hq, hkv, d)} causal={causal} "
                          f"window={window}", b * hq, b * hkv, lq, lk_, d,
                          dict(group=hq // hkv, causal=causal,
                               window=window)))
    for g in (1, 2, 4):
        cases.append((f"gqa group={g}", 2 * 2 * g, 2 * 2, 32, 32, 32,
                      dict(group=g, causal=True)))
    cases.append(("ragged lq=37 lk=91 window=9", 6, 3, 37, 91, 64,
                  dict(group=2, causal=True, window=9)))
    return cases


def check_k1(results: dict) -> None:
    import torch
    from repro_torch.kernels import flash_mqkv as fm

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        tol = TOL[name]
        for label, bh, bhkv, lq, lk, d, kw in k1_cases():
            q, k, v = k1_inputs(gen, bh, bhkv, lq, lk, d, dtype)
            qp = torch.arange(lq, dtype=torch.int32, device="cuda")
            kp = torch.arange(lk, dtype=torch.int32, device="cuda")
            got = fm.flash_mqkv(q, k, v, qp, kp, **kw)
            ref = fm.flash_mqkv_plain(q, k, v, qp, kp, **kw)
            torch.cuda.synchronize()
            errs = [rel_err(got[0], ref[0]), rel_err(got[1], ref[1]),
                    rel_err(got[2], ref[2])]
            worst[name] = max(worst.get(name, 0.0), max(errs))
            if max(errs) > tol:
                fail(f"K1 {name} {label}: o/l/m err {errs} > {tol}")
        # padding: k_pos = -1 slots hold garbage that must not leak
        q, k, v = k1_inputs(gen, 4, 4, 16, 48, 32, dtype)
        qp = torch.arange(16, dtype=torch.int32, device="cuda")
        kp = torch.where(torch.arange(48, device="cuda") < 40,
                         torch.arange(48, device="cuda"), -1).to(torch.int32)
        k[:, 40:] = 999.0
        v[:, 40:] = 999.0
        pad = fm.flash_mqkv(q, k, v, qp, kp)[0]
        cut = fm.flash_mqkv(q, k[:, :40].contiguous(), v[:, :40].contiguous(),
                            qp, kp[:40].contiguous())[0]
        e = rel_err(pad, cut)
        if e > tol:
            fail(f"K1 {name} padding leak {e}")
        # carried state over two segments == one call; unfinalized triple
        q, k, v = k1_inputs(gen, 4, 2, 32, 64, 64, dtype)
        qp = torch.arange(32, dtype=torch.int32, device="cuda") + 32
        kp = torch.arange(64, dtype=torch.int32, device="cuda")
        kw = dict(group=2, causal=True)
        st = fm.flash_mqkv(q, k[:, :32].contiguous(), v[:, :32].contiguous(),
                           qp, kp[:32].contiguous(), finalize=False, **kw)
        st_ref = fm.flash_mqkv_plain(q, k[:, :32], v[:, :32], qp, kp[:32],
                                     finalize=False, **kw)
        two = fm.flash_mqkv(q, k[:, 32:].contiguous(), v[:, 32:].contiguous(),
                            qp, kp[32:].contiguous(), state=st, **kw)[0]
        one = fm.flash_mqkv_plain(q, k, v, qp, kp, **kw)[0]
        errs = [rel_err(a, b) for a, b in zip(st, st_ref)] + [rel_err(two, one)]
        if max(errs) > tol:
            fail(f"K1 {name} state carry / unfinalized errs {errs}")
        # rows with no visible key: o = 0, l = 0, m = -inf
        q, k, v = k1_inputs(gen, 2, 2, 16, 16, 16, dtype)
        future = torch.arange(16, dtype=torch.int32, device="cuda") + 100
        o, l, m = fm.flash_mqkv(q, k, v, future - 100, future, causal=True,
                                finalize=False)
        if not (bool((o == 0).all()) and bool((l == 0).all())
                and bool(torch.isneginf(m).all())):
            fail(f"K1 {name} fully masked rows are not (0, 0, -inf)")
        log(f"k1 {name}: {len(k1_cases())} sweep cases + padding + state "
            f"carry + masked rows OK, worst rel err {worst[name]:.3e} "
            f"(tol {tol})")
    # the flux-12b shapes of the main path, bfloat16: the finalized output
    # the server uses and the unfinalized (o', l, m) state
    for bh, l in FLUX_SHAPES:
        q, k, v = k1_inputs(gen, bh, bh, l, l, 128, torch.bfloat16)
        pos = torch.arange(l, dtype=torch.int32, device="cuda")
        got = fm.flash_mqkv(q, k, v, pos, pos)[0]
        ref = fm.flash_mqkv_plain(q, k, v, pos, pos)[0]
        errs = {"o": (rel_err(got, ref, floor=0.0), norm_err(got, ref))}
        results.setdefault("flux_err", {})[(bh, l)] = float(
            (got.float() - ref.float()).abs().max())
        del got, ref
        got = fm.flash_mqkv(q, k, v, pos, pos, finalize=False)
        ref = fm.flash_mqkv_plain(q, k, v, pos, pos, finalize=False)
        for name, a, b in zip(("o'", "l", "m"), got, ref):
            errs[name] = (rel_err(a, b, floor=0.0), norm_err(a, b))
        log(f"k1 flux BH={bh} L={l} D=128 bf16: max abs err of o "
            f"{results['flux_err'][(bh, l)]:.3e}; max|d|/max|ref|, "
            f"|d|/|ref| per output: "
            + ", ".join(f"{n} {e[0]:.2e} {e[1]:.2e}" for n, e in errs.items()))
        for name, (e_max, e_norm) in errs.items():
            lim_max, lim_norm = FLUX_TOL[name]
            if not (e_max <= lim_max and e_norm <= lim_norm):
                fail(f"K1 flux shape BH={bh} L={l} {name}: max err "
                     f"{e_max} (limit {lim_max}), norm err {e_norm} "
                     f"(limit {lim_norm})")
        del q, k, v, got, ref
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 4 and 5: the model
# ---------------------------------------------------------------------------

def perturb_zero_init(params, gen, scale: float = 1.0) -> None:
    """Replace the adaLN-zero and output-projection zeros with fan-in
    normals, so attention reaches the output (a fresh DiT is the
    identity)."""
    import torch

    def fill(p):
        w = p["w"]
        p["w"] = (torch.randn(w.shape, generator=gen, device=w.device,
                              dtype=w.dtype) * (scale * w.shape[0] ** -0.5))

    for lp in params["layers"]:
        fill(lp["ada"])
    if "ada_f" in params:
        fill(params["ada_f"])
        fill(params["proj_out"])


def check_block() -> None:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import SPConfig
    from repro_torch.kernels import flash_mqkv as fm
    from repro_torch.models.blocks import ParallelContext
    from repro_torch.models.dit import dit_block, init_dit

    cfg = dataclasses.replace(get_config("flux-12b"), n_layers=1,
                              dtype="float32")
    gen = torch.Generator().manual_seed(1)
    params = init_dit(cfg, gen, device="cpu")
    perturb_zero_init(params, gen)
    lp = params["layers"][0]
    l = 1280
    x = torch.randn((1, l, cfg.d_model), generator=gen)
    t_emb = torch.randn((1, cfg.d_model), generator=gen)
    pos = torch.arange(l)[None]
    sp = SPConfig(strategy="full")
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref = dit_block(lp, cfg, ParallelContext(sp, device=torch.device("cpu")),
                        x, t_emb, pos)
    t_cpu = time.perf_counter() - t0
    dev = torch.device("cuda")
    lp_d = {k: ({kk: ({k3: t.to(dev) for k3, t in vv.items()}
                      if isinstance(vv, dict) else vv.to(dev))
                 for kk, vv in v.items()}) for k, v in lp.items()}
    before = fm.launch_count()
    with torch.inference_mode():
        out = dit_block(lp_d, cfg, ParallelContext(sp, device=dev),
                        x.to(dev), t_emb.to(dev), pos.to(dev))
    torch.cuda.synchronize()
    launches = fm.launch_count() - before
    e = float((out.cpu() - ref).abs().max()) / float(ref.abs().max())
    attn_share = float((ref - x).abs().max())
    log(f"block flux-12b d={cfg.d_model} L={l} fp32: card vs CPU max|d|/max|ref| = "
        f"{e:.3e} (tol {BLOCK_TOL}), K1 launches {launches}, max|block-x| "
        f"{attn_share:.3f}, CPU block {t_cpu:.2f} s")
    if launches != 1 or not e <= BLOCK_TOL:
        fail(f"block: err {e} launches {launches}")


def serve(results: dict, card: str) -> None:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import SPConfig
    from repro_torch.kernels import flash_mqkv as fm
    from repro_torch.models import init_dit
    from repro_torch.serving import (DiTRequest, DiTServer, RecordingTracker,
                                     SamplerConfig)

    cfg = get_config("flux-12b")
    steps = STEPS
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = init_dit(cfg, gen, device="cuda")
    perturb_zero_init(params, gen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"serve: flux-12b {cfg.n_layers} layers d={cfg.d_model} bf16, "
        f"{n_params / 1e9:.3f} B params, init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    tracker = RecordingTracker()
    srv = DiTServer(params, cfg, SPConfig(strategy="full"),
                    sampler=SamplerConfig(num_steps=steps), max_batch=4,
                    tracker=tracker)
    conds = {}
    for rid, seq in ((0, 4096), (1, 4096), (2, 1024)):
        conds[rid] = torch.randn((256, cfg.d_model), generator=gen,
                                 device="cuda").to(torch.bfloat16)
        srv.submit(DiTRequest(rid=rid, seq_len=seq, cond=conds[rid]))
    torch.cuda.reset_peak_memory_stats()
    fm.reset_launch_count()
    t0 = time.perf_counter()
    out = srv.serve()
    wall = time.perf_counter() - t0
    launches = fm.launch_count()
    # one unguided forward per step per admitted batch
    forwards = srv.scheduler.admissions
    expect = cfg.n_layers * steps * forwards
    log(f"serve: {len(out)} requests in {wall:.2f} s, K1 launches {launches} "
        f"(expected {cfg.n_layers} layers x {steps} steps x {forwards} "
        f"forwards = {expect}), peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    if sorted(r.rid for r in out) != [0, 1, 2]:
        fail(f"served rids {[r.rid for r in out]}")
    if launches != expect:
        fail(f"K1 launches {launches} != {expect}")
    for r in out:
        seq = 4096 if r.rid < 2 else 1024
        noise = srv._noise([DiTRequest(rid=r.rid, seq_len=seq)], 1, seq)[0]
        moved = float((r.latents.float() - noise.float()).abs().max())
        finite = bool(torch.isfinite(r.latents).all())
        log(f"serve rid={r.rid} seq={seq}: shape {tuple(r.latents.shape)} "
            f"finite={finite} max|x-noise|={moved:.3f} latency "
            f"{r.latency:.2f} s step times "
            f"{[round(s, 4) for s in r.step_times]} [{card}]")
        if tuple(r.latents.shape) != (seq, 64) or not finite or moved == 0.0:
            fail(f"serve rid {r.rid}: bad result")
        results.setdefault("step_times", {})[seq] = r.step_times
    results["launches"] = launches
    del srv, params, out
    torch.cuda.empty_cache()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# phase 6: numbers
# ---------------------------------------------------------------------------

def k1_numbers(card: str) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_mqkv as fm

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = {}
    for bh, l in FLUX_SHAPES:
        q, k, v = k1_inputs(gen, bh, bh, l, l, 128, torch.bfloat16)
        pos = torch.arange(l, dtype=torch.int32, device="cuda")
        ms = cuda_ms(lambda: fm.flash_mqkv(q, k, v, pos, pos), reps=20)
        plain_ms = cuda_ms(lambda: fm.flash_mqkv_plain(q, k, v, pos, pos),
                           reps=3, warmup=1)
        b = bh // 24
        q4, k4, v4 = (t.view(b, 24, l, 128) for t in (q, k, v))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4),
                         reps=20)
        flops = 4.0 * bh * l * l * 128
        nbytes = 4.0 * bh * l * 128 * 2  # q, k, v read once, o written once
        t_ops, t_bytes = flops / PEAK_BF16, nbytes / HBM_BPS
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        bound_ms = max(t_ops, t_bytes) * 1e3
        rows[(bh, l)] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
        log(f"k1 time BH={bh} L={l} D=128 bf16: {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s), bound {bound_ms:.4f} ms "
            f"({bound_by}), plain {plain_ms:.3f} ms, sdpa {lib_ms:.4f} ms "
            f"[{card}]")
        del q, k, v
    torch.cuda.empty_cache()
    return rows


def main() -> int:
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    from repro_torch.kernels import _build

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    rep = _build.build("flash_mqkv")
    log(f"build flash_mqkv: {rep['seconds']:.1f} s -> {rep['path']}")
    for line in rep["log"].splitlines():
        if any(w in line for w in ("Compiling entry", "Used", "spill")):
            log(f"  {line.strip()}")
    log(f"build total {time.perf_counter() - t0:.1f} s")

    results: dict = {}
    check_k1(results)
    check_block()
    serve(results, card)
    numbers = k1_numbers(card)

    main_shape = (48, 4352)
    row = numbers[main_shape]
    kernels = [{
        "name": "flash_mqkv",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_mqkv.cu",
        "replaces": "src/repro/kernels/flash_mqkv.py:104",
        "launches": results["launches"],
        "max_abs_err": results["flux_err"][main_shape],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
    }]
    log(json.dumps({"kernels": kernels}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
