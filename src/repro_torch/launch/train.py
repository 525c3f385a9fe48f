"""Training launcher of the port (the counterpart of
``src/repro/launch/train.py``), on the card unless ``--device cpu`` asks
for the CPU:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --steps 5 --seq 1024 --batch 4 [--ckpt out/ck]
    ... --arch qwen2-1.5b --reduced --device cpu          (on the CPU)
    ... --mesh host --data 2 --model 4 [--strategy usp]   (over a mesh)

The flags are the reference's, plus ``--device``, ``--remat`` (the
activation-checkpoint policy: full, dots or none) and ``--log-every``
(the reference logs every 10th step).  ``--reduced`` trains
the reduced config in float32, as the reference's.  Every family
trains (the LMs: dense, vlm, rwkv6, hybrid, moe; whisper; the DiTs) at
SP degree 1 on one device, and over a mesh of virtual ranks on the one
device with ``--model`` or ``--data`` above 1 or the ``pod`` /
``multipod`` meshes (launch/mesh.py ``launch_mesh``: ``pod`` is (pod 2,
model 8), SP over both axes; ``--strategy`` picks the SP schedule, run
through the put kernels; the moe family's experts split over 'model').
It prints the mesh and its (P_u x P_r) plan, the reference's
line per logged step, then one line with the median step time (host
clock, the device synchronised at each step's end), tokens per second and
the peak device memory, and on CUDA one line with the launches per step
of the attention kernel K1 and of its gradient K1b, and of the WKV kernel
K5 and of its gradient K5b, and over a mesh one with those of K2 and the
put kernels K3 and K4.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import sys

import torch

from ..comm import kernel_backend as kb
from ..configs import get_config, get_reduced
from ..configs.shapes import SHAPES, InputShape
from ..core import SPConfig, resolve_layout
from ..kernels import flash_mqkv as fm
from ..kernels import ring_flash as rf
from ..kernels.rwkv6_wkv import (bwd_launch_count as k5b_count,
                                 launch_count as k5_count,
                                 reset_bwd_launch_count as reset_k5b,
                                 reset_launch_count as reset_k5)
from ..models.blocks import REMAT_POLICIES
from ..train import AdamWConfig, Trainer
from .mesh import launch_mesh


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None, help="assigned shape name")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--strategy", default="swift_torus")
    ap.add_argument("--mesh", choices=["pod", "multipod", "host"],
                    default="host")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--remat", choices=REMAT_POLICIES, default="full")
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg, dtype="float32", sharding_overrides=())
    shape = (SHAPES[args.shape] if args.shape
             else InputShape("cli", args.seq, args.batch, "training"))
    mesh = None
    sp = SPConfig(strategy="full", sp_axes=("model",), batch_axes=("data",))
    if args.mesh != "host" or args.model > 1 or args.data > 1:
        mesh, sp = launch_mesh(args.mesh, args.model, args.data,
                               args.strategy, args.device)
        plan = (resolve_layout(sp, mesh, cfg.n_heads, cfg.n_kv_heads)
                if sp.strategy != "full" else None)
        print(f"mesh: {dict(mesh.shape)} of virtual ranks on {mesh.device}, "
              f"SP over {sp.sp_axes}: {sp.strategy}"
              + (f", P_u {plan.p_ulysses} x P_r {plan.p_ring}" if plan
                 else ""))
    tr = Trainer(cfg, mesh, sp, shape,
                 opt_cfg=AdamWConfig(total_steps=args.steps),
                 ckpt_path=args.ckpt, device=args.device, remat=args.remat)
    cuda = torch.cuda.is_available() and args.device in (None, "cuda")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for reset in (fm.reset_launch_count, fm.reset_bwd_launch_count, reset_k5,
                  reset_k5b, rf.reset_launch_count, kb.reset_launch_count):
        reset()
    tr.run(args.steps, log_every=args.log_every)
    # the first step builds the kernels: the median of the rest
    times = tr.step_seconds[1:] or tr.step_seconds
    step_s = statistics.median(times)
    tokens = shape.global_batch * shape.seq_len
    peak = (f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB" if cuda
            else "not measured (cpu)")
    print(f"train: {cfg.arch_id} {tr.device}, median step {step_s * 1e3:.1f} "
          f"ms over {len(times)} steps (first step {tr.step_seconds[0]:.2f} "
          f"s), {tokens / step_s:.0f} tokens/s, peak memory {peak}")
    if cuda:
        per = lambda n: f"{n / args.steps:g}"
        print(f"kernels: flash_mqkv {per(fm.launch_count())} and "
              f"flash_mqkv_bwd {per(fm.bwd_launch_count())}, rwkv6_wkv "
              f"{per(k5_count())} and rwkv6_wkv_bwd "
              f"{per(k5b_count())} launches per step")
        if mesh is not None:
            print(f"kernels over the mesh: ring_flash_step "
                  f"{per(rf.launch_count())}, remote_put "
                  f"{per(kb.launch_count('remote_put'))} and landing_copy "
                  f"{per(kb.launch_count('landing_copy'))} launches per step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
