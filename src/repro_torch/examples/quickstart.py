"""Quickstart: SwiftFusion SP attention on a mesh of virtual ranks.

Runs every SP strategy on a small attention problem over the mesh (pod 2,
data 2, model 2) of virtual ranks on one device and checks each against
the single-device oracle, then shows the paper's planner picking (P_u,
P_r) for real architectures.  The schedules' puts go through the put
kernels (K3 on a single-axis route, K4 on this mesh's two SP axes) and
the ring steps through K2:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from ..core import MaskSpec, SPConfig, plan, reference_attention, sp_attention
from ..launch.mesh import make_mesh

STRATEGIES = ("ring", "ulysses", "usp", "swift", "swift_torus")


def problem() -> dict:
    """The attention problem: [B, L, H, D] with GQA (8 query heads over 4
    KV heads), float32."""
    return dict(batch=2, seq=64, heads=8, kv_heads=4, head_dim=32)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), args.device)
    dev = mesh.device
    p = problem()
    gen = torch.Generator(device=dev).manual_seed(0)
    b, l, d = p["batch"], p["seq"], p["head_dim"]
    q = torch.randn((b, l, p["heads"], d), generator=gen, device=dev)
    k = torch.randn((b, l, p["kv_heads"], d), generator=gen, device=dev)
    v = torch.randn((b, l, p["kv_heads"], d), generator=gen, device=dev)

    ref = reference_attention(q, k, v, mask=MaskSpec(causal=True))
    errors = {}
    for strategy in STRATEGIES:
        cfg = SPConfig(strategy=strategy, sp_axes=("pod", "model"),
                       batch_axes=("data",), comm_backend="pallas",
                       kernel_interpret=False)
        out = sp_attention(q, k, v, mesh=mesh, cfg=cfg, causal=True)
        errors[strategy] = float((out - ref).abs().max())
        print(f"{strategy:12s} max|Δ| vs oracle = {errors[strategy]:.2e}")

    print("\nplanner on the production SP group (2 pods × 16 chips):")
    plans = {}
    for arch, hq, hkv in (("qwen2-1.5b", 12, 2), ("arctic-480b", 56, 8),
                          ("flux-12b", 24, 24)):
        pl = plan(2, 16, hq, hkv)
        plans[arch] = (pl.p_ulysses, pl.p_ring)
        print(f"  {arch:14s} Hq={hq:3d} Hkv={hkv:3d} -> "
              f"P_u={pl.p_ulysses:2d} (inter-pod Ulysses/Torus), "
              f"P_r={pl.p_ring:2d} (intra-pod Ring)")
    return {"errors": errors, "max_ref": float(ref.abs().max()),
            "plans": plans}


if __name__ == "__main__":
    main()
