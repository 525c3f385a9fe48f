"""Schedule validation gate of the comm layer (counterpart of
``src/repro/launch/commcheck.py``).

Runs the comm-heaviest programs on a mesh of virtual ranks, records their
one-sided schedules (``comm.record``) and validates each one:

  * swift_torus attention — torus hops and ring rotations;
  * the displaced patch pipeline — the pipe-axis stage hand-off;
  * the hierarchical two-level all-to-all (ulysses with ``hier_a2a``) —
    the fast leg must stay inside a machine, the slow leg's hops must
    declare their overlap;
  * the last two again through the put kernels (``comm_backend="pallas"``),
    whose semaphore protocol is checked too.

``comm.validate`` checks that every put's route is the reference's ppermute
route and that every put declaring an overlap has compute enqueued between
its issue and its wait (off the compute stream on CUDA); the eager
counterpart of the reference's gate on compiled HLO.  On CUDA each program
runs as the server runs a step: captured as a CUDA graph
(serving/graphs.py) after an eager warm-up, and replayed; the schedule is
recorded once, while it is captured, as the reference records it once per
trace.  Exit code 1 on any failure.

    python -m repro_torch.launch.commcheck [--device cpu] [--profile T.jsonl]

``--profile`` also runs swift_torus under both backends with the span
profiler and writes the ``comm.*`` spans to the given JSONL file (render
with ``python -m repro_torch.launch.trace_report``).  The programs run on
CUDA unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from .. import comm
from ..configs import get_reduced
from ..core import KVState, SPConfig, sp_attention
from ..models import ParallelContext, init_dit
from ..models.blocks import resolve_device
from ..models.dit import COND_TOKENS, LATENT_CHANNELS, dit_forward_displaced
from ..serving.graphs import CapturedStep
from .mesh import make_hybrid_mesh, make_mesh


def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen).to(device)


def _program(fn, device: torch.device):
    """Run ``fn`` as a served step runs: on CUDA its eager warm-up (not
    recorded), then its capture (recorded) and a replay; on the CPU once,
    eagerly."""
    if device.type != "cuda":
        return fn()
    step = CapturedStep(fn, device, name="commcheck")
    step()
    return step()


def run(device: torch.device, profile: str | None = None) -> int:
    """Record and validate every program; print one line per report."""
    gen = torch.Generator().manual_seed(0)
    reports = []

    # --- 1. swift_torus attention: torus hops + ring rotations ----------
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device)
    sp = SPConfig(strategy="swift_torus", sp_axes=("pod", "model"),
                  batch_axes=("data",))
    q, k, v = (_normal(gen, (2, 32, 2, 16), device) for _ in range(3))
    with comm.record("swift_torus") as tr:
        _program(lambda: sp_attention(q, k, v, mesh=mesh, cfg=sp), device)
    # an empty trace must never pass: both the torus hops and the ring
    # rotations are expected on this (P_u 2, P_r 2) plan
    for want in ("torus", "ring"):
        if not any(e.stream == want for e in tr.events):
            print(f"commcheck FAIL: no '{want}' channel puts recorded in "
                  "the swift_torus trace")
            return 1
    reports.append(comm.validate(tr, mesh))

    # --- 2. displaced patch pipeline: pipe-axis stage hand-off ----------
    hmesh = make_hybrid_mesh(cfg=1, pipe=2, data=1, model=4, device=device)
    cfg = dataclasses.replace(get_reduced("flux-12b"), dtype="float32",
                              n_heads=4, n_kv_heads=4)
    params = init_dit(cfg, torch.Generator(device=device).manual_seed(1),
                      device)
    psp = SPConfig(strategy="swift_torus", sp_axes=("model",),
                   batch_axes=("data",), pp_axis="pipe")
    ctx = ParallelContext(psp, "prefill", mesh=hmesh)
    seq = 32
    lat = _normal(gen, (1, seq, LATENT_CHANNELS), device)
    cond = _normal(gen, (1, COND_TOKENS, cfg.d_model), device)
    hd = cfg.resolved_head_dim
    shape = (cfg.n_layers, 1, COND_TOKENS + seq, cfg.n_kv_heads, hd)
    state = KVState(torch.zeros(shape, device=device),
                    torch.zeros(shape, device=device))
    tt = torch.full((1,), 0.5, device=device)
    with comm.record("displaced_pipe") as tr:
        _program(lambda: dit_forward_displaced(
            params, cfg, ctx, latents=lat, cond=cond, timesteps=tt,
            kv_state=state, num_patches=2, pp=2), device)
    if not any(e.stream == "pipe" for e in tr.events):
        print("commcheck FAIL: no pipe hand-off recorded in the displaced "
              "pipeline trace")
        return 1
    reports.append(comm.validate(tr, hmesh))

    # --- 3. hierarchical two-level all-to-all: ulysses over both
    # boundaries with u_groups = N; the fast leg must stay inside the
    # machine, the slow leg's hops must declare their overlap ------------
    hier_cfg = SPConfig(strategy="ulysses", sp_axes=("pod", "model"),
                        batch_axes=("data",), hier_a2a=True)
    hq, hk, hv = (_normal(gen, (2, 32, 4, 16), device) for _ in range(3))
    with comm.record("hier_a2a") as tr:
        _program(lambda: sp_attention(hq, hk, hv, mesh=mesh, cfg=hier_cfg),
                 device)
    hier_events = [e for e in tr.events if e.stream.startswith("hier")]
    labels = {e.channel.rsplit(".", 1)[-1] for e in hier_events}
    if not {"intra1", "inter1"} <= labels:
        print("commcheck FAIL: hierarchical a2a recorded no intra+inter "
              f"legs (channels: {sorted(labels)})")
        return 1
    group = mesh.axes_size(hier_cfg.sp_axes)
    m_fast = mesh.shape["model"]
    for e in hier_events:
        # rank lists are slice-major: rank i is SP rank i % group
        if "intra" in e.channel and any(
                (s % group) // m_fast != (d % group) // m_fast
                for s, d in e.perm):
            print(f"commcheck FAIL: fast leg {e.channel} crosses the "
                  f"machine boundary: {e.perm}")
            return 1
    if not all(e.overlaps for e in hier_events if "inter" in e.channel):
        print("commcheck FAIL: a hier inter hop declares no overlap")
        return 1
    reports.append(comm.validate(tr, mesh))

    # the same program through the put kernels: routes and overlap still
    # hold, and the semaphore protocol is clean
    hier_pl = dataclasses.replace(hier_cfg, comm_backend="pallas")
    with comm.record("hier_a2a_pallas") as tr:
        _program(lambda: sp_attention(hq, hk, hv, mesh=mesh, cfg=hier_pl),
                 device)
    if not any(e.backend == "pallas" and e.stream.startswith("hier")
               for e in tr.events):
        print("commcheck FAIL: no pallas-backend hier puts recorded")
        return 1
    reports.append(comm.validate(tr, mesh, require_overlap=False))
    hier_sem = comm.validate_semaphores(tr)
    if not hier_sem.ok:
        print(hier_sem.summary())
        return 1

    # --- 4. put kernels: the same swift_torus program, signal-tracked
    # puts and the fused ring kernel --------------------------------------
    psp = dataclasses.replace(sp, comm_backend="pallas")
    with comm.record("swift_torus_pallas") as tr:
        _program(lambda: sp_attention(q, k, v, mesh=mesh, cfg=psp), device)
    if not any(e.backend == "pallas" for e in tr.events):
        print("commcheck FAIL: no pallas-backend puts recorded in the "
              "swift_torus_pallas trace")
        return 1
    if not tr.sem_events:
        print("commcheck FAIL: the put kernels recorded no semaphore "
              "events")
        return 1
    reports.append(comm.validate(tr, mesh, require_overlap=False))
    sem_rep = comm.validate_semaphores(tr)
    print(sem_rep.summary())

    ok = sem_rep.ok
    for rep in reports:
        print(rep.summary())
        ok &= rep.ok

    # --- 5. optional measured schedule ----------------------------------
    if ok and profile is not None:
        from ..serving import JsonlTracker

        tracker = JsonlTracker(profile)
        prof = comm.CommProfiler()
        with comm.profile(prof):
            _program(lambda: sp_attention(q, k, v, mesh=mesh, cfg=sp),
                     device)
            _program(lambda: sp_attention(q, k, v, mesh=mesh, cfg=psp),
                     device)
        n = comm.emit_leg_spans(prof, tracker)
        tracker.close()
        print(f"profile: wrote {n} spans to {tracker.path} (render with "
              "python -m repro_torch.launch.trace_report)")
        if n == 0:
            print("commcheck FAIL: profiled run produced no spans")
            return 1
    return 0 if ok else 1


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="device the virtual ranks live on (default: cuda)")
    ap.add_argument("--profile", default=None, metavar="TRACE.JSONL",
                    help="also run swift_torus under the span profiler and "
                         "write the spans here")
    args = ap.parse_args(argv)
    return run(resolve_device(args.device), args.profile)


if __name__ == "__main__":
    sys.exit(main())
