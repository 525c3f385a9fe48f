"""Serve a small DiT through the hybrid-parallel engine: the paper's
scenario (Figure 1) plus the hybrid axes beyond it.  Mixed-resolution
requests with SLA deadlines go through the request scheduler (resolution
buckets, deadline-scored admission, per-bucket plan cache, drift-triggered
resync), then batched flow-matching sampling with swift_torus SP composed
with CFG parallelism and displaced patch pipelining, then the toy VAE
decode.

Part two is the adaptive control loop under bursty arrivals: a burst of
tight-SLA small requests lands while a long best-effort batch is
mid-flight; the preemption policy parks the running batch between
sampler steps (its requests keep their accrued age), the burst is served,
the parked batch restarts, and the online calibrator refits the comm
model from the measured step times.

The mesh is (cfg 2, pipe 2, model 2) of virtual ranks on one device; the
SP schedule's puts go through the put kernel K3 (one SP axis) and its
ring steps through K2:

    PYTHONPATH=src python -m repro_torch.examples.serve_dit [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from ..configs import get_reduced
from ..core import PipelineConfig, SPConfig, plan_hybrid
from ..launch.mesh import make_hybrid_mesh
from ..models import get_model
from ..serving import (
    CalibrationConfig,
    ControlConfig,
    DiTRequest,
    DiTServer,
    DriftPolicy,
    PreemptionPolicy,
    SamplerConfig,
    toy_vae_decode,
)

SIZES = (64, 128, 256)  # latent tokens of the three "image" sizes
# generous SLAs: the first batch of a bucket builds its step (and on the
# card captures it) inside the request latency
SLAS = {64: 30.0, 128: 60.0, 256: 90.0}
BURST_SLA = 0.15  # seconds: the burst's deadline


def model_config():
    return dataclasses.replace(get_reduced("flux-12b"), n_layers=2,
                               d_model=256, n_heads=8, n_kv_heads=8,
                               head_dim=32, d_ff=512, dtype="float32")


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = model_config()

    # hybrid mesh: 2-way CFG x 2 pipeline stages x 2-way swift_torus SP;
    # the planner picks the same shape for a real N x M cluster (cfg and
    # pp take the slow boundary first)
    h = plan_hybrid(4, 2, cfg.n_heads, cfg.n_kv_heads, cfg_parallel=True,
                    pp=2, n_layers=cfg.n_layers)
    print(f"hybrid plan: cfg={h.cfg} pp={h.pp} "
          f"P_u={h.sp.p_ulysses} P_r={h.sp.p_ring}  "
          f"({h.total_devices} devices)")
    mesh = make_hybrid_mesh(cfg=h.cfg, pipe=h.pp, data=1,
                            model=h.sp.sp_degree, device=args.device)
    gen = torch.Generator(device=mesh.device).manual_seed(0)
    params = get_model(cfg).init(cfg, gen, mesh.device)
    sp = SPConfig(strategy="swift_torus", sp_axes=("model",),
                  batch_axes=("data",), cfg_axis="cfg", pp_axis="pipe",
                  comm_backend="pallas", kernel_interpret=False)
    srv = DiTServer(params, cfg, sp,
                    sampler=SamplerConfig(
                        num_steps=4, guidance_scale=5.0, cfg_parallel=True,
                        pipeline=PipelineConfig(pp=2, warmup_steps=1)),
                    max_batch=2, mesh=mesh,
                    drift=DriftPolicy(threshold=0.1),
                    # the control loop: step-level preemption, online
                    # comm-model refit, forecast-bounded deferral (the
                    # deferral horizon binds only dp-padded batches, so on
                    # this dp=1 mesh the forecaster just tracks rates)
                    control=ControlConfig(
                        preemption=PreemptionPolicy(min_remaining_steps=1),
                        calibration=CalibrationConfig(min_samples=4,
                                                      refit_every=2),
                        forecast=True))

    # a mixed-resolution queue with per-request SLAs: the scheduler buckets
    # by latent length, admits by deadline slack, and caches one step and
    # plan per bucket shape
    for i in range(6):
        n = SIZES[i % len(SIZES)]
        srv.submit(DiTRequest(rid=i, seq_len=n, sla=SLAS[n],
                              drift_threshold=0.1))
    results = srv.serve()
    finite = {}
    for r in sorted(results, key=lambda r: r.rid):
        px = toy_vae_decode(r.latents[None])
        finite[r.rid] = bool(torch.isfinite(r.latents).all())
        print(f"request {r.rid}: latents {tuple(r.latents.shape)} -> "
              f"pixels {tuple(px.shape)}  "
              f"latency {r.latency * 1e3:.1f} ms  sla_met={r.sla_met}  "
              f"resyncs={r.resyncs}  finite={finite[r.rid]}")
    tot = srv.scheduler.totals()
    print(f"\nserved {len(results)} requests with swift_torus SP x "
          f"cfg_parallel x pp={h.pp} over {mesh.size} virtual ranks; "
          f"{tot.batches} batches over {len(srv.plan_cache.plans)} bucket "
          f"shapes ({srv.plan_cache.traces} step builds, "
          f"{srv.plan_cache.hits} step-cache hits)")

    # -- part two: a bursty arrival mid-batch ------------------------------
    # two long best-effort requests start a batch; after its first step a
    # burst of tight-SLA small requests lands via the on_step hook: the
    # preemption policy parks the long batch (its remaining measured steps
    # exceed the burst's slack), serves the burst, then restarts it
    print("\n--- bursty arrivals: step-level preemption ---")
    srv.submit(DiTRequest(rid=100, seq_len=256))
    srv.submit(DiTRequest(rid=101, seq_len=256))
    burst_sent = []

    def burst(server, step):
        if not burst_sent:
            burst_sent.append(step)
            for j in range(2):
                server.submit(DiTRequest(rid=200 + j, seq_len=64,
                                         sla=BURST_SLA, drift_threshold=0.1))

    srv.on_step = burst
    bursty = srv.serve()
    srv.on_step = None
    for r in sorted(bursty, key=lambda r: r.rid):
        finite[r.rid] = bool(torch.isfinite(r.latents).all())
        print(f"request {r.rid}: seq {r.latents.shape[0]}  "
              f"latency {r.latency * 1e3:.1f} ms  sla_met={r.sla_met}  "
              f"preemptions={r.preemptions}  "
              f"steps {[f'{t * 1e3:.0f}ms' for t in r.step_times]}")
    cal = srv.calibrator
    print(f"\ncontrol loop: {srv.preemptions} batch preemptions "
          f"({srv.scheduler.preempted} requests parked and requeued), "
          f"{cal.refits} comm-model refits, {cal.recalibrations} "
          f"recalibrations ({srv.plan_cache.invalidations} plan-score "
          f"invalidations; steps kept: {srv.plan_cache.traces} builds)")
    return {"results": {r.rid: r for r in (*results, *bursty)},
            "finite": finite, "preemptions": srv.preemptions,
            "refits": cal.refits, "server": srv}


if __name__ == "__main__":
    main()
