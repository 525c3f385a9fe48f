"""Serving launcher of the port (counterpart of
``src/repro/launch/serve.py``): a DiT sampling service or an AR decode
service, on the card unless ``--device cpu`` asks for the CPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch flux-12b \
        --requests 4 --seq 1024 --steps 4                   # degree 1
    ... --arch flux-12b --mesh pod --seq 1024             (swift_torus SP)
    ... --arch flux-12b --reduced --requests 6 --mixed --sla 30
    ... --arch rwkv6-1.6b --requests 4                    (AR decode)
    ... --arch qwen2-1.5b --requests 4 [--mesh pod]       (AR decode, KV
                                                           cache sharded)
    ... --arch hymba-1.5b | qwen2-moe-a2.7b [--mesh pod]  (hybrid / MoE;
                                                           experts over model)
    ... --device cpu --reduced ...                        (on the CPU)
    ... --arch flux-12b --procs 4 --mesh host --model 4 --eager
                                    (one process per rank: launch/procs.py)
    ... --arch flux-12b --procs 4 --mesh multipod --eager
                                    (a block of 8 ranks per process)
    ... --arch qwen2-1.5b --procs 4 --mesh host --model 4 --eager
                                    (AR decode, KV cache across processes)
    ... --arch qwen2-moe-a2.7b --procs 4 --mesh host --model 4 --eager
                                    (each process holds its EP rank's
                                     experts)

The flags are the reference's.  DiT requests go through the SLA-aware
request scheduler: ``--mixed`` submits a mixed-resolution queue (seq,
seq/2, 2*seq cycling) so the bucketer and the per-bucket plan cache are
exercised; ``--sla`` attaches a deadline to every request.  ``--preempt``,
``--recalibrate`` and ``--forecast`` engage the control loop's feedback
paths; ``--metrics out.jsonl`` streams the engine's records and prints an
aggregate table; ``--profile trace.jsonl`` adds the comm span profiler
(render with ``python -m repro_torch.launch.trace_report``).

Meshes are of virtual ranks on one device (launch/mesh.py): ``host`` is
(data, model) from ``--data`` and ``--model``; ``pod`` is the paper's
(pod 2, model 8), SP over both axes; ``multipod`` adds a data axis of 2,
(pod 2, data 2, model 8).  SP above degree 1 runs through the put kernels
(``comm_backend="pallas"``).  Each bucket's step is captured as a CUDA
graph and replayed (serving/graphs.py); ``--eager`` runs the steps op by
op instead, for diagnosis.  ``--layers N`` serves the first N layers of
the config (a depth cut at the published widths).  The weights are random, from seed 0, as the
reference's are.  The AR branch serves rwkv6-1.6b on one rank and the
attention LMs on any mesh: the dense and vlm families (qwen2-1.5b,
stablelm-3b, starcoder2-7b, chatglm3-6b, qwen2-vl-2b), hymba-1.5b and the
MoE LMs (qwen2-moe-a2.7b, arctic-480b, whose experts split over the mesh's
model axis, padded to a multiple of its size), the KV cache sharded on the
sequence over the SP axes (``--seq`` is the cache length).  ``--procs P``
spreads the mesh's ranks over P processes (launch/procs.py; one per rank
is the reference's layout, on the card ``rank % device_count``): process
0 prints what the server did, the others follow its steps.  It serves the
DiTs and the attention LMs (dense, vlm, hybrid and MoE: each process
decodes its slots with its part of the KV cache, a MoE model's process
holding only the experts of its EP ranks, ``init_lm(..., mesh=)``) on
every mesh above, a data axis included (each process a block of ranks
within one data slice), eagerly (``--eager`` on the card: captured steps
across processes are ROADMAP Queue 1 item 13).  An attention
model's caches take the model's dtype: the reference's launcher leaves
ARServer's float32 default, which its cache update refuses for a bfloat16
model.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import sys

import torch

from ..configs import (DENSE_ARCHS, DIT_ARCHS, HYBRID_ARCHS, MOE_ARCHS,
                       SSM_ARCHS, get_config, get_reduced)
from ..core import SPConfig
from ..models import init_dit, init_lm
from ..models.blocks import resolve_device, torch_dtype
from ..serving import (ARRequest, ARServer, DiTRequest, DiTServer,
                       JsonlTracker, SamplerConfig, Tracker)
from ..serving.sched import (SCHEMA_VERSION, CalibrationConfig,
                             ControlConfig, PreemptionPolicy)
from . import procs as _procs
from .mesh import launch_mesh, process_mesh

LM_ARCHS = SSM_ARCHS + DENSE_ARCHS + HYBRID_ARCHS + MOE_ARCHS


def _graphs_line(steps) -> str:
    captured = [s for s in steps if s.graph is not None]
    if not captured:
        return "graphs: none captured (eager steps)"
    return (f"graphs: {len(captured)} captured, capture "
            f"{sum(s.capture_s for s in captured):.2f} s, instantiation "
            f"{sum(s.instantiate_s for s in captured):.2f} s, "
            f"{sum(s.replays for s in captured)} replays")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--strategy", default="swift_torus")
    ap.add_argument("--mesh", choices=["pod", "multipod", "host"],
                    default="host")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--steps", type=int, default=4, help="sampling steps (DiT)")
    ap.add_argument("--mixed", action="store_true",
                    help="mixed-resolution queue (exercises the bucketer)")
    ap.add_argument("--sla", type=float, default=None,
                    help="deadline (s) attached to every DiT request")
    ap.add_argument("--preempt", action="store_true",
                    help="step-level preemption for SLA-critical buckets")
    ap.add_argument("--recalibrate", action="store_true",
                    help="refit the comm model from measured step times "
                         "in-flight")
    ap.add_argument("--forecast", action="store_true",
                    help="bound padded-batch deferral with the arrival "
                         "forecaster (needs --data > 1)")
    ap.add_argument("--metrics", default=None, metavar="OUT.JSONL",
                    help="stream schema-versioned metrics records to this "
                         "JSONL file and print an aggregate table")
    ap.add_argument("--profile", default=None, metavar="TRACE.JSONL",
                    help="--metrics plus the comm span profiler; render "
                         "with python -m repro_torch.launch.trace_report. "
                         "DiT only.")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="device of the virtual ranks (default: cuda)")
    ap.add_argument("--eager", action="store_true",
                    help="run every step op by op (no CUDA graphs)")
    ap.add_argument("--layers", type=int, default=None,
                    help="serve the first N layers (depth cut; widths "
                         "stay the config's)")
    ap.add_argument("--procs", type=int, default=1,
                    help="spread the mesh's ranks over this many processes "
                         "(DiTs and attention LMs, eager)")
    args = ap.parse_args(argv)
    if args.profile is not None and args.metrics is not None:
        ap.error("--profile already streams metrics records; "
                 "give one output path, not both")

    if args.procs > 1:
        if args.arch in SSM_ARCHS:
            ap.error("the rwkv6 decode tick runs on one rank: serve it "
                     "without --procs")
        served = DIT_ARCHS + DENSE_ARCHS + HYBRID_ARCHS + MOE_ARCHS
        if args.arch not in served:
            ap.error(f"--procs serves {served}")
        if args.metrics is not None or args.profile is not None:
            ap.error("--procs runs without --metrics or --profile")
        if not args.eager and resolve_device(args.device).type == "cuda":
            ap.error("--procs needs --eager: captured steps over processes "
                     "are ROADMAP Queue 1 item 13")
        _procs.launch(serve_job, args.procs, args,
                      device=resolve_device(args.device).type)
        return 0
    return _serve(args)


def _blocks(mesh) -> str:
    """Each process's block of ranks, as its coordinate range per axis."""
    k = mesh.size // mesh.procs
    out = []
    for q in range(mesh.procs):
        lo, hi = mesh.coords(q * k), mesh.coords((q + 1) * k - 1)
        out.append(f"{q}: " + " ".join(
            f"{a} {a0}" if a0 == a1 else f"{a} {a0}-{a1}"
            for a, a0, a1 in zip(mesh.axis_names, lo, hi)))
    return "; ".join(out)


def _digest(x) -> str:
    """The first 16 hex digits of the SHA-256 of ``x``'s bytes: equal
    digests are equal latents, bit for bit and row for row."""
    raw = x.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()[:16]


def serve_job(group, args) -> None:
    """One process of ``--procs``: its part of the process mesh."""
    _serve(args, group)


def _serve(args, group=None) -> int:
    """The launcher's body; with ``group`` (a worker of launch/procs.py)
    on this process's part of the process mesh, where process 0 leads."""
    lead = group is None or group.rank == 0
    if args.arch not in DIT_ARCHS + LM_ARCHS:
        raise NotImplementedError(
            f"{args.arch}: the port serves {DIT_ARCHS + LM_ARCHS}; no "
            "counterpart is owed for the rest (the reference's launcher "
            "cannot serve whisper-tiny either: ROADMAP F7)")
    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg, dtype="float32",
                                  sharding_overrides=())
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.profile is not None and cfg.family != "dit":
        raise SystemExit("serve: error: --profile instruments the DiT step "
                         "loop; use a dit --arch")
    capture = False if args.eager else None
    gen = torch.Generator(device=device).manual_seed(0)
    sink = args.profile if args.profile is not None else args.metrics
    tracker = JsonlTracker(sink) if sink is not None else Tracker()

    if cfg.family == "dit":
        mesh, sp = launch_mesh(args.mesh, args.model, args.data,
                               args.strategy, device)
        if group is not None:
            mesh = process_mesh(mesh, group.rank, group.size)
            device = mesh.device
            gen = torch.Generator(device=device).manual_seed(0)
        params = init_dit(cfg, gen, device)
        control = ControlConfig(
            preemption=PreemptionPolicy() if args.preempt else None,
            calibration=CalibrationConfig() if args.recalibrate else None,
            forecast=args.forecast)
        srv = DiTServer(params, cfg, sp, mesh=mesh,
                        sampler=SamplerConfig(num_steps=args.steps),
                        control=control, tracker=tracker,
                        profile=args.profile is not None, capture=capture)
        if not lead:
            srv.follow()
            return 0
        lens = ([args.seq, args.seq // 2, args.seq * 2] if args.mixed
                else [args.seq])
        for i in range(args.requests):
            srv.submit(DiTRequest(rid=i, seq_len=lens[i % len(lens)],
                                  sla=args.sla))
        served = srv.serve()
        if group is not None:
            srv.stop_followers()
            print(f"process mesh: {group.size} processes, {len(mesh.owned)} "
                  f"of {mesh.size} ranks each; blocks {_blocks(mesh)}")
        for r in sorted(served, key=lambda r: r.rid):
            print(f"request {r.rid}: latents {tuple(r.latents.shape)} "
                  f"latency {r.latency * 1e3:.1f} ms mean|x| "
                  f"{float(r.latents.float().abs().mean()):.6f} sha256 "
                  f"{_digest(r.latents)}"
                  + ("" if r.sla_met else "  SLA MISSED"))
        tot = srv.scheduler.totals()
        print(f"scheduler: {tot.batches} batches over "
              f"{len(srv.plan_cache.plans)} bucket shapes "
              f"({srv.plan_cache.traces} traces, {srv.plan_cache.hits} "
              f"step-cache hits), {tot.padded_rows} padded rows, "
              f"max wait {tot.max_wait * 1e3:.1f} ms")
        print(_graphs_line(srv.captured_steps()))
        if control.engaged:
            cal = srv.calibrator
            print(f"control: {srv.preemptions} preemptions "
                  f"({srv.scheduler.preempted} requests requeued)"
                  + (f", {cal.refits} refits / {cal.recalibrations} "
                     f"recalibrations ({srv.plan_cache.invalidations} "
                     f"plan-score invalidations)" if cal else ""))
    else:
        if cfg.family == "ssm":
            if args.mesh != "host" or args.model > 1 or args.data > 1:
                raise SystemExit("serve: error: the rwkv6 decode tick runs "
                                 "on one rank: --mesh host without --model "
                                 "or --data")
            mesh, sp, cache_dtype = None, SPConfig(strategy="full"), \
                torch.float32
        else:
            mesh, sp = launch_mesh(args.mesh, args.model, args.data,
                                   args.strategy, device)
            cache_dtype = torch_dtype(cfg.dtype)
            if group is not None:
                mesh = process_mesh(mesh, group.rank, group.size)
                device = mesh.device
                gen = torch.Generator(device=device).manual_seed(0)
        params = init_lm(cfg, gen, device, mesh=mesh)
        srv = ARServer(params, cfg, sp, batch_slots=4, max_len=args.seq,
                       cache_dtype=cache_dtype, tracker=tracker,
                       device=device, capture=capture, mesh=mesh)
        if not lead:
            srv.follow()
            return 0
        for i in range(args.requests):
            srv.submit(ARRequest(rid=i, prompt=torch.arange(1, 4 + i),
                                 max_new_tokens=8))
        served = srv.serve()
        if group is not None:
            srv.stop_followers()
            print(f"process mesh: {group.size} processes, {len(mesh.owned)} "
                  f"of {mesh.size} ranks each; blocks {_blocks(mesh)}")
        for rid, toks in sorted(served.items()):
            print(f"request {rid}: -> {toks}")
        print(_graphs_line([srv._step]))
    if sink is not None:
        tracker.close()
        print(f"\nmetrics: wrote {tracker.path} (schema {SCHEMA_VERSION})")
        print(tracker.format_summary())
        if args.profile is not None:
            print(f"profile: render with python -m "
                  f"repro_torch.launch.trace_report {tracker.path} "
                  f"--chrome {tracker.path}.chrome.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
