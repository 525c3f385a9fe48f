"""Fleet-router launcher (DESIGN.md §13): N serving replicas — each one
mesh's PR-3/5 scheduler/control stack — behind global SLA-aware dispatch.

    PYTHONPATH=src python -m repro_torch.launch.fleet --replicas 2 --policy warmth
    ... --policy sla --fail r0@0.35 --trace-dir /tmp/fleet
    ... --trace stream.json   (a benchmarks/sched_sweep.py --emit-trace file)

Entirely host-side on simulated time (no jax, no wall clock): the fleet
execution harness runs each admitted batch for its comm-model-predicted
duration, plus the one-time jit-trace stall the first time a replica
runs a bucket shape — the asymmetry the ``warmth`` policy exploits.
Router state is fed exclusively by folded per-replica ``metrics.v1``
tracker streams (the trace-shipping protocol); ``--trace-dir`` keeps the
per-replica JSONL traces and the router's folded trace on disk, each
independently valid under ``scripts/check_metrics_schema.py``.

``--fail RID@T`` / ``--drain RID@T`` injects a replica failure (queue
evacuated, router re-dispatch with age intact) or drain (serves out,
no new dispatch) at simulated second T; the replica revives
``--revive-after`` seconds later.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import random

from ..serving.fleet import (
    POLICIES,
    FailureEvent,
    FleetRequest,
    FleetRouter,
    Replica,
    run_fleet,
)
from ..serving.metrics import JsonlTracker


def default_stream(n: int = 120, seed: int = 7) -> list[FleetRequest]:
    """Seeded mixed-resolution stream: steady loose-SLA 1024 background
    with periodic tight-SLA 256 bursts (the sched_sweep bursty shape)."""
    rnd = random.Random(seed)
    reqs: list[FleetRequest] = []
    rid, t, next_burst = 0, 0.0, 0.02
    while rid < n:
        t += rnd.uniform(0.004, 0.012)
        if t >= next_burst:
            bt = next_burst
            for _ in range(4):
                reqs.append(FleetRequest(rid=rid, seq_len=256,
                                         arrival=round(bt, 6), sla=0.012))
                rid += 1
                bt += rnd.uniform(0.0001, 0.0004)
            next_burst += rnd.uniform(0.08, 0.12)
        reqs.append(FleetRequest(rid=rid, seq_len=1024,
                                 arrival=round(t, 6), sla=1.5))
        rid += 1
    reqs.sort(key=lambda r: (r.arrival, r.rid))
    return reqs


def load_stream(path: pathlib.Path) -> list[FleetRequest]:
    """A ``benchmarks/sched_sweep.py --emit-trace`` request trace."""
    payload = json.loads(path.read_text())
    return [FleetRequest(rid=d["rid"], seq_len=d["seq_len"],
                         arrival=d["arrival"], sla=d.get("sla"))
            for d in payload["requests"]]


def parse_event(spec: str, kind: str, revive_after: float) -> FailureEvent:
    rid, _, at = spec.partition("@")
    if not rid or not at:
        raise SystemExit(f"--{kind} wants RID@SECONDS, got {spec!r}")
    return FailureEvent(at=float(at), rid=rid, kind=kind,
                        revive_after=revive_after)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--policy", choices=POLICIES, default="warmth")
    ap.add_argument("--requests", type=int, default=120,
                    help="length of the built-in seeded stream")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--trace", type=pathlib.Path, default=None,
                    help="replay a sched_sweep --emit-trace request file "
                         "instead of the built-in stream")
    ap.add_argument("--trace-dir", type=pathlib.Path, default=None,
                    help="write per-replica + router-folded metrics.v1 "
                         "JSONL traces here")
    ap.add_argument("--fail", default=None, metavar="RID@T",
                    help="fail a replica at simulated second T")
    ap.add_argument("--drain", default=None, metavar="RID@T",
                    help="drain a replica at simulated second T")
    ap.add_argument("--revive-after", type=float, default=0.25)
    args = ap.parse_args(argv)
    if args.fail and args.drain:
        ap.error("give --fail or --drain, not both")

    reqs = (load_stream(args.trace) if args.trace is not None
            else default_stream(args.requests, args.seed))
    failure = None
    if args.fail:
        failure = parse_event(args.fail, "fail", args.revive_after)
    elif args.drain:
        failure = parse_event(args.drain, "drain", args.revive_after)

    paths: list[pathlib.Path | None] = [None] * args.replicas
    router_trk = None
    if args.trace_dir is not None:
        args.trace_dir.mkdir(parents=True, exist_ok=True)
        paths = [args.trace_dir / f"replica-r{k}.jsonl"
                 for k in range(args.replicas)]
        router_trk = JsonlTracker(args.trace_dir / "router.jsonl")

    replicas = [Replica.sim(f"r{k}", paths[k])
                for k in range(args.replicas)]
    router = FleetRouter(replicas, policy=args.policy, tracker=router_trk)
    stats = run_fleet(reqs, router, failure=failure)
    for rep in replicas:
        if isinstance(rep.tracker, JsonlTracker):
            rep.tracker.close()
    if router_trk is not None:
        router_trk.close()

    print(f"fleet: {args.replicas} replicas, policy={args.policy}, "
          f"{len(reqs)} requests" + (f", {failure.kind}={failure.rid}"
                                     f"@{failure.at}" if failure else ""))
    for k in ("served", "batches", "sla_met", "sla_miss", "sla_met_frac",
              "makespan_s", "max_wait", "traces", "spills", "repartitions",
              "requeued"):
        v = stats[k]
        print(f"  {k:14} {v:.4f}" if isinstance(v, float) else
              f"  {k:14} {v}")
    if args.trace_dir is not None:
        print(f"  traces -> {args.trace_dir}/replica-r*.jsonl + router.jsonl")


if __name__ == "__main__":
    main()
