"""Render markdown tables from the port's dry-run JSON (the counterpart of
the reference's ``launch/report.py``):

    PYTHONPATH=src python -m repro_torch.launch.report \
        [--dir experiments/dryrun_torch]

The tables are the reference's.  The dry-run matrix shows ``count_s`` (the
seconds the counting run took on the host) where the reference shows its
compile time, and "—" where a memory term is null.
"""
from __future__ import annotations

import argparse
import glob
import json
from collections import defaultdict

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k",
               "flux_3072", "flux_4096", "cogvideox_20s", "cogvideox_40s"]


def load(dir_: str):
    out = []
    for p in sorted(glob.glob(f"{dir_}/*.json")):
        with open(p) as f:
            out.append(json.load(f))
    return out


def fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.1f}µs"


def fmt_gib(nbytes: float | None) -> str:
    return "—" if nbytes is None else f"{nbytes / 2**30:.2f}GiB"


def roofline_table(rows, mesh="pod", strategy=None):
    rows = [r for r in rows if r["mesh"] == mesh
            and (strategy is None or r["strategy"] == strategy)]
    key = lambda r: (r["arch"], SHAPE_ORDER.index(r["shape"])
                     if r["shape"] in SHAPE_ORDER else 99)
    lines = [
        "| arch | shape | strat | mem/dev | t_comp | t_mem | t_coll | bottleneck "
        "| useful | coll GiB/dev | inter-pod % |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(rows, key=key):
        rf = r["roofline"]
        interpct = (100.0 * rf["collective_inter_pod"] / rf["collective_bytes"]
                    if rf["collective_bytes"] else 0.0)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['strategy']} "
            f"| {fmt_gib(r['memory']['total_bytes'])} "
            f"| {fmt_s(rf['t_compute'])} | {fmt_s(rf['t_memory'])} "
            f"| {fmt_s(rf['t_collective'])} | **{rf['bottleneck']}** "
            f"| {rf['useful_ratio']:.2f} "
            f"| {rf['collective_bytes'] / 2**30:.3f} | {interpct:.0f}% |")
    return "\n".join(lines)


def dryrun_table(rows):
    by = defaultdict(dict)
    for r in rows:
        by[(r["arch"], r["shape"], r["strategy"])][r["mesh"]] = r
    lines = ["| arch | shape | strat | pod(256) count | mem/dev | "
             "multipod(512) count | mem/dev |",
             "|---|---|---|---|---|---|---|"]
    key = lambda k: (k[0], SHAPE_ORDER.index(k[1]) if k[1] in SHAPE_ORDER else 99)
    for k in sorted(by, key=key):
        p = by[k].get("pod")
        m = by[k].get("multipod")
        f = lambda r: (f"{r['count_s']}s | "
                       f"{fmt_gib(r['memory']['total_bytes'])}"
                       if r else "— | —")
        lines.append(f"| {k[0]} | {k[1]} | {k[2]} | {f(p)} | {f(m)} |")
    return "\n".join(lines)


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--table", choices=["roofline", "dryrun", "both"],
                    default="both")
    ap.add_argument("--mesh", default="pod")
    ap.add_argument("--strategy", default=None)
    args = ap.parse_args(argv)
    rows = load(args.dir)
    if args.table in ("dryrun", "both"):
        print("### Dry-run matrix\n")
        print(dryrun_table(rows))
        print()
    if args.table in ("roofline", "both"):
        print(f"### Roofline ({args.mesh})\n")
        print(roofline_table(rows, mesh=args.mesh, strategy=args.strategy))


if __name__ == "__main__":
    main()
