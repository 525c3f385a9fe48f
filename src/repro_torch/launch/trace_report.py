"""Render a span trace (``--profile`` JSONL) into human and Perfetto form
(counterpart of ``scripts/trace_report.py``, on the port's copies of
``core/comm_model.py`` and ``serving/metrics.py``, so that it runs where
there is no jax).

Three outputs from one ``metrics.v1`` span stream:

  * ``--chrome OUT.json`` — Chrome trace-event JSON loadable in Perfetto
    (https://ui.perfetto.dev): one track per device coordinate (the
    ``track`` tag the comm profiler stamps, e.g. ``pod=0,model=3``) plus
    a ``host`` track for engine/sampler/plan-cache/calibrator spans,
    with nesting rebuilt from the ``parent`` tags.
  * overlap-efficiency table (default stdout) — per comm leg class
    (stream/channel/stage): measured hidden fraction
    ``1 - Σexposed / Σdur`` (exposed = how long the receiver's wait
    stalled before the signal landed) next to the *intended* schedule
    from ``comm.trace`` (the ``intent`` tag carries the put's
    ``overlaps`` label: non-empty means trace validation admitted the
    overlap, so the intended hidden fraction is 1.0), plus the fraction
    of each leg's duration spent under a marked compute span on the same
    device track.
  * per-leg NetworkModel residuals — each leg class's measured mean
    duration against the model's ``bytes/bw + lat + issue`` prediction,
    with the drift attributed to a specific term: the implied bandwidth
    (intra_bw or inter_bw by the leg's axes), the implied per-leg
    overhead (lat + issue), and — from the ``engine.step`` spans' model
    tags — the implied mfu.  This is what turns "the calibrator moved"
    into "inter_bw is 3x off, everything else is fine".

``--check`` runs the CI assertions (profile-smoke job): the Chrome JSON
parses, every span with a ``parent`` tag nests inside a same-track span
of that name, and at least one comm leg overlaps a compute span.

The port's profiler stamps one track per device (``dev``): one put
covers every virtual rank, so ``nbytes`` is one rank's bytes and the
``ranks`` tag the route's rank count (comm/profiler.py).  The report reads
only host clocks from the file and touches no device.

Usage:
  python -m repro_torch.launch.trace_report TRACE.JSONL [--chrome OUT.json]
         [--check] [--inter-axes pod] [--net calibration.json]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
from collections import defaultdict

from ..core.comm_model import NetworkModel, load_network_model
from ..serving.metrics import Record, read_jsonl

HOST_TRACK = "host"


def load_spans(path: str | pathlib.Path) -> list[Record]:
    """Span records of a trace, tolerating a crashed writer's tail."""
    return [r for r in read_jsonl(path, partial_tail="drop")
            if r.kind == "span"]


def track_of(r: Record) -> str:
    return str(r.tags.get("track", HOST_TRACK))


def span_name(r: Record) -> str:
    """Display name: comm legs read as their channel, compute as label."""
    if r.name == "comm.leg":
        return str(r.tags.get("channel", r.name))
    if r.name == "comm.compute":
        return str(r.tags.get("label", r.name))
    return r.name


# ---------------------------------------------------------------------------
# (a) Chrome trace-event JSON
# ---------------------------------------------------------------------------

def chrome_trace(spans: list[Record]) -> dict:
    """Trace-event JSON: ``ph:"X"`` complete events, µs timebase, one tid
    per track (host first, then device coords sorted)."""
    tracks = sorted({track_of(r) for r in spans},
                    key=lambda t: (t != HOST_TRACK, t))
    tid = {t: i for i, t in enumerate(tracks)}
    events: list[dict] = [
        {"ph": "M", "pid": 0, "tid": 0, "name": "process_name",
         "args": {"name": "repro_torch --profile"}},
    ]
    for t in tracks:
        events.append({"ph": "M", "pid": 0, "tid": tid[t],
                       "name": "thread_name", "args": {"name": t}})
    for r in spans:
        args = {k: v for k, v in r.tags.items() if k != "track"}
        if r.step is not None:
            args["step"] = r.step
        events.append({
            "ph": "X", "pid": 0, "tid": tid[track_of(r)],
            "ts": r.t_start * 1e6, "dur": r.value * 1e6,
            "name": span_name(r), "cat": r.name.split(".")[0],
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# (b) overlap-efficiency table
# ---------------------------------------------------------------------------

def _intervals_by_track(spans: list[Record],
                        name: str) -> dict[str, list[tuple[float, float]]]:
    out: dict[str, list[tuple[float, float]]] = defaultdict(list)
    for r in spans:
        if r.name == name:
            out[track_of(r)].append((r.t_start, r.t_start + r.value))
    for v in out.values():
        v.sort()
    return out


def _overlap_with(iv: tuple[float, float],
                  others: list[tuple[float, float]]) -> float:
    """Total time of ``iv`` covered by the (sorted, possibly overlapping)
    ``others`` — union of the pairwise intersections."""
    lo, hi = iv
    covered = 0.0
    cur = lo
    for a, b in others:
        if b <= cur or a >= hi:
            continue
        a = max(a, cur)
        b = min(b, hi)
        if b > a:
            covered += b - a
            cur = b
    return covered


def leg_key(r: Record) -> tuple:
    return (str(r.tags.get("stream", "")), str(r.tags.get("channel", "")),
            int(r.tags.get("stage", 0)))


def overlap_table(spans: list[Record]) -> list[dict]:
    """One row per comm leg class: measured vs intended hiding."""
    compute = _intervals_by_track(spans, "comm.compute")
    rows: dict[tuple, dict] = {}
    for r in spans:
        if r.name != "comm.leg":
            continue
        k = leg_key(r)
        row = rows.setdefault(k, {
            "stream": k[0], "channel": k[1], "stage": k[2],
            "intent": str(r.tags.get("intent", "")),
            "backend": str(r.tags.get("backend", "")),
            "n": 0, "dur_s": 0.0, "exposed_s": 0.0, "n_waited": 0,
            "compute_overlap_s": 0.0,
        })
        row["n"] += 1
        row["dur_s"] += r.value
        if "exposed_s" in r.tags:
            row["exposed_s"] += float(r.tags["exposed_s"])
            row["n_waited"] += 1
        iv = (r.t_start, r.t_start + r.value)
        row["compute_overlap_s"] += _overlap_with(
            iv, compute.get(track_of(r), []))
    out = []
    for k in sorted(rows):
        row = rows[k]
        dur = row["dur_s"]
        row["mean_us"] = dur / row["n"] * 1e6
        # measured: the stall-based hidden fraction (1.0 when no wait was
        # observed or every wait came after the signal)
        row["hidden_frac"] = 1.0 - row["exposed_s"] / dur if dur > 0 else 1.0
        row["compute_overlap_frac"] = (row["compute_overlap_s"] / dur
                                       if dur > 0 else 0.0)
        # intended: comm.trace admitted the overlap iff the put named the
        # compute it hides behind ("sem" marks the landing-protocol span)
        row["intended_hidden"] = row["intent"] not in ("", "sem")
        out.append(row)
    return out


def format_overlap(rows: list[dict]) -> str:
    lines = ["overlap efficiency (measured vs intended, DESIGN.md §12)",
             f"{'leg (stream/channel/stage)':<34} {'n':>4} {'mean_us':>9} "
             f"{'hidden':>7} {'intended':>9} {'compute_ov':>10}"]
    for r in rows:
        leg = f"{r['stream']}/{r['channel']}/s{r['stage']}"
        lines.append(
            f"{leg:<34} {r['n']:>4} {r['mean_us']:>9.1f} "
            f"{r['hidden_frac']:>7.2f} "
            f"{'1.00' if r['intended_hidden'] else '-':>9} "
            f"{r['compute_overlap_frac']:>10.2f}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# (c) per-leg NetworkModel residuals
# ---------------------------------------------------------------------------

def leg_residuals(spans: list[Record], net: NetworkModel,
                  inter_axes: frozenset[str]) -> list[dict]:
    """Measured mean duration per leg class vs the model's
    ``bytes/bw + lat + issue`` — and the term-level attribution: the
    implied bandwidth given the model's fixed overheads, and the implied
    per-leg overhead given the model's bandwidth."""
    agg: dict[tuple, dict] = {}
    for r in spans:
        if r.name != "comm.leg":
            continue
        k = leg_key(r)
        a = agg.setdefault(k, {
            "stream": k[0], "channel": k[1], "stage": k[2], "n": 0,
            "dur_s": 0.0, "nbytes": int(r.tags.get("nbytes", 0)),
            "axes": str(r.tags.get("axes", "")),
        })
        a["n"] += 1
        a["dur_s"] += r.value
    out = []
    for k in sorted(agg):
        a = agg[k]
        axes = set(a["axes"].split(",")) if a["axes"] else set()
        inter = bool(axes & inter_axes)
        bw = net.inter_bw if inter else net.intra_bw
        lat = net.inter_lat if inter else net.intra_lat
        overhead = lat + net.step_issue_overhead
        pred = a["nbytes"] / bw + overhead
        meas = a["dur_s"] / a["n"]
        wire = meas - overhead  # time left for the bytes under model overhead
        a.update({
            "cls": "inter" if inter else "intra",
            "measured_us": meas * 1e6,
            "predicted_us": pred * 1e6,
            "ratio": meas / pred if pred > 0 else float("inf"),
            # attribution: what each single term would have to be for the
            # model to match this leg, holding the others at their
            # current values
            "implied_bw": a["nbytes"] / wire if wire > 0 else 0.0,
            "implied_overhead_us": max(meas - a["nbytes"] / bw, 0.0) * 1e6,
            "bw_term": "inter_bw" if inter else "intra_bw",
        })
        out.append(a)
    return out


def step_residuals(spans: list[Record], net: NetworkModel) -> dict | None:
    """Whole-step and compute-term residuals from the ``engine.step``
    spans' model tags (``pred_t_step_s`` / ``pred_compute_s``).  The
    measured compute occupancy comes from the ``comm.compute`` spans
    (upper bounds — their start fires when inputs are ready), so the
    implied mfu is a lower bound on the true value."""
    steps = [r for r in spans if r.name == "engine.step"]
    if not steps:
        return None
    n = len(steps)
    meas_step = sum(r.value for r in steps) / n
    preds = [float(r.tags["pred_t_step_s"]) for r in steps
             if "pred_t_step_s" in r.tags]
    pred_step = sum(preds) / len(preds) if preds else None
    comp_preds = [float(r.tags["pred_compute_s"]) for r in steps
                  if "pred_compute_s" in r.tags]
    pred_comp = sum(comp_preds) / len(comp_preds) if comp_preds else None
    comp = [r for r in spans if r.name == "comm.compute"]
    tracks = {track_of(r) for r in comp} or {HOST_TRACK}
    meas_comp = (sum(r.value for r in comp) / (n * len(tracks))
                 if comp else None)
    out = {"n_steps": n, "measured_step_s": meas_step,
           "pred_step_s": pred_step,
           "step_ratio": (meas_step / pred_step
                          if pred_step else None),
           "measured_compute_s": meas_comp, "pred_compute_s": pred_comp}
    if meas_comp and pred_comp and meas_comp > 0:
        # measured slower than modelled compute => effective mfu lower
        out["implied_mfu"] = net.mfu * pred_comp / meas_comp
    return out


def format_residuals(rows: list[dict], step: dict | None,
                     net: NetworkModel) -> str:
    lines = ["per-leg NetworkModel residuals (term attribution)",
             f"{'leg':<34} {'cls':>5} {'bytes':>9} {'meas_us':>9} "
             f"{'pred_us':>9} {'ratio':>7}  attribution"]
    for r in rows:
        leg = f"{r['stream']}/{r['channel']}/s{r['stage']}"
        model_bw = net.inter_bw if r["cls"] == "inter" else net.intra_bw
        attr = (f"{r['bw_term']}~{r['implied_bw']:.3g}B/s "
                f"(model {model_bw:.3g}), "
                f"lat+issue~{r['implied_overhead_us']:.1f}us")
        lines.append(f"{leg:<34} {r['cls']:>5} {r['nbytes']:>9} "
                     f"{r['measured_us']:>9.1f} {r['predicted_us']:>9.1f} "
                     f"{r['ratio']:>7.2f}  {attr}")
    if step is not None:
        lines.append("")
        lines.append(
            f"steps: n={step['n_steps']} "
            f"measured={step['measured_step_s'] * 1e3:.2f}ms"
            + (f" pred={step['pred_step_s'] * 1e3:.2f}ms "
               f"ratio={step['step_ratio']:.2f}"
               if step["pred_step_s"] else ""))
        if step.get("implied_mfu") is not None:
            lines.append(
                f"compute: measured/dev/step="
                f"{step['measured_compute_s'] * 1e3:.2f}ms "
                f"model={step['pred_compute_s'] * 1e3:.2f}ms "
                f"=> implied mfu~{step['implied_mfu']:.3g} "
                f"(model {net.mfu}; lower bound, compute spans are "
                f"input-ready..output windows)")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# --check: the CI assertions (profile-smoke job)
# ---------------------------------------------------------------------------

def check_trace(spans: list[Record], chrome: dict) -> list[str]:
    errs: list[str] = []
    if not spans:
        return ["trace contains no span records"]
    # 1. Chrome JSON well-formed: every X event has the required fields
    #    and survives a JSON round-trip
    try:
        parsed = json.loads(json.dumps(chrome))
    except (TypeError, ValueError) as e:
        return [f"chrome trace not JSON-serializable: {e}"]
    xs = [e for e in parsed["traceEvents"] if e.get("ph") == "X"]
    if len(xs) != len(spans):
        errs.append(f"{len(spans)} spans but {len(xs)} X events")
    for e in xs:
        for f in ("ts", "dur", "pid", "tid", "name"):
            if f not in e:
                errs.append(f"X event missing {f!r}: {e}")
                break
    # 2. nesting: every span with a parent tag lies inside a same-track
    #    span of that name (small epsilon for clock granularity)
    eps = 1e-6
    by_track: dict[str, list[Record]] = defaultdict(list)
    for r in spans:
        by_track[track_of(r)].append(r)
    for r in spans:
        parent = r.tags.get("parent")
        if parent is None:
            continue
        lo, hi = r.t_start, r.t_start + r.value
        ok = any(p.name == parent
                 and p.t_start - eps <= lo and hi <= p.t_start + p.value + eps
                 for p in by_track[track_of(r)] if p is not r)
        if not ok:
            errs.append(f"span {r.name!r} (seq {r.seq}) not nested inside "
                        f"its parent {parent!r}")
    # 3. at least one comm leg overlaps a compute span — the measured
    #    counterpart of the schedule trace.validate admits
    legs = [(r.t_start, r.t_start + r.value)
            for r in spans if r.name == "comm.leg"]
    comps = [(r.t_start, r.t_start + r.value)
             for r in spans if r.name == "comm.compute"]
    if legs and comps:
        if not any(max(a0, c0) < min(a1, c1)
                   for a0, a1 in legs for c0, c1 in comps):
            errs.append("no comm.leg span overlaps any comm.compute span")
    elif legs or comps:
        errs.append("trace has comm legs xor compute spans — "
                    "instrumentation incomplete")
    return errs


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trace", type=pathlib.Path, help="span JSONL "
                    "(DiTServer(profile=True) with a JsonlTracker, or "
                    "launch/commcheck.py --profile)")
    ap.add_argument("--chrome", type=pathlib.Path, default=None,
                    metavar="OUT.json",
                    help="write Chrome trace-event JSON (Perfetto)")
    ap.add_argument("--check", action="store_true",
                    help="CI assertions: chrome parses, spans nest, "
                         "comm overlaps compute")
    ap.add_argument("--inter-axes", default="pod", metavar="AX[,AX]",
                    help="mesh axes counted as machine-crossing for "
                         "residual classification (default: pod)")
    ap.add_argument("--net", type=pathlib.Path, default=None,
                    help="calibration JSON (NetworkModel fields); "
                         "default: nominal NetworkModel")
    args = ap.parse_args(argv)

    spans = load_spans(args.trace)
    net = load_network_model(args.net) if args.net else NetworkModel()
    chrome = chrome_trace(spans)
    if args.chrome is not None:
        args.chrome.write_text(json.dumps(chrome))
        print(f"# wrote {args.chrome} ({len(spans)} spans, "
              f"{len({track_of(r) for r in spans})} tracks)", file=sys.stderr)

    rows = overlap_table(spans)
    if rows:
        print(format_overlap(rows))
        print()
    inter = frozenset(a for a in args.inter_axes.split(",") if a)
    res = leg_residuals(spans, net, inter)
    if res:
        print(format_residuals(res, step_residuals(spans, net), net))
    if not rows and not res:
        print(f"# {args.trace}: no comm spans "
              f"({len(spans)} host spans only)")

    if args.check:
        errs = check_trace(spans, chrome)
        if errs:
            for e in errs:
                print(f"CHECK FAIL: {e}", file=sys.stderr)
            raise SystemExit(1)
        print(f"# check OK: {len(spans)} spans", file=sys.stderr)


if __name__ == "__main__":
    main()
