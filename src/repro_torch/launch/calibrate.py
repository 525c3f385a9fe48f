"""Fit NetworkModel parameters to measured step latencies (the counterpart of
the reference's ``scripts/calibrate_comm.py``, with its record format,
``load_records``, ``predict_us``, ``fit`` and CLI):

    PYTHONPATH=src python -m repro_torch.launch.calibrate BENCH_x.json \
        [--out calibration.json]

A record file is JSON with a ``records`` list; each record names its
``workload`` (batch, seq, heads, head_dim, n_layers), its ``plan`` (cfg,
pp, p_ulysses, p_ring, num_patches), the cluster shape (``n_machines``,
``m_per_machine``) and the measured ``measured_step_us``.  Records without
a measurement are skipped.  An optional ``guided`` (default true, as the
reference scores every record) says whether the step ran the guidance
branches.  The fit is the port's copy of the damped Gauss-Newton solver
(core/calibration.py) over the port's comm model and planner.

The port's nominal ``NetworkModel`` holds NVIDIA H100 SXM terms (NVLink
450 GB/s, InfiniBand 50 GB/s, 989 TFLOP/s bf16), so the fit starts there
and its ``ratio_vs_nominal`` is against those terms.  On one card every
record is a degree-1 step (one machine of one device): the model then has
no wire term, and only ``mfu``, the attention kernel's share of the
card's peak, is identified; the damping holds the wire terms where they
start.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from ..core import calibration
from ..core.calibration import FIT_PARAMS
from ..core.comm_model import LayerWorkload, NetworkModel, plan_step_latency
from ..core.planner import plan_hybrid

__all__ = ["FIT_PARAMS", "fit", "load_records", "main", "predict_us"]


def load_records(paths: list[pathlib.Path]) -> list[dict]:
    """Records with a fit target, from any mix of record files."""
    out = []
    for p in paths:
        payload = json.loads(pathlib.Path(p).read_text())
        for rec in payload.get("records", []):
            if rec.get("measured_step_us") is None:
                continue
            if "workload" not in rec or "plan" not in rec:
                continue
            out.append(rec)
    return out


def predict_us(rec: dict, net: NetworkModel) -> float:
    """Re-run the comm model on one record's configuration.

    The (cfg, pp) split is re-planned with ``plan_hybrid``, which is
    deterministic given the recorded cluster shape, so the prediction is
    the one the record's planner made."""
    wl = rec["workload"]
    w = LayerWorkload(batch=wl["batch"], seq=wl["seq"], heads=wl["heads"],
                      head_dim=wl["head_dim"])
    pl = rec["plan"]
    h = plan_hybrid(rec["n_machines"], rec["m_per_machine"], wl["heads"],
                    cfg_parallel=pl["cfg"] > 1, cfg_degree=max(pl["cfg"], 2),
                    pp=pl["pp"], n_layers=wl["n_layers"])
    assert (h.sp.p_ulysses, h.sp.p_ring) == (pl["p_ulysses"], pl["p_ring"]), (
        f"{rec['name']}: re-planned SP split {h.sp.p_ulysses}x{h.sp.p_ring} "
        f"!= recorded {pl['p_ulysses']}x{pl['p_ring']}")
    pred = plan_step_latency(h, w, net, n_layers=wl["n_layers"],
                             guided=rec.get("guided", True),
                             num_patches=pl.get("num_patches"))
    return pred["t_step"] * 1e6


def fit(recs: list[dict], *, iters: int = 40, damping: float = 1e-3,
        fd_eps: float = 1e-5) -> tuple[NetworkModel, dict]:
    """Fit the shared solver to record dicts from the port's nominal model;
    returns (model, report dict)."""
    assert recs, "no records with measured_step_us — nothing to fit"
    net, report = calibration.fit(recs, predict_us, iters=iters,
                                  damping=damping, fd_eps=fd_eps)
    return net, report.as_dict()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("bench", nargs="+", type=pathlib.Path,
                    help="record files with measured_step_us filled in")
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="write the fitted NetworkModel JSON here "
                         "(stdout otherwise)")
    args = ap.parse_args(argv)
    recs = load_records(args.bench)
    if not recs:
        print("no records with measured_step_us in "
              f"{[str(p) for p in args.bench]}", file=sys.stderr)
        return 1
    net, report = fit(recs)
    payload = {k: getattr(net, k) for k in FIT_PARAMS}
    payload["fit"] = report
    text = json.dumps(payload, indent=1, sort_keys=True)
    if args.out:
        args.out.write_text(text)
        print(f"wrote {args.out}", file=sys.stderr)
    else:
        print(text)
    print(f"fit: {report['n_records']} records, rms rel error "
          f"{report['rms_rel_error']:.4f}", file=sys.stderr)
    for k, v in report["ratio_vs_nominal"].items():
        print(f"  {k}: x{v:.3f} vs nominal", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
