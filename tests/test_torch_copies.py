"""The port's copies of framework-free modules give the same outputs as
the originals on the same inputs: planner, comm model (with the same
NetworkModel handed to both), calibration, request scheduler, drift
policy and metrics.  Unchanged copies are also pinned byte for byte."""
import dataclasses
import pathlib

import numpy as np
import pytest

from repro.core import comm_model as j_cm
from repro.core import calibration as j_cal
from repro.core import planner as j_pl
from repro.core.pipefusion import PipelineConfig as JPipe
from repro.serving import metrics as j_met
from repro.serving import sched as j_sched
from repro_torch.core import calibration as t_cal
from repro_torch.core import comm_model as t_cm
from repro_torch.core import planner as t_pl
from repro_torch.core.pipefusion import PipelineConfig as TPipe
from repro_torch.serving import metrics as t_met
from repro_torch.serving import sched as t_sched

ROOT = pathlib.Path(__file__).resolve().parents[1] / "src"
VERBATIM = ["configs/base.py", "configs/flux_12b.py", "core/calibration.py",
            "serving/metrics.py",
            *(f"serving/sched/{n}.py" for n in (
                "__init__", "admission", "bucketer", "control", "drift",
                "forecast", "plan_cache", "scheduler"))]


@pytest.mark.parametrize("rel", VERBATIM)
def test_copy_is_verbatim(rel):
    assert ((ROOT / "repro_torch" / rel).read_text()
            == (ROOT / "repro" / rel).read_text())


def _asdict(x):
    if dataclasses.is_dataclass(x):
        return dataclasses.asdict(x)
    if isinstance(x, tuple):
        return tuple(_asdict(v) for v in x)
    if isinstance(x, list):
        return [_asdict(v) for v in x]
    return x


def _outcome(fn, *args, **kw):
    """fn's result as plain data, or its exception's type and message."""
    try:
        return _asdict(fn(*args, **kw))
    except ValueError as e:
        return ("ValueError", str(e))


PLAN_GRID = [(n, m, h, hkv) for n in (1, 2, 4) for m in (1, 4, 8)
             for h, hkv in ((24, 24), (8, 4), (6, 6))]


@pytest.mark.parametrize("n,m,h,hkv", PLAN_GRID)
def test_planner_equal(n, m, h, hkv):
    for swift in (True, False):
        assert _asdict(t_pl.plan(n, m, h, hkv, swift=swift)) == _asdict(
            j_pl.plan(n, m, h, hkv, swift=swift))
    for cfg_parallel in (False, True):
        kw = dict(cfg_parallel=cfg_parallel, n_layers=8)
        assert _outcome(t_pl.plan_hybrid, n, m, h, hkv, **kw) == _outcome(
            j_pl.plan_hybrid, n, m, h, hkv, **kw)
    assert _asdict(t_pl.candidate_hybrid_plans(n, m, h, hkv, n_layers=8)) \
        == _asdict(j_pl.candidate_hybrid_plans(n, m, h, hkv, n_layers=8))


def test_comm_model_defaults_are_h100():
    net = t_cm.NetworkModel()
    assert net.flops == 989e12 and net.intra_bw == 4.5e11
    # every other field is a copy: only the hardware terms changed
    assert [f.name for f in dataclasses.fields(net)] == [
        f.name for f in dataclasses.fields(j_cm.NetworkModel())]


@pytest.mark.parametrize("seq", [1280, 4352, 17408])
def test_comm_model_equal(seq):
    fields = dataclasses.asdict(j_cm.NetworkModel())
    jnet, tnet = j_cm.NetworkModel(**fields), t_cm.NetworkModel(**fields)
    for n, m in ((1, 1), (2, 4), (4, 8)):
        kw = dict(seq=seq, batch=2, head_dim=128, n_layers=96, num_steps=4)
        jp, jpred = j_pl.plan_for_shape(n, m, 24, 24, net=jnet, **kw)
        tp, tpred = t_pl.plan_for_shape(n, m, 24, 24, net=tnet, **kw)
        assert _asdict(tp) == _asdict(jp) and tpred == jpred
        for h in j_pl.candidate_hybrid_plans(n, m, 24, 24, n_layers=96):
            th = t_pl.HybridPlan(**{
                k: (t_pl.SPPlan(**v) if k == "sp" else v)
                for k, v in dataclasses.asdict(h).items()})
            wl = dict(batch=2, seq=seq, heads=24, head_dim=128)
            for backend in ("xla", "pallas"):
                assert t_cm.plan_step_latency(
                    th, t_cm.LayerWorkload(**wl), tnet, n_layers=96,
                    comm_backend=backend) == j_cm.plan_step_latency(
                    h, j_cm.LayerWorkload(**wl), jnet, n_layers=96,
                    comm_backend=backend)


def test_calibration_fit_equal():
    rng = np.random.default_rng(0)
    obs = [{"scale": float(s), "measured_step_us": float(t)}
           for s, t in zip(rng.integers(1, 9, 12), rng.uniform(50, 500, 12))]

    def predict_us(o, net):
        return (o["scale"] * 1e14 / net.flops + o["scale"] * 1e11 / net.intra_bw
                + net.intra_lat * 1e6 + net.mfu * 10.0)

    start = dataclasses.asdict(j_cm.NetworkModel())
    jnet, jrep = j_cal.fit(obs, predict_us, start=j_cm.NetworkModel(**start),
                           iters=10)
    tnet, trep = t_cal.fit(obs, predict_us, start=t_cm.NetworkModel(**start),
                           iters=10)
    assert dataclasses.asdict(tnet) == dataclasses.asdict(jnet)
    assert trep.n_obs == jrep.n_obs
    assert trep.rms_rel_error == jrep.rms_rel_error


@dataclasses.dataclass
class Req:
    rid: int
    seq_len: int
    submitted: float = 0.0
    sla: float | None = None
    drift_threshold: float | None = None


def _run_scheduler(sched_mod, cm):
    fields = dataclasses.asdict(j_cm.NetworkModel())
    cache = sched_mod.PlanCache(n_machines=2, m_per_machine=4, heads=8,
                                head_dim=64, n_layers=8, num_steps=4, dp=2,
                                net=cm.NetworkModel(**fields))
    cfg = sched_mod.SchedConfig(max_batch=4, dp=2, starvation_age=10.0,
                                aging_rate=1.0, default_slack=100.0,
                                defer_slack=1.0)
    s = sched_mod.RequestScheduler(cache, cfg)
    seqs = [256, 512, 256, 1024, 512, 256, 1024, 256, 4096]
    for i, n in enumerate(seqs):
        s.submit(Req(i, n, sla=5.0 if i % 3 == 0 else None), now=0.01 * i)
    out = []
    while s.pending:
        adm = s.next_batch(1.0, flush=True)
        out.append(([r.rid for r in adm.requests], adm.seq_len,
                    adm.batch_rows, adm.pad_rows, adm.plan.t_step,
                    adm.plan.num_patches))
    return out, cache.tracker.summary()


def test_scheduler_equal():
    assert _run_scheduler(t_sched, t_cm) == _run_scheduler(j_sched, j_cm)


def test_drift_policy_equal():
    kw = dict(warmup_steps=2, resync_every=3, pp=2)
    jp, tp = JPipe(**kw), TPipe(**kw)
    jd, td = j_sched.DriftPolicy(0.1), t_sched.DriftPolicy(0.1)
    for step in range(8):
        for last in (None, [0.05, 0.2], [0.0, 0.01]):
            assert td.warm(tp, step, last, [None, 0.3]) == jd.warm(
                jp, step, last, [None, 0.3])
        assert tp.warm_step(step) == jp.warm_step(step)


def _drive_tracker(met):
    tr = met.RecordingTracker()
    for i in range(5):
        tr.count("engine.completed", tags={"seq": 256 * (i % 2)})
        tr.log("engine.t_step_s", 0.1 * i, step=i, tags={"seq": 256})
        tr.span_event("sampler.step", 0.5 * i, 0.25, step=i,
                      tags={"warm": i == 0})
    recs = [{k: v for k, v in r.to_dict().items() if k != "t"}
            for r in tr.records]
    return recs, tr.summary(), tr.format_summary()


def test_metrics_equal():
    assert _drive_tracker(t_met) == _drive_tracker(j_met)
