"""The port's copies of framework-free modules give the same outputs as
the originals on the same inputs: planner, comm model (with the same
NetworkModel handed to both), calibration, request scheduler, drift
policy and metrics.  Unchanged copies are also pinned byte for byte."""
import dataclasses
import pathlib

import numpy as np
import pytest

from repro import configs as j_configs
from repro.core import comm_model as j_cm
from repro.core import calibration as j_cal
from repro.core import planner as j_pl
from repro.core.pipefusion import PipelineConfig as JPipe
from repro.serving import metrics as j_met
from repro.serving import sched as j_sched
from repro_torch import configs as t_configs
from repro_torch.core import calibration as t_cal
from repro_torch.core import comm_model as t_cm
from repro_torch.core import planner as t_pl
from repro_torch.core.pipefusion import PipelineConfig as TPipe
from repro_torch.serving import metrics as t_met
from repro_torch.serving import sched as t_sched

ROOT = pathlib.Path(__file__).resolve().parents[1] / "src"
DENSE_CONFIGS = ["qwen2_1_5b", "stablelm_3b", "starcoder2_7b", "chatglm3_6b",
                 "qwen2_vl_2b"]
HYBRID_MOE_CONFIGS = ["hymba_1_5b", "qwen2_moe_a2_7b", "arctic_480b"]
AUDIO_CONFIGS = ["whisper_tiny"]
VERBATIM = ["configs/base.py", "configs/flux_12b.py", "configs/rwkv6_1_6b.py",
            "configs/cogvideox_5b.py", "configs/shapes.py",
            *(f"configs/{n}.py" for n in DENSE_CONFIGS),
            *(f"configs/{n}.py" for n in HYBRID_MOE_CONFIGS),
            *(f"configs/{n}.py" for n in AUDIO_CONFIGS),
            "core/calibration.py",
            "serving/metrics.py",
            "serving/fleet.py",
            *(f"serving/sched/{n}.py" for n in (
                "__init__", "admission", "bucketer", "control", "drift",
                "forecast", "plan_cache", "scheduler"))]


@pytest.mark.parametrize("rel", VERBATIM)
def test_copy_is_verbatim(rel):
    assert ((ROOT / "repro_torch" / rel).read_text()
            == (ROOT / "repro" / rel).read_text())


@pytest.mark.parametrize("arch", ["flux-12b", "cogvideox-5b", "rwkv6-1.6b",
                                  *t_configs.DENSE_ARCHS,
                                  *t_configs.HYBRID_ARCHS,
                                  *t_configs.MOE_ARCHS,
                                  *t_configs.AUDIO_ARCHS])
@pytest.mark.parametrize("which", ["get_config", "get_reduced"])
def test_config_equals_reference(arch, which):
    """Every field of the port's config, full and reduced, equals the
    reference's."""
    assert arch in t_configs.ALL_ARCHS
    mine = dataclasses.asdict(getattr(t_configs, which)(arch))
    ref = dataclasses.asdict(getattr(j_configs, which)(arch))
    assert mine == ref


@pytest.mark.parametrize("mode", ["serve", "train"])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "arctic-480b",
                                  "hymba-1.5b", "flux-12b"])
def test_sharding_rules_equal_reference(arch, mode):
    """models/sharding.py's rule tables and ``rules_for`` (which moe_block
    reads to pick the token-gather decode) equal the reference's, with
    and without extra rules."""
    from repro.models import sharding as j_sh
    from repro_torch.models import sharding as t_sh

    assert t_sh.BASE_RULES == j_sh.BASE_RULES
    assert t_sh.TRAIN_EXTRAS == j_sh.TRAIN_EXTRAS
    for extra in (None, {"layers": ("pipe",)}):
        assert t_sh.rules_for(t_configs.get_config(arch), mode, extra) == \
            j_sh.rules_for(j_configs.get_config(arch), mode, extra)


def test_sharding_rules_are_a_copy():
    """The rules part of models/sharding.py is the reference's text."""
    start = "# logical axis -> tuple of mesh axes"
    mine = _between((ROOT / "repro_torch/models/sharding.py").read_text(),
                    start, None)
    ref = _between((ROOT / "repro/models/sharding.py").read_text(), start,
                   "\n\n\ndef _spec_of")
    assert mine.rstrip() == ref.rstrip()


def test_dit_archs_and_shapes_equal_reference():
    """The port serves every DiT of the reference, and its input shapes
    (the paper's DiT workloads among them) are the reference's."""
    assert t_configs.DIT_ARCHS == j_configs.DIT_ARCHS
    for name in ("SHAPES", "DIT_SHAPES"):
        mine, ref = getattr(t_configs, name), getattr(j_configs, name)
        assert {k: dataclasses.asdict(v) for k, v in mine.items()} == {
            k: dataclasses.asdict(v) for k, v in ref.items()}


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


def _between(text: str, start: str, end: str | None) -> str:
    i = text.index(start)
    return text[i:text.index(end, i) if end else len(text)]


def test_trace_recording_is_a_copy():
    """The framework-free half of comm/trace.py (recording and semaphore
    validation) is the reference's text, unchanged; the port's eager
    validation follows it in sections of its own."""
    start = "# -------------------------------------------------------------"\
            "--------------\n# schedule recording"
    mine = _between((ROOT / "repro_torch/comm/trace.py").read_text(), start,
                    "# -----------------------------------------------------"
                    "----------------------\n# the eager schedule")
    ref = _between((ROOT / "repro/comm/trace.py").read_text(), start,
                   "# -----------------------------------------------------"
                   "----------------------\n# HLO parsing")
    assert mine.rstrip() == ref.rstrip()


def test_group_layout_is_a_copy():
    """GroupLayout keeps the reference's fields, static coordinates and
    perm tables verbatim; only the traced ``my_coords`` family is replaced
    by per-rank arithmetic."""
    mine = (ROOT / "repro_torch/core/collectives.py").read_text()
    ref = (ROOT / "repro/core/collectives.py").read_text()
    head = "@dataclasses.dataclass(frozen=True)\nclass GroupLayout:"
    assert _between(mine, head, "    # -- permutation tables") == _between(
        ref, head, "    # -- traced coordinates")
    perms = "    # -- permutation tables"
    assert _between(mine, perms, "\n\n\n").rstrip() == _between(
        ref, perms, "    def seq_offset_of_rank").rstrip()


def test_semaphore_validation_equal():
    """The same recorded schedules get the same verdicts in both copies."""
    from repro.comm import trace as j_tr
    from repro_torch.comm import trace as t_tr

    def schedules(tr):
        ev = lambda kind, sem, overlap=False: tr.SemEvent(
            kind=kind, sem=sem, overlap=overlap)
        good = [ev("put", "a", True), ev("signal", "a"), ev("compute", ""),
                ev("wait", "a")]
        return [good, [ev("wait", "a")] + good,
                [ev("put", "a", True), ev("signal", "a"), ev("wait", "a")],
                [ev("put", "b"), ev("signal", "b"), ev("signal", "b")],
                [ev("signal", "c"), ev("put", "a"), ev("put", "a")]]

    for mine, ref in zip(schedules(t_tr), schedules(j_tr)):
        a = t_tr.validate_semaphores(t_tr.ScheduleTrace("s", sem_events=mine))
        b = j_tr.validate_semaphores(j_tr.ScheduleTrace("s", sem_events=ref))
        assert (a.puts, a.waits, a.failures, a.summary()) == (
            b.puts, b.waits, b.failures, b.summary())



@pytest.mark.parametrize("wire", ["float8_e4m3fn", "float8_e5m2"])
def test_wire_codec_equal(wire):
    """comm/compress.py: the same payload bytes, scale and residual as the
    reference's codec (tests/test_torch_hier.py covers more inputs)."""
    import jax.numpy as jnp
    import torch

    from repro.comm import compress as j_c
    from repro_torch.comm import compress as t_c

    rng = np.random.default_rng(5)
    x = (rng.standard_normal((48, 80)) * 3).astype(np.float32)
    err = (rng.standard_normal(x.shape) * 1e-3).astype(np.float32)
    tw, ts, te = t_c.ef_encode(torch.from_numpy(x), torch.from_numpy(err),
                               wire)
    jw, js, je = j_c.ef_encode(jnp.asarray(x), jnp.asarray(err), wire)
    assert np.array_equal(tw.view(torch.uint8).numpy(),
                          np.asarray(jw).view(np.uint8))
    assert ts.item() == float(js)
    assert np.array_equal(te.numpy(), np.asarray(je))
    tq, tsq = t_c.quantize(torch.from_numpy(x), wire)
    jq, jsq = j_c.quantize(jnp.asarray(x), wire)
    assert np.array_equal(
        t_c.dequantize(tq, tsq, torch.float32).numpy(),
        np.asarray(j_c.dequantize(jq, jsq, jnp.float32)))


def _leg_events(prof_mod):
    """One synthetic event stream: comm legs hidden, exposed, unsignalled
    and on two tracks, a compute block, and events before the epoch."""
    p = prof_mod.CommProfiler()
    comm_kw = dict(kind="comm", stream="torus", channel="torus.hop1",
                   stage=2, axes=("pod", "model"), nbytes=4096,
                   n_tensors=2, backend="pallas", intent="diag-KV attend")
    a, b = p.new_leg(**comm_kw), p.new_leg(**comm_kw)
    c = p.new_leg(kind="compute", stream="ring", channel="ring attend",
                  stage=0, axes=("model",), nbytes=0, n_tensors=0,
                  backend="", intent="", label="ring attend")
    ev = prof_mod.LegEvent
    p.events = [
        ev(a, "issue", (0, 1), 1.0), ev(a, "signal", (0, 1), 1.01),
        ev(a, "wait", (0, 1), 1.02), ev(a, "issue", (0, 1), 2.0),
        ev(a, "wait", (0, 1), 2.005), ev(a, "signal", (0, 1), 2.008),
        ev(a, "issue", (1, 0), 3.0), ev(b, "issue", (), 0.5),
        ev(b, "issue", (), 4.0), ev(b, "signal", (), 4.5),
        ev(c, "start", (), 0.2), ev(c, "end", (), 1.5),
        ev(c, "end", (), 1.6), ev(c, "start", (), 2.0),
        ev(c, "end", (), 2.25)]
    return p


def test_profiler_pairing_equal():
    """comm/profiler.py's ``emit_leg_spans``: the same events give the same
    spans in both packages.  The port adds one tag, ``ranks`` (the rank
    count of the route one put covers)."""
    from repro.comm import profiler as j_prof
    from repro_torch.comm import profiler as t_prof

    def spans(prof_mod, met):
        t = met.RecordingTracker()
        t.epoch = 0.7
        n = prof_mod.emit_leg_spans(_leg_events(prof_mod), t)
        recs = [{k: v for k, v in r.to_dict().items() if k != "t"}
                for r in t.records]
        for r in recs:
            r["tags"].pop("ranks", None)
        return n, recs

    mine, ref = spans(t_prof, t_met), spans(j_prof, j_met)
    assert mine == ref and mine[0] == 6


def test_fleet_cli_is_a_copy():
    """launch/fleet.py is the reference's below its docstring; the
    docstring differs only in the usage line's package name."""
    mine = (ROOT / "repro_torch/launch/fleet.py").read_text()
    ref = (ROOT / "repro/launch/fleet.py").read_text()
    end = '"""\nfrom __future__'
    assert mine[mine.index(end):] == ref[ref.index(end):]
    assert mine[:mine.index(end)].replace("repro_torch.launch", "repro.launch") \
        == ref[:ref.index(end)]


def test_serving_exports_cover_the_reference():
    """The port's ``repro_torch.serving`` exports every name the
    reference's ``repro.serving`` does."""
    import repro.serving as j_srv
    import repro_torch.serving as t_srv

    assert set(j_srv.__all__) <= set(t_srv.__all__)
    for name in t_srv.__all__:
        assert getattr(t_srv, name) is not None
