"""The port's span profiler, profiled serving and schedule gate on the CPU.

* The profiler's sink and pairing: the cases of tests/test_profiler.py
  (synthetic ``LegEvent`` streams; tests/test_torch_copies.py pins the
  pairing to the reference's on the same events).
* Observations of a real put: issue before signal before wait, one leg per
  put on the device's track, with ``nbytes`` per rank and the ``ranks``
  tag.
* ``DiTServer(profile=True)`` on reduced flux-12b under swift_torus over
  virtual ranks: latents bitwise those of ``profile=False``; ``engine.step``,
  ``comm.leg`` and ``comm.compute`` spans; the JSONL passes the reference's
  own ``scripts/trace_report.py --check`` (with jax), and the port's
  ``launch/trace_report.py`` prints the same report.  The same for a
  pipelined server, which adds the ``pipe`` hand-off legs.
* ``launch/commcheck.py --device cpu`` exits 0 with six OK lines, and 1
  when the torus hops are waited before any compute.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch import comm
from repro_torch.comm.profiler import (
    CommProfiler,
    LegEvent,
    active,
    emit_leg_spans,
    mark_compute,
    profile,
)
from repro_torch.configs import get_reduced
from repro_torch.core import PipelineConfig, SPConfig
from repro_torch.core import torus as t_torus
from repro_torch.launch import commcheck, make_hybrid_mesh, make_mesh
from repro_torch.launch import trace_report as t_report
from repro_torch.models import init_dit
from repro_torch.serving import (
    DiTRequest,
    DiTServer,
    JsonlTracker,
    RecordingTracker,
    SamplerConfig,
)
from repro_torch.serving.metrics import read_jsonl, validate_record

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _comm_meta(prof, **kw):
    base = dict(kind="comm", stream="ring", channel="ring.shift1", stage=0,
                axes=("pod", "model"), nbytes=2048, n_tensors=2,
                backend="xla", intent="ring attend")
    base.update(kw)
    return prof.new_leg(**base)


def _ev(meta, phase, coords, t):
    return LegEvent(meta, phase, coords, t)


def _fresh_tracker():
    t = RecordingTracker()
    t.epoch = 0.0  # synthetic event times below are absolute-from-zero
    return t


# ---------------------------------------------------------------------------
# sink mechanics (tests/test_profiler.py)
# ---------------------------------------------------------------------------

def test_profile_context_sets_and_restores_active():
    assert active() is None
    p = CommProfiler()
    with profile(p) as got:
        assert got is p and active() is p
        with profile(CommProfiler()) as inner:
            assert active() is inner
        assert active() is p
    assert active() is None


def test_new_leg_ids_monotone_and_record_never_raises():
    p = CommProfiler()
    a = _comm_meta(p)
    b = _comm_meta(p, channel="torus.hop1")
    assert (a.leg, b.leg) == (0, 1)
    p._record(a, "issue", [0, 1])
    p._record(a, "signal", object())  # uncoercible coords must not raise
    assert [e.coords for e in p.events] == [(0, 1), ()]


def test_take_drains_atomically():
    p = CommProfiler()
    p._record(_comm_meta(p), "issue", [0])
    assert len(p.take()) == 1
    assert p.take() == [] and p.events == []


def test_mark_compute_is_noop_without_active_profiler():
    with mark_compute("attend", ("model",), CPU):
        pass
    assert active() is None


def test_comm_leg_pairing_and_exposure():
    p = CommProfiler()
    m = _comm_meta(p)
    # occurrence 0: signal lands BEFORE the consumer waits (fully hidden);
    # occurrence 1: the wait beats the signal by 3ms (exposed stall)
    p.events = [
        _ev(m, "issue", (0, 1), 1.000), _ev(m, "signal", (0, 1), 1.010),
        _ev(m, "wait", (0, 1), 1.020), _ev(m, "issue", (0, 1), 2.000),
        _ev(m, "wait", (0, 1), 2.005), _ev(m, "signal", (0, 1), 2.008),
    ]
    t = _fresh_tracker()
    n = emit_leg_spans(p, t)
    legs = [r for r in t.records if r.name == "comm.leg"]
    stalls = [r for r in t.records if r.name == "comm.exposed_wait"]
    assert n == len(legs) + len(stalls) == 3
    assert [r.tags["occ"] for r in legs] == [0, 1]
    assert legs[0].tags["exposed_s"] == 0.0
    assert legs[0].t_start == pytest.approx(1.0)
    assert legs[0].value == pytest.approx(0.010)
    assert legs[1].tags["exposed_s"] == pytest.approx(0.003)
    (stall,) = stalls
    assert stall.t_start == pytest.approx(2.005)
    assert stall.value == pytest.approx(0.003)
    assert stall.tags["track"] == "pod=0,model=1"
    for r in t.records:
        assert validate_record(r.to_dict()) == []
    assert emit_leg_spans(p, t) == 0  # drained


def test_unsignaled_occurrence_dropped():
    p = CommProfiler()
    m = _comm_meta(p)
    p.events = [_ev(m, "issue", (0, 0), 1.0), _ev(m, "issue", (0, 0), 2.0),
                _ev(m, "signal", (0, 0), 2.1)]
    t = _fresh_tracker()
    assert emit_leg_spans(p, t) == 1
    (leg,) = [r for r in t.records if r.name == "comm.leg"]
    assert leg.t_start == pytest.approx(2.0)


def test_per_device_timelines_are_separate():
    p = CommProfiler()
    m = _comm_meta(p)
    p.events = [
        _ev(m, "issue", (0, 0), 1.00), _ev(m, "issue", (0, 1), 1.01),
        _ev(m, "signal", (0, 1), 1.02), _ev(m, "signal", (0, 0), 1.03),
    ]
    t = _fresh_tracker()
    assert emit_leg_spans(p, t) == 2
    tracks = {r.tags["track"]: r.value for r in t.records}
    assert tracks["pod=0,model=0"] == pytest.approx(0.03)
    assert tracks["pod=0,model=1"] == pytest.approx(0.01)


def test_compute_block_pairing():
    p = CommProfiler()
    m = p.new_leg(kind="compute", stream="ring", channel="ring attend",
                  stage=0, axes=("model",), nbytes=0, n_tensors=0,
                  backend="", intent="", label="ring attend")
    p.events = [_ev(m, "start", (2,), 1.0), _ev(m, "end", (2,), 1.5),
                _ev(m, "start", (2,), 2.0), _ev(m, "end", (2,), 2.25),
                _ev(m, "end", (2,), 3.0)]  # end without start: ignored
    t = _fresh_tracker()
    assert emit_leg_spans(p, t) == 2
    assert all(r.name == "comm.compute" for r in t.records)
    assert [r.value for r in t.records] == pytest.approx([0.5, 0.25])
    assert [r.tags["occ"] for r in t.records] == [0, 1]


def test_pre_epoch_events_clamp_to_zero():
    p = CommProfiler()
    m = _comm_meta(p)
    p.events = [_ev(m, "issue", (0, 0), 1.0), _ev(m, "signal", (0, 0), 1.2)]
    t = RecordingTracker()
    t.epoch = 5.0  # epoch after every event
    assert emit_leg_spans(p, t) == 1
    (leg,) = t.records
    assert leg.t_start == 0.0
    assert validate_record(leg.to_dict()) == []


# ---------------------------------------------------------------------------
# observations of real puts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_a_put_is_one_leg_on_the_device_track(backend):
    x = [torch.full((3, 5), float(r)) for r in range(8)]
    ch = comm.Channel(("model",), tuple(comm.shift_perm(8)), name="c",
                      stream="s", backend=backend)
    prof = CommProfiler()
    with profile(prof):
        fut = ch.put(x, overlaps="attend")
        with mark_compute("attend", ("model",), CPU):
            pass
        fut.wait()
    phases = [e.phase for e in prof.events]
    assert phases == ["issue", "signal", "start", "end", "wait"]
    times = [e.t for e in prof.events]
    assert times == sorted(times)
    t = _fresh_tracker()
    assert emit_leg_spans(prof, t) == 2
    leg = next(r for r in t.records if r.name == "comm.leg")
    assert leg.tags["track"] == "dev" and leg.tags["ranks"] == 8
    assert leg.tags["nbytes"] == 15 * 4  # one rank's bytes
    assert leg.tags["exposed_s"] == 0.0 and leg.tags["backend"] == backend


# ---------------------------------------------------------------------------
# profiled serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flux():
    cfg = dataclasses.replace(get_reduced("flux-12b"), dtype="float32")
    params = init_dit(cfg, torch.Generator().manual_seed(0), "cpu")
    # perturb the zero-initialised adaLN and output weights, so that the
    # latents depend on every layer
    g = torch.Generator().manual_seed(1)
    for lp in params["layers"]:
        w = lp["ada"]["w"]
        w.copy_(torch.randn(w.shape, generator=g) * 0.02)
    for name in ("ada_f", "proj_out"):
        w = params[name]["w"]
        w.copy_(torch.randn(w.shape, generator=g) * 0.02)
    return cfg, params


def _serve(flux, sp, mesh, sampler, profile_on, path=None):
    cfg, params = flux
    tracker = JsonlTracker(path) if path is not None else None
    srv = DiTServer(params, cfg, sp, mesh=mesh, sampler=sampler,
                    tracker=tracker, profile=profile_on, max_batch=1)
    srv.submit(DiTRequest(rid=0, seq_len=64))
    (res,) = srv.serve()
    if tracker is not None:
        tracker.close()
    return res.latents


def _check_with_both_reports(path: pathlib.Path) -> str:
    """The reference's scripts/trace_report.py --check and the port's
    launch/trace_report.py on the same file: both pass and print the same
    overlap table."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "trace_report.py"),
         str(path), "--check"], env=env, capture_output=True, text=True,
        timeout=300)
    assert ref.returncode == 0, ref.stderr
    mine = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.trace_report", str(path),
         "--check"], env=env, capture_output=True, text=True, timeout=300)
    assert mine.returncode == 0, mine.stderr
    # the overlap table is the same; the residuals differ by the models'
    # default terms (the port's NetworkModel holds the H100's)
    table = mine.stdout.split("per-leg NetworkModel residuals")[0]
    assert table == ref.stdout.split("per-leg NetworkModel residuals")[0]
    assert "overlap efficiency" in table and "check OK" in mine.stderr
    return mine.stdout


def _spans(path, name):
    return [r for r in read_jsonl(path)
            if r.kind == "span" and r.name == name]


def test_profiled_serve_is_bitwise_and_passes_both_reports(flux, tmp_path):
    """swift_torus on mesh (pod 2, model 4): P_u 4 x P_r 2, so the torus
    hops, the fused ring puts (K2's plain version) and the Push-O all
    show.  On the CPU only the fused puts overlap a compute span in time:
    everything else runs in program order."""
    mesh = make_mesh((2, 4), ("pod", "model"), device="cpu")
    sp = SPConfig(strategy="swift_torus", sp_axes=("pod", "model"),
                  batch_axes=None, comm_backend="pallas")
    sc = SamplerConfig(num_steps=2)
    path = tmp_path / "serve.jsonl"
    plain = _serve(flux, sp, mesh, sc, False)
    got = _serve(flux, sp, mesh, sc, True, path)
    assert torch.equal(got, plain)
    steps = _spans(path, "engine.step")
    assert [r.step for r in steps] == [0, 1]
    assert all(r.tags["pred_t_step_s"] > 0 and r.tags["pred_compute_s"] > 0
               for r in steps)
    legs = _spans(path, "comm.leg")
    hops = [r for r in legs if r.tags["stream"] == "torus"]
    assert hops and all(r.tags["intent"] for r in hops)
    assert {r.tags["track"] for r in legs} == {"dev"}
    assert {r.tags["ranks"] for r in legs} == {8}
    labels = {r.tags["label"] for r in _spans(path, "comm.compute")}
    assert "ring attend" in labels
    report = _check_with_both_reports(path)
    assert "torus/torus.hop1" in report and "a2a.inv/a2a.inv.hop1" in report


def test_profiled_pipelined_serve_adds_pipe_legs(flux, tmp_path):
    """The warm step runs swift_torus on 8 model ranks (P_u 4 x P_r 2, so
    its fused ring puts overlap compute), the displaced steps hand each
    patch over the pipe axis."""
    mesh = make_hybrid_mesh(cfg=1, pipe=2, data=1, model=8, device="cpu")
    sp = SPConfig(strategy="swift_torus", sp_axes=("model",),
                  batch_axes=("data",), pp_axis="pipe", cfg_axis="cfg",
                  comm_backend="pallas")
    sc = SamplerConfig(num_steps=3, pipeline=PipelineConfig(
        pp=2, num_patches=2, warmup_steps=1))
    path = tmp_path / "pipe.jsonl"
    plain = _serve(flux, sp, mesh, sc, False)
    got = _serve(flux, sp, mesh, sc, True, path)
    assert torch.equal(got, plain)
    assert [r.tags["warm"] for r in _spans(path, "engine.step")] == [
        True, False, False]
    pipe = [r for r in _spans(path, "comm.leg") if r.tags["stream"] == "pipe"]
    assert pipe and all(r.tags["intent"] == "stage compute" for r in pipe)
    labels = {r.tags["label"] for r in _spans(path, "comm.compute")}
    assert "stage compute" in labels
    _check_with_both_reports(path)


# ---------------------------------------------------------------------------
# the schedule gate
# ---------------------------------------------------------------------------

def test_commcheck_passes_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.commcheck", "--device",
         "cpu", "--profile", str(tmp_path / "cc.jsonl")],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = [line for line in out.stdout.splitlines()
             if line.startswith("comm.trace[")]
    assert len(lines) == 6 and all(" OK" in line for line in lines), lines
    assert [line.split("]")[0] for line in lines] == [
        "comm.trace[swift_torus_pallas", "comm.trace[swift_torus",
        "comm.trace[displaced_pipe", "comm.trace[hier_a2a",
        "comm.trace[hier_a2a_pallas", "comm.trace[swift_torus_pallas"]
    assert "profile: wrote" in out.stdout


def test_commcheck_fails_when_a_hop_is_waited_before_the_compute(
        monkeypatch, capsys):
    real = t_torus.torus_hop

    def waited_at_once(*args, **kw):
        fut = real(*args, **kw)
        fut.wait()
        return fut

    monkeypatch.setattr(t_torus, "torus_hop", waited_at_once)
    assert commcheck.run(CPU) == 1
    out = capsys.readouterr().out
    assert "comm.trace[swift_torus] FAIL" in out
    assert "no compute enqueued since its issue" in out


def test_trace_report_overlap_table_reads_spans():
    t = _fresh_tracker()
    t.span_event("comm.compute", 1.0, 0.1, tags={
        "label": "ring attend", "stream": "ring", "track": "dev"})
    t.span_event("comm.leg", 1.02, 0.04, tags={
        "stream": "torus", "channel": "torus.hop1", "stage": 0,
        "axes": "pod,model", "track": "dev", "nbytes": 1 << 20,
        "intent": "diag-KV attend", "exposed_s": 0.01, "ranks": 16})
    spans = list(t.records)
    (row,) = t_report.overlap_table(spans)
    assert row["hidden_frac"] == pytest.approx(0.75)
    assert row["compute_overlap_frac"] == pytest.approx(1.0)
    assert t_report.check_trace(spans, t_report.chrome_trace(spans)) == []
