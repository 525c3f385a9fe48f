"""Captured steps (src/repro_torch/serving/graphs.py) and the serving paths
around them, on the CPU.

The CPU has no CUDA graph: here a ``CapturedStep`` calls the eager step,
and the bookkeeping of a capture (launch counts per replay, signal words,
the plan cache's capture span) is checked with a fake graph that replays
by running the step again into the captured outputs.  What only a capture
on the card can break — a host copy or a host synchronisation inside the
step — is rehearsed here by running each step a second time under a
dispatch mode that refuses those ops.  The model is the reduced flux-12b
in float32 with its zero-init projections perturbed (as in
tests/test_torch_dit.py); the reference runs on its one-device mesh.
Tolerances are the reference parity tests' own: 1e-4 for a sampler step
(tests/test_torch_dit.py), 1e-5 for the hybrid step
(tests/test_torch_hybrid.py), 2e-4 for a hybrid mesh of virtual ranks
against one device."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

from repro.configs import get_reduced as j_get_reduced
from repro.core import PipelineConfig as JPipe
from repro.core import SPConfig as JSP
from repro.core import pipefusion as j_pf
from repro.models import ParallelContext as JCtx
from repro.models.dit import init_dit as j_init_dit
from repro.serving import DiTRequest as JDiTRequest
from repro.serving import DiTServer as JDiTServer
from repro.serving.sampler import SamplerConfig as JSampler
from repro.serving.sampler import hybrid_sample_step as j_hybrid_step
from repro.serving.sampler import sample as j_sample
from repro.serving.sampler import sample_step as j_sample_step
from repro_torch.comm import kernel_backend as kb
from repro_torch.configs import get_reduced
from repro_torch.core import PipelineConfig, SPConfig
from repro_torch.core import pipefusion as t_pf
from repro_torch.kernels import flash_mqkv as fm
from repro_torch.kernels import ring_flash as rf
from repro_torch.launch import make_hybrid_mesh, make_mesh
from repro_torch.models import ParallelContext, init_lm, load_jax_params
from repro_torch.models.dit import COND_TOKENS
from repro_torch.serving import (ARServer, DiTRequest, DiTServer,
                                 RecordingTracker, SamplerConfig, sample_step)
from repro_torch.serving.graphs import (CapturedStep, add_launch_counts,
                                        launch_counts)
from repro_torch.serving.sampler import hybrid_sample_step
from repro_torch.serving.sched import (ControlConfig, PreemptionPolicy,
                                       SchedConfig)

CPU = torch.device("cpu")
STEP_TOL = 1e-4
DIT_TOL = 1e-5
HYBRID_TOL = 2e-4
T = torch.from_numpy


@pytest.fixture(scope="module")
def model():
    """(cfg, reference cfg, reference params, port params)."""
    cfg = dataclasses.replace(get_reduced("flux-12b"), dtype="float32")
    jcfg = dataclasses.replace(j_get_reduced("flux-12b"), dtype="float32")
    params, _ = j_init_dit(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(0)
    for name in ("ada_f", "proj_out"):
        w = tree[name]["w"]
        tree[name]["w"] = (rng.standard_normal(w.shape) * w.shape[0] ** -0.5
                           ).astype(np.float32)
    w = tree["layers"]["ada"]["w"]
    tree["layers"]["ada"]["w"] = (rng.standard_normal(w.shape)
                                  * w.shape[1] ** -0.5).astype(np.float32)
    return (cfg, jcfg, jax.tree.map(jnp.asarray, tree),
            load_jax_params(tree, cfg, device="cpu"))


def _jctx(mesh1):
    return JCtx(mesh1, JSP(strategy="full", sp_axes=("model",),
                           batch_axes=("data",)), "prefill")


def _tctx():
    return ParallelContext(SPConfig(strategy="full"), device=CPU)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _xc(cfg, seed, batch=2, seq=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, seq, 64)).astype(np.float32),
            rng.standard_normal((batch, COND_TOKENS, cfg.d_model)
                                ).astype(np.float32))


# ---------------------------------------------------------------------------
# the wrapper on the CPU
# ---------------------------------------------------------------------------

def test_captured_step_on_cpu_is_the_eager_step(model):
    cfg, _, _, tparams = model
    x, c = _xc(cfg, 1)
    sc = SamplerConfig(num_steps=4, guidance_scale=2.5, cfg_parallel=True)

    def f(x, cond, t):
        return sample_step(tparams, cfg, _tctx(), x, cond, t, 0.25, sc)

    step = CapturedStep(f, CPU)
    assert not step.capture
    with torch.inference_mode():
        for t in (0.75, 0.5):
            got = step(T(x), T(c), t)
            assert torch.equal(got, f(T(x), T(c), t))
    assert step.calls == 2 and step.graph is None and step.replays == 0
    with pytest.raises(ValueError, match="CUDA"):
        CapturedStep(f, CPU, capture=True)
    with pytest.raises(ValueError, match="CUDA"):
        DiTServer(tparams, cfg, SPConfig(strategy="full"), device="cpu",
                  capture=True)


# ---------------------------------------------------------------------------
# the timestep as a device tensor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [0.75, 0.3])
@pytest.mark.parametrize("kind", ["sample", "warm", "displaced"])
def test_tensor_timestep_equals_float_and_reference(model, mesh1, kind, t):
    """A 0-d tensor ``t`` (a captured step's static input) gives the float
    call's bits, and both match the reference's step (whose jit traces
    t), at two distinct timesteps."""
    cfg, jcfg, jparams, tparams = model
    x, c = _xc(cfg, 2, batch=1)
    tt = torch.tensor(t, dtype=torch.float32)
    if kind == "sample":
        sc = SamplerConfig(num_steps=4)
        got = [sample_step(tparams, cfg, _tctx(), T(x), T(c), tv, 0.25, sc)
               for tv in (t, tt)]
        assert torch.equal(got[0], got[1])
        want = j_sample_step(jparams, jcfg, _jctx(mesh1), jnp.asarray(x),
                             jnp.asarray(c), jnp.float32(t), 0.25,
                             JSampler(num_steps=4))
        _close(got[1], want, STEP_TOL)
        return
    warm = kind == "warm"
    pipe = dict(pp=2, warmup_steps=1)
    shape = (cfg.n_layers, 1, COND_TOKENS + 16, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    rng = np.random.default_rng(3)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    sc = SamplerConfig(num_steps=4, pipeline=PipelineConfig(**pipe))
    got = []
    for tv in (t, tt):
        out = t_pf.KVState(torch.empty(shape), torch.empty(shape))
        got.append(hybrid_sample_step(
            tparams, cfg, _tctx(), T(x), T(c), tv, 0.25, sc,
            t_pf.KVState(T(k), T(v)), warm=warm, out=out))
    (x0, s0, m0), (x1, s1, m1) = got
    assert torch.equal(x0, x1) and torch.equal(s0.k, s1.k)
    assert torch.equal(m0["kv_drift_per_request"], m1["kv_drift_per_request"])
    jx, jst, jm = j_hybrid_step(
        jparams, jcfg, _jctx(mesh1), jnp.asarray(x), jnp.asarray(c),
        jnp.float32(t), 0.25, JSampler(num_steps=4, pipeline=JPipe(**pipe)),
        j_pf.KVState(jnp.asarray(k), jnp.asarray(v)), warm=warm)
    _close(x1, jx, DIT_TOL)
    _close(s1.k, jst.k, DIT_TOL)
    _close(m1["kv_drift_per_request"], jm["kv_drift_per_request"], DIT_TOL)


# ---------------------------------------------------------------------------
# the plan cache: builds, hits and captures
# ---------------------------------------------------------------------------

MIXED = [32, 16, 64]  # the launcher's --mixed cycle (seq, seq/2, 2 seq)


def test_plan_cache_counts_match_reference(model, mesh1):
    """One mixed request stream through the port's and the reference's
    DiTServer at degree 1: the same builds ('traces'), step-cache hits,
    admissions and scheduler totals; no capture on the CPU."""
    cfg, jcfg, jparams, tparams = model
    reqs = [(rid, MIXED[rid % 3]) for rid in range(12)]
    sched = SchedConfig(max_batch=2)
    srv = DiTServer(tparams, cfg, SPConfig(strategy="full"), device="cpu",
                    sampler=SamplerConfig(num_steps=2), sched=sched)
    jsrv = JDiTServer(jparams, jcfg, mesh1,
                      JSP(strategy="full", sp_axes=("model",),
                          batch_axes=("data",)),
                      sampler=JSampler(num_steps=2), sched=sched)
    for rid, seq in reqs:
        srv.submit(DiTRequest(rid=rid, seq_len=seq))
        jsrv.submit(JDiTRequest(rid=rid, seq_len=seq))
    got, want = srv.serve(), jsrv.serve()
    assert sorted(r.rid for r in got) == sorted(r.rid for r in want)
    pc, jpc = srv.plan_cache, jsrv.plan_cache
    assert (pc.traces, pc.hits) == (jpc.traces, jpc.hits)
    assert pc.hits >= 1
    assert srv.captures == 0
    assert srv.scheduler.admissions == jsrv.scheduler.admissions
    tot, jtot = srv.scheduler.totals(), jsrv.scheduler.totals()
    assert (tot.batches, tot.padded_rows) == (jtot.batches, jtot.padded_rows)
    assert len(pc.plans) == len(jpc.plans) == 3


class FakeGraph:
    """A capture that runs the step once and a replay that runs it again
    into the captured outputs, keeping the launch counters as a replay of
    a real graph leaves them (replays make no Python call)."""

    def __init__(self, pool):
        self.fn = self.out = None

    def capture(self, fn):
        self.fn = fn
        self.out = fn()
        return self.out, 0.0, 0.0

    def replay(self):
        before = launch_counts()
        new = self.fn()
        self.out.copy_(new)
        add_launch_counts({k: before[k] - v
                           for k, v in launch_counts().items()})


def test_launch_counts_signal_words_and_capture_span_per_replay(model):
    """With a fake capture: the capture's own counts are taken back and
    every replay adds the step's launches, so n calls count n steps; the
    signal words the step's puts write are listed with their epoch and
    zeroed at the step's start; the capture is one plan-cache span."""
    cfg, _, _, tparams = model
    srv = DiTServer(tparams, cfg, SPConfig(strategy="full"), device="cpu",
                    tracker=RecordingTracker())
    heap = kb.heap_for(CPU)
    per_call = {"flash_mqkv": 3, "landing_copy": 1}

    def f(x):
        # stands for a step whose wrappers launch 3 K1 and one K4
        add_launch_counts({"flash_mqkv": 3})
        epoch = heap.next_epoch()
        signal, arrive = heap.words("landing_copy", 0, 1, epoch)
        out = torch.empty_like(x)
        kb.landing_copy([[x]], [[out]], signal=signal, arrive=arrive,
                        epoch=epoch)
        add_launch_counts({"landing_copy": 1})
        return out * 2

    step = CapturedStep(f, CPU, capture=True, graph=FakeGraph,
                        on_capture=lambda: srv._capturing(1, 8))
    before = launch_counts()
    heap.signals.fill_(-1)
    x = torch.arange(8.0)
    for n in range(1, 5):
        y = step(x + n)
        assert torch.equal(y, (x + n) * 2)
        got = {k: v - before[k] for k, v in launch_counts().items()}
        assert got == {k: n * per_call.get(k, 0) for k in got}, n
    assert step.launches == per_call
    assert step.replays == 3 and step.graph is not None
    row = kb.SymmetricHeap.ROWS["landing_copy"]
    ((word, epoch),) = step.signal_words.items()
    assert word == (row, 0) and epoch > 0
    # the step zeroed every word first, then its put wrote its own
    assert int(heap.signals[row, 0]) > 0 and int(heap.signals[row, 2]) == 0
    assert int(heap.signals[0, 0]) == 0
    assert srv.captures == 1
    spans = [r for r in srv.tracker.records
             if r.name == "plan_cache.capture" and r.kind == "span"]
    assert len(spans) == 1
    with pytest.raises(ValueError, match="captured as"):
        step(torch.arange(4.0))
    heap.signals.zero_()


def test_capture_waits_for_a_repeated_input_signature():
    """As the AR tick's caches change dtype over the first ticks, a step
    whose input dtype changes runs eagerly until two calls in a row share
    their signature; then it is captured and replayed.  A later input of
    another signature is refused."""
    calls = []

    def f(cache):
        calls.append(cache.dtype)
        return cache.to(torch.float64) + 1.0

    step = CapturedStep(f, CPU, capture=True, graph=FakeGraph)
    x = step(torch.zeros(3, dtype=torch.float32))  # warm-up, float32
    y = step(x)  # new signature (float64): another warm-up
    assert step.graph is None and calls == [torch.float32, torch.float64]
    z = step(y)  # repeats it: captured and replayed
    assert step.graph is not None and step.replays == 1
    assert torch.equal(z, torch.full((3,), 3.0, dtype=torch.float64))
    assert torch.equal(step(z.clone()), torch.full((3,), 4.0,
                                                   dtype=torch.float64))
    with pytest.raises(ValueError, match="captured as"):
        step(torch.zeros(3, dtype=torch.float32))


# ---------------------------------------------------------------------------
# capture safety, rehearsed: no host copy and no host synchronisation
# ---------------------------------------------------------------------------

# ops that make a captured CUDA step fail or read a stale value: a tensor
# from host data (an H2D copy), a read of a device value on the host
_HOST_OPS = ("lift_fresh", "lift_fresh_copy", "item", "_local_scalar_dense",
             "nonzero", "equal", "is_nonzero", "masked_select")


class _NoHostOps(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in _HOST_OPS:
            raise AssertionError(f"{name} inside a step that is captured")
        return func(*args, **(kwargs or {}))


def _unguarded(fn):
    """``fn`` with the guard off: a kernel's plain version, which runs only
    on the CPU (on the card the wrapper launches the kernel)."""
    def call(*args, **kw):
        with _disable_current_modes():
            return fn(*args, **kw)
    return call


@pytest.fixture
def guard(monkeypatch):
    """fn once (the warm-up), then again under the guard."""
    for mod, name in ((fm, "flash_mqkv_plain"), (rf, "ring_flash_step_plain"),
                      (kb, "remote_put_plain"), (kb, "landing_copy_plain")):
        monkeypatch.setattr(mod, name, _unguarded(getattr(mod, name)))

    def twice(fn):
        with torch.inference_mode():
            fn()
            with _NoHostOps():
                return fn()
    return twice


def test_ar_tick_makes_no_host_copy_or_sync(guard):
    cfg = dataclasses.replace(get_reduced("rwkv6-1.6b"), dtype="float32")
    srv = ARServer(init_lm(cfg, torch.Generator().manual_seed(0), "cpu"),
                   cfg, SPConfig(strategy="full"), batch_slots=2, max_len=16,
                   device="cpu")
    tok = torch.tensor([[3], [5]], dtype=torch.int32)
    cur = torch.tensor(0, dtype=torch.int32)
    nxt, caches = guard(lambda: srv._eager_step(srv.caches, tok, cur))
    assert nxt.shape == (2,) and set(caches) == set(srv.caches)


@pytest.mark.parametrize("case", ["degree1-cfg", "torus-k2k4", "torus-k3",
                                  "hybrid-warm", "hybrid-displaced"])
def test_steps_make_no_host_copy_or_sync(model, guard, case):
    cfg, _, _, tparams = model
    x, c = (T(a) for a in _xc(cfg, 4, batch=1))
    if case.startswith("hybrid"):
        mesh = make_hybrid_mesh(2, 2, 1, 2, device="cpu")
        sp = SPConfig(strategy="swift_torus", sp_axes=("model",),
                      batch_axes=("data",), cfg_axis="cfg", pp_axis="pipe",
                      comm_backend="pallas", kernel_interpret=False)
        sc = SamplerConfig(num_steps=4, guidance_scale=3.0, cfg_parallel=True,
                           pipeline=PipelineConfig(pp=2, num_patches=2))
        ctx = ParallelContext(sp, mesh=mesh)
        shape = (cfg.n_layers, 2, COND_TOKENS + 16, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        state = t_pf.KVState(torch.randn(shape), torch.randn(shape))
        out = t_pf.KVState(torch.empty(shape), torch.empty(shape))
        tt = torch.tensor(0.5)
        guard(lambda: hybrid_sample_step(
            tparams, cfg, ctx, x, c, tt, 0.25, sc, state,
            warm=case == "hybrid-warm", out=out))
        return
    if case == "degree1-cfg":
        ctx = _tctx()
        sc = SamplerConfig(num_steps=4, guidance_scale=2.5, cfg_parallel=True)
    else:
        shape, axes = (((2, 4), ("pod", "model")) if case == "torus-k2k4"
                       else ((4,), ("model",)))
        sp = SPConfig(strategy="swift_torus", sp_axes=axes,
                      machine_axis="pod" if len(axes) == 2 else None,
                      comm_backend="pallas", kernel_interpret=False)
        ctx = ParallelContext(sp, mesh=make_mesh(shape, axes, device="cpu"))
        sc = SamplerConfig(num_steps=4)
    tt = torch.tensor(0.5)
    guard(lambda: sample_step(tparams, cfg, ctx, x, c, tt, 0.25, sc))


# ---------------------------------------------------------------------------
# preemption (tests/multidevice/test_preempt_e2e.py's cases, on the port)
# ---------------------------------------------------------------------------

PREEMPT_SEQ, URGENT_SEQ = 64, 128
PIPE = dict(pp=2, warmup_steps=1)


def _preempt_server(model, control, tracker=None) -> DiTServer:
    cfg, _, _, tparams = model
    mesh = make_hybrid_mesh(cfg=1, pipe=2, data=2, model=2, device="cpu")
    sp = SPConfig(strategy="swift_torus", sp_axes=("model",),
                  batch_axes=("data",), pp_axis="pipe")
    return DiTServer(
        tparams, cfg, sp, mesh=mesh,
        sampler=SamplerConfig(num_steps=3, pipeline=PipelineConfig(**PIPE)),
        max_batch=2, tracker=tracker,
        sched=SchedConfig(max_batch=2, starvation_age=3600.0,
                          default_slack=1e9),
        control=control)


@pytest.fixture(scope="module")
def preempt_runs(model):
    """(preempted server, its results, the injection steps, the rerun's
    results): two PREEMPT_SEQ requests admitted, an urgent URGENT_SEQ one
    injected after their first step.  Its SLA is a quarter of a measured
    PREEMPT_SEQ step: far below the batch's remaining two steps, far
    above its own predicted latency (the reference's rule for its
    URGENT_SLA, on the reference's jit-slowed first step)."""
    probe = _preempt_server(model, ControlConfig(), RecordingTracker())
    probe.submit(DiTRequest(rid=9, seq_len=PREEMPT_SEQ))
    (r,) = probe.serve()
    sla = 0.25 * min(r.step_times)
    srv = _preempt_server(model, ControlConfig(
        preemption=PreemptionPolicy(min_remaining_steps=1)))
    srv.submit(DiTRequest(rid=0, seq_len=PREEMPT_SEQ))
    srv.submit(DiTRequest(rid=1, seq_len=PREEMPT_SEQ))
    injected = []

    def inject(server, step):
        if not injected:
            injected.append(step)
            server.submit(DiTRequest(rid=2, seq_len=URGENT_SEQ, sla=sla))

    srv.on_step = inject
    results = srv.serve()
    srv.on_step = None
    rerun = _preempt_server(model, ControlConfig())
    for rid, n in ((0, PREEMPT_SEQ), (1, PREEMPT_SEQ), (2, URGENT_SEQ)):
        rerun.submit(DiTRequest(rid=rid, seq_len=n))
    return srv, results, injected, rerun, rerun.serve()


def test_preempt_batch_parked_and_all_requests_complete(preempt_runs):
    srv, results, injected, _, _ = preempt_runs
    assert injected == [0]
    assert srv.preemptions >= 1
    assert srv.scheduler.preempted >= 2
    assert sorted(r.rid for r in results) == [0, 1, 2]
    by_rid = {r.rid: r for r in results}
    for rid, n in ((0, PREEMPT_SEQ), (1, PREEMPT_SEQ), (2, URGENT_SEQ)):
        assert by_rid[rid].latents.shape == (n, 64)
        assert bool(torch.isfinite(by_rid[rid].latents).all())
    assert by_rid[0].preemptions >= 1 and by_rid[1].preemptions >= 1
    assert by_rid[2].preemptions == 0
    # the parked bucket's steps were built once and reused by its restart
    assert srv.plan_cache.traces == 2


def test_preempt_parked_batch_restarts_with_full_trajectory(preempt_runs):
    _, results, _, _, _ = preempt_runs
    by_rid = {r.rid: r for r in results}
    for rid in (0, 1):
        assert by_rid[rid].sampling_steps == 3
        assert len(by_rid[rid].kv_drift) == 3
        assert by_rid[rid].kv_drift[0] == 0.0
        assert len(by_rid[rid].step_times) == 3
        assert all(t > 0.0 for t in by_rid[rid].step_times)


def test_preempt_outputs_bitwise_equal_unpreempted_rerun(preempt_runs):
    srv, results, _, rerun, rerun_results = preempt_runs
    assert rerun.preemptions == 0
    a = {r.rid: r.latents for r in results}
    b = {r.rid: r.latents for r in rerun_results}
    assert sorted(a) == sorted(b) == [0, 1, 2]
    for rid in (0, 1, 2):
        assert torch.equal(a[rid], b[rid]), rid


def test_preempt_restarted_request_matches_reference(model, mesh1,
                                                     preempt_runs):
    """The restarted request's latents against the reference's pipelined
    sample loop on its one-device mesh, from the same noise and with the
    patch count the port's plan cache chose for the bucket."""
    cfg, jcfg, jparams, _ = model
    srv, results, _, _, _ = preempt_runs
    (choice,) = [p for (rows, seq), p in srv.plan_cache.plans.items()
                 if seq == PREEMPT_SEQ]
    patches = srv._bucket_sampler(choice).pipeline.patches
    key = jax.random.PRNGKey(5)
    x0 = np.array(jax.random.normal(key, (1, PREEMPT_SEQ, 64), jnp.float32))
    want = j_sample(jparams, jcfg, _jctx(mesh1), key=key, batch=1,
                    seq_len=PREEMPT_SEQ,
                    cond=jnp.zeros((1, COND_TOKENS, cfg.d_model)),
                    sc=JSampler(num_steps=3, pipeline=JPipe(
                        num_patches=patches, **PIPE)))
    # the port's server on the reference's noise for rid 0 (rid 1 keeps
    # its own): the served row is the reference's trajectory
    srv2 = _preempt_server(model, ControlConfig())
    own = srv2._noise

    def noise(batch, b, t):
        x = own(batch, b, t)
        x[0] = T(x0[0])
        return x

    srv2._noise = noise
    srv2.submit(DiTRequest(rid=0, seq_len=PREEMPT_SEQ))
    srv2.submit(DiTRequest(rid=1, seq_len=PREEMPT_SEQ))
    got = {r.rid: r.latents for r in srv2.serve()}
    _close(got[0], np.asarray(want)[0], HYBRID_TOL)
    assert not torch.equal(got[0], {r.rid: r.latents for r in results}[0])
