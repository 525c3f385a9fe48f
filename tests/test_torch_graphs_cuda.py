"""Captured steps (src/repro_torch/serving/graphs.py) on the card: each
captured server against the same server with ``capture=False``, on the
same requests, bitwise; launches per replay; signal words re-written by
every replay; a parked captured batch restarting bitwise; a profiled
captured step.  Reduced flux-12b widths (d 128, 4 x 32 heads, 2 layers)
in float32, random weights from a seed with the zero-init projections
perturbed.

Every test here is marked ``needs_cuda`` and skips without a GPU.  The file
imports neither jax nor the reference package:

    PYTHONPATH=src python -m pytest --noconftest -m needs_cuda \
        tests/test_torch_graphs_cuda.py
"""
import dataclasses

import pytest
import torch

from repro_torch.comm import kernel_backend as kb
from repro_torch.configs import get_reduced
from repro_torch.core import PipelineConfig, SPConfig
from repro_torch.launch import make_hybrid_mesh, make_mesh
from repro_torch.models import init_dit, init_lm
from repro_torch.serving import (ARRequest, ARServer, DiTRequest, DiTServer,
                                 RecordingTracker, SamplerConfig)
from repro_torch.serving.graphs import launch_counts
from repro_torch.serving.sched import (ControlConfig, PreemptionPolicy,
                                       SchedConfig)

REQUESTS = ((0, 64), (1, 64), (2, 32))  # (rid, latent tokens)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def dit(cuda):
    cfg = dataclasses.replace(get_reduced("flux-12b"), dtype="float32")
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = init_dit(cfg, gen, device=cuda)
    for name in ("ada_f", "proj_out"):
        w = params[name]["w"]
        w.copy_(torch.randn(w.shape, generator=gen, device=cuda)
                * w.shape[0] ** -0.5)
    for lp in params["layers"]:
        w = lp["ada"]["w"]
        w.copy_(torch.randn(w.shape, generator=gen, device=cuda)
                * w.shape[0] ** -0.5)
    return cfg, params


def _torus(axes, shape, cuda, **kw):
    sp = SPConfig(strategy="swift_torus", sp_axes=axes,
                  machine_axis="pod" if "pod" in axes else None,
                  comm_backend="pallas", kernel_interpret=False, **kw)
    return sp, make_mesh(shape, axes, device=cuda)


def _hybrid(cuda):
    sp = SPConfig(strategy="swift_torus", sp_axes=("model",),
                  batch_axes=("data",), cfg_axis="cfg", pp_axis="pipe",
                  comm_backend="pallas", kernel_interpret=False)
    return sp, make_hybrid_mesh(2, 2, 1, 2, device=cuda)


def _serve(dit, sp, mesh, capture, sampler=None, requests=REQUESTS, **kw):
    cfg, params = dit
    srv = DiTServer(params, cfg, sp, mesh=mesh,
                    device=None if mesh is not None else "cuda",
                    sampler=sampler or SamplerConfig(num_steps=4),
                    max_batch=2, capture=capture, **kw)
    for rid, seq in requests:
        srv.submit(DiTRequest(rid=rid, seq_len=seq))
    torch.cuda.synchronize()
    before = launch_counts()
    out = {r.rid: r for r in srv.serve()}
    torch.cuda.synchronize()
    counts = {k: v - before[k] for k, v in launch_counts().items()}
    return out, counts, srv


def _assert_bitwise(a, b):
    assert sorted(a) == sorted(b)
    for rid in a:
        assert torch.equal(a[rid].latents, b[rid].latents), rid


PATHS = {
    "degree1": lambda cuda: (SPConfig(strategy="full"), None),
    "pod2xmodel4": lambda cuda: _torus(("pod", "model"), (2, 4), cuda),
    "model4": lambda cuda: _torus(("model",), (4,), cuda),
}
KERNELS = {"degree1": {"flash_mqkv"},
           "pod2xmodel4": {"flash_mqkv", "ring_flash_step", "landing_copy"},
           "model4": {"flash_mqkv", "remote_put"}}  # P_u 4 x P_r 1


@pytest.mark.needs_cuda
@pytest.mark.parametrize("path", sorted(PATHS))
def test_captured_server_is_bitwise_the_eager_one(cuda, dit, path):
    """Captured == eager bitwise; every step of every bucket after the
    first replays; launches per replay equal the eager step's (so the
    totals agree); every word the step's puts write holds its epoch after
    a replay onto zeroed words."""
    sp, mesh = PATHS[path](cuda)
    eager, n_eager, _ = _serve(dit, sp, mesh, capture=False)
    got, n_got, srv = _serve(dit, sp, mesh, capture=True)
    _assert_bitwise(got, eager)
    assert n_got == n_eager
    assert {k for k, v in n_got.items() if v} == KERNELS[path]
    steps = srv.captured_steps()
    assert len(steps) == srv.plan_cache.traces == srv.captures == 2
    for step in steps:
        assert step.replays == 3 and step.launches
        assert step.capture_s > 0 and step.instantiate_s > 0
    if path == "degree1":
        return
    heap = kb.heap_for(cuda)
    for step in steps:
        assert step.signal_words
        heap.signals.zero_()
        step.graph.replay()
        torch.cuda.synchronize()
        for (row, word), epoch in step.signal_words.items():
            assert int(heap.signals[row, word]) == epoch, (row, word)


@pytest.mark.needs_cuda
def test_captured_hybrid_steps_are_bitwise_the_eager_ones(cuda, dit):
    """The hybrid warm/displaced pair on mesh (cfg 2, pipe 2, data 1, model
    2): graphs per (variant, buffer parity) against two state buffers;
    two admissions of the bucket, the second replaying every graph the
    first made."""
    sp, mesh = _hybrid(cuda)
    sampler = SamplerConfig(num_steps=4, guidance_scale=3.0,
                            cfg_parallel=True,
                            pipeline=PipelineConfig(pp=2, warmup_steps=1))
    reqs = tuple((rid, 64) for rid in range(4))  # two batches of 2 rows
    eager, n_eager, _ = _serve(dit, sp, mesh, False, sampler, reqs)
    got, n_got, srv = _serve(dit, sp, mesh, True, sampler, reqs)
    _assert_bitwise(got, eager)
    assert n_got == n_eager and n_got["remote_put"] > 0
    for rid in got:
        assert got[rid].kv_drift == eager[rid].kv_drift
        assert got[rid].kv_drift[0] == 0.0 and got[rid].kv_drift[1] > 0.0
    # warmup 1: the warm step is always step 0, so its odd-parity graph
    # is never needed; each of the other three is captured and replayed
    steps = {st.name.split()[0]: st for st in srv.captured_steps()}
    assert steps["dit.warm1"].calls == 0
    for name in ("dit.warm0", "dit.displaced0", "dit.displaced1"):
        assert steps[name].graph is not None and steps[name].replays > 0


@pytest.mark.needs_cuda
def test_parked_captured_batch_restarts_bitwise(cuda, dit):
    """A captured batch parked after its first step and restarted later
    (its graphs stay cached) gives the latents of an unpreempted run."""
    sp, mesh = _hybrid(cuda)
    sampler = SamplerConfig(num_steps=3, guidance_scale=3.0,
                            cfg_parallel=True,
                            pipeline=PipelineConfig(pp=2, warmup_steps=1))
    sched = SchedConfig(max_batch=2, starvation_age=3600.0, default_slack=1e9)
    probe, _, _ = _serve(dit, sp, mesh, True, sampler, ((9, 64),),
                         tracker=RecordingTracker(), sched=sched)
    sla = 0.25 * min(probe[9].step_times)
    cfg, params = dit
    srv = DiTServer(params, cfg, sp, mesh=mesh, sampler=sampler,
                    max_batch=2, sched=sched, control=ControlConfig(
                        preemption=PreemptionPolicy(min_remaining_steps=1)))
    for rid in (0, 1):
        srv.submit(DiTRequest(rid=rid, seq_len=64))
    injected = []

    def inject(server, step):
        if not injected:
            injected.append(step)
            server.submit(DiTRequest(rid=2, seq_len=32, sla=sla))

    srv.on_step = inject
    parked = {r.rid: r for r in srv.serve()}
    assert srv.preemptions >= 1 and parked[0].preemptions >= 1
    rerun, _, _ = _serve(dit, sp, mesh, False, sampler,
                         ((0, 64), (1, 64), (2, 32)), sched=sched)
    _assert_bitwise(parked, rerun)


@pytest.mark.needs_cuda
def test_captured_ar_tick_gives_the_eager_tokens(cuda):
    cfg = dataclasses.replace(get_reduced("rwkv6-1.6b"), dtype="bfloat16")
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = init_lm(cfg, gen, cuda)
    for lp in params["layers"]:
        lp["tm"]["w0"].copy_(torch.rand(lp["tm"]["w0"].shape, generator=gen,
                                        device=cuda) * -5.0 - 1.0)
        lp["tm"]["u"].copy_(torch.randn(lp["tm"]["u"].shape, generator=gen,
                                        device=cuda))

    def serve(capture):
        srv = ARServer(params, cfg, SPConfig(strategy="full"),
                       batch_slots=2, max_len=32, capture=capture)
        for rid in range(3):
            srv.submit(ARRequest(rid=rid, prompt=torch.arange(1, 4 + rid),
                                 max_new_tokens=6))
        return srv.serve(), srv

    want, _ = serve(False)
    got, srv = serve(True)
    assert got == want
    assert srv._step.replays > 0 and srv._step.graph is not None


@pytest.mark.needs_cuda
@pytest.mark.parametrize("arch,mesh", [("hymba-1.5b", None),
                                       ("qwen2-moe-a2.7b", None),
                                       ("qwen2-moe-a2.7b", "model2"),
                                       ("arctic-480b", None)])
def test_captured_hybrid_and_moe_ticks_give_the_eager_tokens(cuda, arch,
                                                             mesh):
    """The hybrid tick (windowed decode attention, the SSD state written
    in place) and the MoE tick (routing, sorts, dispatch into capacity
    buffers, expert products; with the experts over (model 2) too),
    captured, give the tokens of the same server with capture=False."""
    cfg = dataclasses.replace(get_reduced(arch), dtype="bfloat16",
                              sharding_overrides=())
    gen = torch.Generator(device=cuda).manual_seed(1)
    params = init_lm(cfg, gen, cuda, ep_degree=2)
    sp, m = SPConfig(strategy="full"), None
    if mesh is not None:
        sp = SPConfig(strategy="full", sp_axes=("model",),
                      batch_axes=("data",))
        m = make_mesh((2,), ("model",), device=cuda)

    def serve(capture):
        srv = ARServer(params, cfg, sp, batch_slots=2, max_len=32,
                       cache_dtype=torch.bfloat16, capture=capture, mesh=m)
        for rid in range(3):
            srv.submit(ARRequest(rid=rid, prompt=torch.arange(1, 4 + rid),
                                 max_new_tokens=6))
        return srv.serve(), srv

    want, _ = serve(False)
    got, srv = serve(True)
    assert got == want
    assert srv._step.replays > 0 and srv._step.graph is not None


@pytest.mark.needs_cuda
def test_profiled_captured_step_times_its_replays(cuda, dit):
    """A profiled captured server: latents bitwise those of the unprofiled
    one, the captured step's events filed once per replay."""
    sp, mesh = PATHS["pod2xmodel4"](cuda)
    reqs = ((0, 64),)
    plain, _, _ = _serve(dit, sp, mesh, True, requests=reqs)
    tracker = RecordingTracker()
    prof, _, srv = _serve(dit, sp, mesh, True, requests=reqs, profile=True,
                          tracker=tracker)
    _assert_bitwise(prof, plain)
    (step,) = srv.captured_steps()
    assert step.replays == 3 and step._prof_events
    legs = [r for r in tracker.records
            if r.name == "comm.leg" and r.kind == "span"]
    per_step = sum(1 for e in step._prof_events if e.phase == "issue")
    # the warm-up's legs, then one occurrence of each captured leg a replay
    assert len(legs) == 4 * per_step
