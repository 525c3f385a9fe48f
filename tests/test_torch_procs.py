"""The port's process mesh (launch/procs.py) on the CPU: the same mesh of
ranks, one worker process per rank, each put writing into a peer
process's receive buffers in its shared-memory slab, each wait spinning on
the signal words of its own heap.

* (a) ``sp_attention`` over 4 processes on (pod 2, model 2) and (model
  4), for swift_torus, usp, ring and ulysses with the "pallas" backend
  (``kernel_interpret=False``: the multi-axis route takes transport + K4's
  plain version, the single-axis one K3's): bitwise the mesh of virtual
  ranks in this process, and within 1e-4 of the reference's
  ``sp_attention`` on the same mesh shape (tests/test_torch_sp.py's
  tolerance).
* (b) a reduced flux-12b ``sample_step`` under swift_torus over (pod 2,
  model 2), each process stepping its shard of the latents: within 1e-5
  of an Euler step through the reference's DiT under swift_torus.
* (c) every process allocates the same heap offsets for the same program.
* (d) a put whose signal is withheld fails the launch at the watchdog's
  deadline instead of hanging.
* (e) ten calls in a row over the reused slots stay bitwise the virtual
  mesh's.
* the served run: ``DiTServer`` led by process 0, followed by the others,
  gives the virtual-mesh server's latents; ``launch.serve --procs 4``.

The reference runs once, in one 8-fake-device subprocess; the workers run
in three launches (one for the watchdog, one for the launcher).  Every test and fixture runs with
one intra-op thread, and so do the workers.
"""
import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models.dit import init_dit as j_init_dit
from repro_torch.configs import get_reduced
from repro_torch.core import SPConfig, sp_attention
from repro_torch.launch import Mesh, make_mesh, procs
from repro_torch.models import ParallelContext, load_jax_params
from repro_torch.serving import DiTRequest, DiTServer, SamplerConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
SP_TOL = 1e-4  # tests/test_torch_sp.py
DIT_TOL = 1e-5  # tests/test_torch_dit.py
PROCS = 4
MESHES = {"pod": ((2, 2), ("pod", "model")), "model": ((4,), ("model",))}
STRATEGIES = ["swift_torus", "usp", "ring", "ulysses"]
CASES = [(m, s) for m in MESHES for s in STRATEGIES]
REUSE_STEPS = 10
GQA = (2, 64, 8, 2, 32)  # B, L, Hq, Hkv, D: swift_torus plans P_u 2 x P_r 2
DIT_T, DIT_DT = 0.8, 0.25
SERVE = dict(arch="flux-12b", reduced=True, cfg={"dtype": "float32"}, seed=5,
             mesh=MESHES["pod"], steps=2,
             requests=[(0, 16), (1, 16), (2, 48)],
             sp=dict(strategy="swift_torus", sp_axes=("pod", "model"),
                     batch_axes=None, comm_backend="pallas",
                     kernel_interpret=False))


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _qkv():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((2, 64, 8, 32)).astype(np.float32),
            rng.standard_normal((2, 64, 4, 32)).astype(np.float32),
            rng.standard_normal((2, 64, 4, 32)).astype(np.float32))


def _sp(mesh: str, strategy: str) -> dict:
    return dict(strategy=strategy, sp_axes=MESHES[mesh][1], batch_axes=None,
                comm_backend="pallas", kernel_interpret=False,
                replicate_kv=strategy == "ulysses")


def _dit_tree():
    """The reduced flux-12b's reference weights (numpy), perturbed so the
    DiT is no identity, and the inputs: 144 latents, so that [cond ;
    latents] (400 rows) puts latents on two of the four shards."""
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
    rng = np.random.default_rng(1)
    d = jcfg.d_model
    inputs = dict(latents=rng.standard_normal((2, 144, 64)).astype(np.float32),
                  cond=rng.standard_normal((2, 256, d)).astype(np.float32))
    return tree, inputs


_JAX = """
import pickle, numpy as np, jax, jax.numpy as jnp, dataclasses
from jax.sharding import AxisType
from repro.configs import get_reduced
from repro.core import SPConfig, sp_attention
from repro.models import ParallelContext
from repro.models.dit import dit_forward
d = pickle.load(open({inputs!r}, "rb"))
out = {{}}
for name, (shape, axes) in {meshes!r}.items():
    mesh = jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes),
                         devices=jax.devices()[:4])
    for strategy in {strategies!r}:
        cfg = SPConfig(strategy=strategy, sp_axes=axes, batch_axes=None,
                       comm_backend="pallas",
                       replicate_kv=strategy == "ulysses")
        f = jax.jit(lambda q, k, v: sp_attention(q, k, v, mesh=mesh, cfg=cfg,
                                                 causal=True))
        out[name + "/" + strategy] = np.asarray(f(*d["qkv"]))
shape, axes = {meshes!r}["pod"]
mesh = jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes),
                     devices=jax.devices()[:4])
cfg = dataclasses.replace(get_reduced("flux-12b"), dtype="float32")
ctx = ParallelContext(mesh, SPConfig(strategy="swift_torus", sp_axes=axes,
                                     batch_axes=None), "prefill")
tree = jax.tree.map(jnp.asarray, d["tree"])
v = dit_forward(tree, cfg, ctx, latents=jnp.asarray(d["latents"]),
                cond=jnp.asarray(d["cond"]),
                timesteps=jnp.full((2,), {t!r}, jnp.float32))
out["dit"] = np.asarray(v)
np.savez({outputs!r}, **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's sp_attention for every case and its DiT velocity
    under swift_torus, over 4 of 8 fake devices, in one subprocess."""
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("jax_procs")
    tree, inputs = _dit_tree()
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(dict(qkv=_qkv(), tree=tree, **inputs), f)
    code = _JAX.format(inputs=str(tmp / "in.pkl"),
                       outputs=str(tmp / "out.npz"), meshes=MESHES,
                       strategies=STRATEGIES, t=DIT_T)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(tmp / "out.npz")), tree, inputs


@pytest.fixture(scope="module")
def workers(reference):
    """One launch of 4 CPU workers for (a), (b), (c), (e) and the served
    run: per case this worker's shards, counts and heap offsets."""
    torch.set_num_threads(1)
    _, tree, inputs = reference
    qkv = tuple(torch.from_numpy(x) for x in _qkv())
    cases = [dict(mesh=MESHES[m], sp=_sp(m, s), qkv=qkv, causal=True)
             for m, s in CASES]
    reuse = [dict(mesh=MESHES["pod"], sp=_sp("pod", "swift_torus"),
                  shape=(2, 64, 8, 4, 32), seed=100, steps=REUSE_STEPS,
                  causal=True)]
    dit = dict(arch="flux-12b", reduced=True, cfg={"dtype": "float32"},
               tree=tree, mesh=MESHES["pod"], t=DIT_T, dt=DIT_DT,
               sp=_sp("pod", "swift_torus"),
               inputs={k: torch.from_numpy(x) for k, x in inputs.items()})
    t0 = time.perf_counter()
    res = procs.launch(procs.chain_job, PROCS, [
        (procs.sp_attention_job, (cases,)),
        (procs.sp_attention_job, (reuse,)),
        (procs.dit_step_job, (dit,)),
        (procs.serve_job, (SERVE,)),
        (procs.sp_attention_job, ([dict(reuse[0], shape=GQA, steps=1)],)),
    ], device="cpu", threads=1, deadline=300)
    print(f"one launch of {PROCS} workers: {time.perf_counter() - t0:.1f} s")
    return res


def _gathered(res, job: int, case: int, step: int = 0) -> torch.Tensor:
    return torch.cat([r[job][case]["shards"][step] for r in res], dim=1)


@pytest.mark.parametrize("mesh,strategy", CASES)
def test_sp_attention_across_processes(mesh, strategy, workers, reference):
    """(a) bitwise the virtual mesh, and the reference at SP_TOL."""
    want_ref = reference[0][f"{mesh}/{strategy}"]
    q, k, v = (torch.from_numpy(x) for x in _qkv())
    virtual = sp_attention(q, k, v, cfg=SPConfig(**_sp(mesh, strategy)),
                           mesh=make_mesh(*MESHES[mesh], device="cpu"),
                           causal=True)
    got = _gathered(workers, 0, CASES.index((mesh, strategy)))
    assert torch.equal(got, virtual)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=SP_TOL,
                               atol=SP_TOL)
    for r, res in enumerate(workers):
        lo, hi = res[0][CASES.index((mesh, strategy))]["rows"]
        assert (lo, hi) == (r * 16, (r + 1) * 16)  # its own shard


def test_sample_step_across_processes_matches_reference(workers, reference):
    """(b) each process steps its shard of the latents; together they are
    the reference's Euler step under swift_torus."""
    ref, _, inputs = reference
    want = inputs["latents"] - DIT_DT * ref["dit"]
    shards = [r[2] for r in workers]
    assert [s["rows"] for s in shards] == [(0, 0), (0, 0), (0, 44),
                                          (44, 144)]
    got = torch.cat([s["shard"] for s in shards], dim=1).numpy()
    assert float(np.abs(ref["dit"]).max()) > 1e-2  # not vacuous
    np.testing.assert_allclose(got, want, rtol=DIT_TOL, atol=DIT_TOL)


def test_sample_gathers_the_latents_once(workers, reference):
    """``sample`` on the process mesh keeps the latents sharded over its
    steps and gathers them at the end: every process holds the same
    latents, those of ``sample`` on the mesh of virtual ranks."""
    from repro_torch.serving.sampler import sample

    _, tree, inputs = reference
    got = [r[2]["sampled"] for r in workers]
    assert all(torch.equal(g, got[0]) for g in got)
    cfg = dataclasses.replace(get_reduced("flux-12b"), dtype="float32")
    ctx = ParallelContext(SPConfig(**_sp("pod", "swift_torus")),
                          mesh=make_mesh(*MESHES["pod"], device="cpu"))
    noise = torch.from_numpy(inputs["latents"])
    want = sample(load_jax_params(tree, cfg, device="cpu"), cfg, ctx,
                  batch=2, seq_len=noise.shape[1],
                  cond=torch.from_numpy(inputs["cond"]), noise=noise,
                  sc=SamplerConfig(num_steps=2))
    np.testing.assert_allclose(got[0].numpy(), want.numpy(), rtol=DIT_TOL,
                               atol=DIT_TOL)


def test_every_process_allocates_the_same_offsets(workers):
    """(c) the symmetric heap: the same program gives the same offsets in
    every process, so a sender knows the receiver's buffer."""
    for case in range(len(CASES)):
        offsets = [r[0][case]["offsets"] for r in workers]
        assert offsets[0] and offsets[0][0]
        assert all(o == offsets[0] for o in offsets)
        kinds = {kind for kind, _ in offsets[0][0]}
        assert kinds == {"buffer", "words"}


def test_reused_slots_stay_bitwise_the_virtual_mesh(workers):
    """(e) ten calls, each restarting the allocator at the step fence, so
    every call reuses the slots of the one before."""
    offsets = [step for step in workers[0][1][0]["offsets"]]
    assert len(offsets) == REUSE_STEPS
    assert all(o == offsets[0] for o in offsets)
    mesh = make_mesh(*MESHES["pod"], device="cpu")
    cfg = SPConfig(**_sp("pod", "swift_torus"))
    for step in range(REUSE_STEPS):
        spec = dict(shape=(2, 64, 8, 4, 32), seed=100 + step)
        q, k, v = procs._sp_inputs(spec, torch.device("cpu"))
        want = sp_attention(q, k, v, cfg=cfg, mesh=mesh, causal=True)
        assert torch.equal(_gathered(workers, 1, 0, step), want), step


def test_torus_with_a_ring_step_across_processes(workers):
    """swift_torus with P_u 2 x P_r 2 (8 query heads over 2 KV heads): the
    torus hops and the fused ring step (K2's plain version writing into
    the next ring rank's slab) across processes, bitwise the virtual
    mesh's."""
    from repro_torch.core.strategy import resolve_layout

    mesh = make_mesh(*MESHES["pod"], device="cpu")
    cfg = SPConfig(**_sp("pod", "swift_torus"))
    layout = resolve_layout(cfg, mesh, GQA[2], GQA[3])
    assert (layout.p_ulysses, layout.p_ring) == (2, 2)
    q, k, v = procs._sp_inputs(dict(shape=GQA, seed=100), torch.device("cpu"))
    want = sp_attention(q, k, v, cfg=cfg, mesh=mesh, causal=True)
    assert torch.equal(_gathered(workers, 4, 0), want)


def test_served_run_across_processes(workers):
    """DiTServer on the process mesh (process 0 leads, the others follow)
    gives the virtual-mesh server's latents for every request."""
    got = workers[0][3]["latents"]
    assert sorted(got) == [rid for rid, _ in SERVE["requests"]]
    assert all(r[3]["latents"] == {} for r in workers[1:])
    cfg, params = procs._dit_params(SERVE, torch.device("cpu"))
    srv = DiTServer(params, cfg, SPConfig(**SERVE["sp"]),
                    mesh=make_mesh(*SERVE["mesh"], device="cpu"),
                    sampler=SamplerConfig(num_steps=SERVE["steps"]),
                    device="cpu")
    for rid, seq in SERVE["requests"]:
        gen = torch.Generator().manual_seed(SERVE["seed"] + 2 + rid)
        cond = torch.randn((256, cfg.d_model), generator=gen)
        srv.submit(DiTRequest(rid=rid, seq_len=seq, cond=cond))
    want = {r.rid: r.latents for r in srv.serve()}
    for rid, seq in SERVE["requests"]:
        assert got[rid].shape == (seq, 64)
        np.testing.assert_allclose(got[rid].numpy(), want[rid].numpy(),
                                   rtol=DIT_TOL, atol=DIT_TOL)


def test_withheld_signal_fails_at_the_deadline():
    """(d) worker 1 never issues its part of a put: worker 2 waits on a
    word that never comes, and the launch fails near its deadline."""
    deadline = 20.0
    t0 = time.monotonic()
    with pytest.raises((TimeoutError, RuntimeError),
                       match="deadline|never reached"):
        procs.launch(procs.shift_put_job, PROCS, 1, device="cpu",
                     threads=1, deadline=deadline)
    assert time.monotonic() - t0 < deadline + 15


def test_the_default_mesh_owns_every_rank():
    """One process owning every rank is the mesh of virtual ranks."""
    mesh = make_mesh((2, 4), ("pod", "model"), device="cpu")
    assert list(mesh.owned) == list(range(8)) and not mesh.is_process_mesh
    spread = Mesh(mesh.axis_names, mesh.axis_sizes, mesh.device, process=3,
                  procs=4)
    assert list(spread.owned) == [6, 7] and spread.is_process_mesh
    with pytest.raises(ValueError, match="do not split"):
        Mesh(("model",), (6,), mesh.device, procs=4)


def test_expandable_segments_are_refused(monkeypatch):
    """CUDA IPC cannot share expandable segments: the launcher says so."""
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    with pytest.raises(RuntimeError, match="expandable_segments"):
        procs.launch(procs.shift_put_job, PROCS, device="cuda")


def test_the_launcher_serves_over_processes(capfd):
    """``launch.serve --procs 4`` on the CPU: process 0 prints the request
    and scheduler lines; the MoE LMs over processes are refused (the
    attention LMs are served there since the LM slice over processes:
    tests/test_torch_procs_lm.py)."""
    from repro_torch.launch import serve

    assert serve.main(["--arch", "flux-12b", "--reduced", "--device", "cpu",
                       "--procs", "4", "--mesh", "host", "--model", "4",
                       "--seq", "16", "--steps", "1", "--requests", "1"]) == 0
    out = capfd.readouterr().out
    assert "process mesh: 4 processes, 1 of 4 ranks each" in out
    assert "request 0: latents (16, 64)" in out
    with pytest.raises(SystemExit):
        serve.main(["--arch", "qwen2-moe-a2.7b", "--reduced", "--device",
                    "cpu", "--procs", "4"])
