"""The port's hybrid mesh over a process mesh (launch/procs.py) on the CPU:
batch slices (the cfg and data axes), the pipe hand-off, the hierarchical
all-to-all and the CFG-parallel and pipelined samplers, with one process
per block of ranks.

* (a) ``sp_attention`` with batch slices over 4 processes: (data 2, model
  2), (cfg 2, model 2) with the cfg axis as a batch axis, and (pod 2,
  data 2, model 2) with SP over (pod, model), two ranks a process; for
  swift_torus, usp and ring with the "pallas" backend each process's rows
  are bitwise the mesh of virtual ranks'.
* (b) ``hier_a2a`` on (pod 2, model 2): bitwise the virtual mesh's, exact
  and with the fp8 wire; ``hier_all_to_all`` with fp8 and error feedback,
  its outputs and residuals bitwise.
* (c) ``pipe_handoff``: each process receives the slice of the process at
  the pipe rank before it with its own coordinates elsewhere; routed by
  the flat-rank rule (the list's index read as the flat rank) it does
  not.
* (d) reduced cogvideox-5b (tests/test_torch_hybrid.py's perturbed float32
  model), ``sample`` with ``cfg_parallel`` and ``PipelineConfig(pp=2,
  num_patches=4)`` on (cfg 2, pipe 2, data 1, model 2) over 8 processes,
  every axis crossing a process boundary: within HYBRID_TOL of the
  reference's sampler on its one-device mesh, in this process, and of the
  virtual mesh's.
* (e) ``DiTServer`` led by process 0 with that sampler and a DriftPolicy:
  the virtual-mesh server's latents and warm/displaced steps.
* (f) every process allocates the same heap offsets; the slab's
  high-water mark is printed.
* (g) a process block across two pipe stages is refused.
* the launcher: ``--procs 4`` with ``--mesh host --data 2 --model 2`` and
  ``--mesh multipod`` print the latents' digests of the launcher without
  it.

The workers run in two launches (4 CPU workers, then 8); every test,
fixture and worker runs with one intra-op thread.
"""
import dataclasses
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.core import PipelineConfig as JPipe
from repro.core import SPConfig as JSP
from repro.models import ParallelContext as JCtx
from repro.models.dit import init_dit as j_init_dit
from repro.serving.sampler import SamplerConfig as JSampler
from repro.serving.sampler import sample as j_sample
from repro_torch.comm.stream import hier_all_to_all
from repro_torch.configs import get_reduced
from repro_torch.core import SPConfig, sp_attention
from repro_torch.core.collectives import GroupLayout
from repro_torch.core.strategy import resolve_layout
from repro_torch.launch import Mesh, make_mesh, procs
from repro_torch.models import ParallelContext, load_jax_params
from repro_torch.models.dit import COND_TOKENS
from repro_torch.serving import DiTRequest, DiTServer
from repro_torch.serving.sampler import sample
from repro_torch.serving.sched import DriftPolicy

HYBRID_TOL = 2e-4  # tests/test_torch_hybrid.py
SEQ = 64
MESHES = {"data": ((2, 2), ("data", "model")),
          "cfg": ((2, 2), ("cfg", "model")),
          "multipod": ((2, 2, 2), ("pod", "data", "model"))}
STRATEGIES = ["swift_torus", "usp", "ring"]
SLICED = [(m, s) for m in MESHES for s in STRATEGIES]
POD = ((2, 2), ("pod", "model"))
WIRE = "float8_e4m3fn"
HIER = [None, WIRE]  # sp_attention's a2a wire
HANDOFFS = {"model": dict(mesh=((2, 2), ("pipe", "model"))),
            "data": dict(mesh=((1, 2, 2, 1), ("cfg", "pipe", "data", "model")),
                         batch_axes=("data",))}
HYBRID_MESH = ((2, 2, 1, 2), ("cfg", "pipe", "data", "model"))
HYBRID_SP = dict(strategy="swift_torus", sp_axes=("model",),
                 batch_axes=("data",), cfg_axis="cfg", pp_axis="pipe",
                 comm_backend="pallas", kernel_interpret=False)
SAMPLER = dict(num_steps=4, guidance_scale=4.0, cfg_parallel=True,
               pipeline=dict(pp=2, num_patches=4, warmup_steps=1))
DRIFT = 0.02
SERVE_REQUESTS = [(0, SEQ), (1, SEQ)]


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _sp(mesh: str, strategy: str, **kw) -> dict:
    batch = {"data": dict(batch_axes=("data",)),
             "cfg": dict(batch_axes=None, cfg_axis="cfg"),
             "multipod": dict(batch_axes=("data",))}[mesh]
    sp_axes = ("pod", "model") if mesh in ("multipod", "pod") else ("model",)
    return dict(strategy=strategy, sp_axes=sp_axes, comm_backend="pallas",
                kernel_interpret=False, **batch, **kw)


def _hier_sp(wire) -> dict:
    return dict(strategy="ulysses", sp_axes=POD[1], batch_axes=None,
                comm_backend="pallas", kernel_interpret=False, hier_a2a=True,
                a2a_wire_dtype=wire)


def _hier_inputs():
    rng = np.random.default_rng(5)
    x = [torch.from_numpy(rng.standard_normal((2, 8, 8, 4)).astype(
        np.float32)) for _ in range(4)]
    err = [(torch.from_numpy((rng.standard_normal((2, 2, 8, 2, 4)) * 1e-2
                              ).astype(np.float32)),) for _ in range(4)]
    return x, err


_HIER_LAYOUT = dict(axes=POD[1], p_ulysses=4, p_ring=1, ulysses_outer=True,
                    u_groups=2)


def _models():
    """tests/test_torch_hybrid.py's model: reduced cogvideox-5b in float32
    at head_dim 16, every weight perturbed; the reference's params, the
    numpy tree and the port's config."""
    cfg, jcfg = (dataclasses.replace(get("cogvideox-5b"), dtype="float32",
                                     head_dim=16)
                 for get in (get_reduced, j_get_reduced))
    params, _ = j_init_dit(jcfg, jax.random.PRNGKey(0))
    leaves, treedef = jax.tree.flatten(jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(99)
    leaves = [(l + 0.05 * rng.standard_normal(l.shape)).astype(np.float32)
              for l in leaves]
    tree = jax.tree.unflatten(treedef, leaves)
    return cfg, jcfg, jax.tree.map(jnp.asarray, tree), tree


@pytest.fixture(scope="module")
def model():
    return _models()


@pytest.fixture(scope="module")
def hybrid_inputs(model):
    """The reference's noise (from its key 7) and a conditioning."""
    cfg = model[0]
    x0 = np.array(jax.random.normal(jax.random.PRNGKey(7), (1, SEQ, 64),
                                    jnp.float32))
    cond = np.random.default_rng(1).standard_normal(
        (1, COND_TOKENS, cfg.d_model)).astype(np.float32)
    return x0, cond


def _dit_spec(tree, **kw) -> dict:
    return dict(arch="cogvideox-5b", reduced=True,
                cfg={"dtype": "float32", "head_dim": 16}, tree=tree,
                mesh=HYBRID_MESH, sp=HYBRID_SP, sampler=SAMPLER, **kw)


@pytest.fixture(scope="module")
def workers4():
    """One launch of 4 CPU workers: (a), (b) and (c)."""
    torch.set_num_threads(1)
    sliced = [dict(mesh=MESHES[m], sp=_sp(m, s), shape=(4, 64, 8, 2, 32),
                   seed=3, causal=True) for m, s in SLICED]
    hier_sp = [dict(mesh=POD, sp=_hier_sp(w), shape=(2, 64, 8, 8, 32),
                    seed=4) for w in HIER]
    x, err = _hier_inputs()
    hier = [dict(mesh=POD, sp_axes=POD[1], layout=_HIER_LAYOUT, x=x,
                 split_axis=2, wire_dtype=WIRE, err=err)]
    hand = list(HANDOFFS.values()) + [dict(HANDOFFS["data"], old_owner=True)]
    t0 = time.perf_counter()
    res = procs.launch(procs.chain_job, 4, [
        (procs.sp_attention_job, (sliced,)),
        (procs.sp_attention_job, (hier_sp,)),
        (procs.hier_job, (hier,)),
        (procs.handoff_job, (hand,))], device="cpu", threads=1, deadline=240)
    print(f"one launch of 4 workers: {time.perf_counter() - t0:.1f} s")
    return sliced, hier_sp, res


@pytest.fixture(scope="module")
def workers8(model, hybrid_inputs):
    """One launch of 8 CPU workers: (d) the hybrid sampler, (e) the hybrid
    server with a DriftPolicy."""
    torch.set_num_threads(1)
    x0, cond = hybrid_inputs
    tree = model[3]
    t0 = time.perf_counter()
    res = procs.launch(procs.chain_job, 8, [
        (procs.hybrid_sample_job, (_dit_spec(
            tree, noise=torch.from_numpy(x0), cond=torch.from_numpy(cond)),)),
        (procs.serve_job, (_dit_spec(
            tree, seed=9, drift=DRIFT, max_batch=2,
            requests=SERVE_REQUESTS),))], device="cpu", threads=1,
        deadline=240)
    print(f"one launch of 8 workers: {time.perf_counter() - t0:.1f} s")
    return res


# ---------------------------------------------------------------------------
# (a) batch slices, (b) the hierarchical all-to-all
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh,strategy", SLICED)
def test_sliced_sp_attention_across_processes(mesh, strategy, workers4):
    """(a) each process's rows (its batch slice, its SP ranks' shards)
    are bitwise the mesh of virtual ranks'."""
    sliced, _, res = workers4
    n = SLICED.index((mesh, strategy))
    spec = sliced[n]
    q, k, v = procs._sp_inputs(spec, torch.device("cpu"))
    want = sp_attention(q, k, v, cfg=SPConfig(**spec["sp"]),
                        mesh=make_mesh(*spec["mesh"], device="cpu"),
                        causal=True)
    held = set()
    for worker in res:
        got = worker[0][n]
        (b0, b1), (r0, r1) = got["batch"], got["rows"]
        assert torch.equal(got["shards"][0], want[b0:b1, r0:r1])
        held.add((b0, r0))
    assert len(held) == 4  # every process a different part


@pytest.mark.parametrize("wire", HIER, ids=["exact", "fp8"])
def test_hier_a2a_sp_attention_across_processes(wire, workers4):
    """(b) the hierarchical all-to-all (u_groups 2 over (pod 2, model 2))
    inside sp_attention: bitwise the virtual mesh's."""
    _, hier_sp, res = workers4
    spec = hier_sp[HIER.index(wire)]
    mesh = make_mesh(*POD, device="cpu")
    cfg = SPConfig(**spec["sp"])
    assert resolve_layout(cfg, mesh, 8, 8).u_groups == 2
    q, k, v = procs._sp_inputs(spec, torch.device("cpu"))
    want = sp_attention(q, k, v, cfg=cfg, mesh=mesh)
    for worker in res:
        got = worker[1][HIER.index(wire)]
        r0, r1 = got["rows"]
        assert torch.equal(got["shards"][0], want[:, r0:r1])


def test_hier_a2a_with_error_feedback_across_processes(workers4):
    """(b) ``hier_all_to_all`` with the fp8 wire and error feedback: each
    process's outputs and new residuals bitwise the virtual mesh's."""
    _, _, res = workers4
    x, err = _hier_inputs()
    want, want_err = hier_all_to_all(x, GroupLayout(**_HIER_LAYOUT),
                                     split_axis=2, backend="pallas",
                                     interpret=False, wire_dtype=WIRE,
                                     err=err)
    seen = set()
    for worker in res:
        got = worker[2][0]
        for p, out in got["out"].items():
            assert torch.equal(out, want[p])
            assert all(torch.equal(a, b)
                       for a, b in zip(got["err"][p], want_err[p]))
            seen.add(p)
    assert seen == {0, 1, 2, 3}
    assert any(float(e.abs().max()) > 0 for e in want_err[0])


# ---------------------------------------------------------------------------
# (c) the pipe hand-off
# ---------------------------------------------------------------------------

def _sender(res, case: int, coords) -> int:
    """The process at the pipe rank before ``coords``, the same elsewhere
    (the pipe axis is axis 0 of (pipe, model), 1 of the hybrid mesh)."""
    mesh = list(HANDOFFS.values())[min(case, 1)]["mesh"]
    axis = mesh[1].index("pipe")
    want = list(coords)
    want[axis] = (want[axis] - 1) % mesh[0][axis]
    return next(r for r, w in enumerate(res) if w[3][case]["coords"]
                == tuple(want))


@pytest.mark.parametrize("case", list(HANDOFFS))
def test_pipe_handoff_reaches_the_next_stage(case, workers4):
    """(c) every process receives the slice of its peer one pipe rank
    back, with one K3 launch each on the card (0 here)."""
    _, _, res = workers4
    n = list(HANDOFFS).index(case)
    for worker in res:
        got = worker[3][n]
        assert float(got["got"][0, 0]) == _sender(res, n, got["coords"])


def test_pipe_handoff_by_the_old_owner_fails(workers4):
    """(c) the negative control: routed by the flat-rank rule (the index
    of the (data, pipe) list read as the flat rank of (cfg, pipe, data,
    model)) the hand-off reaches the wrong processes."""
    _, _, res = workers4
    n = len(HANDOFFS)
    wrong = [float(w[3][n]["got"][0, 0]) != _sender(res, 1, w[3][n]["coords"])
             for w in res]
    assert any(wrong)


# ---------------------------------------------------------------------------
# (d)-(f) the hybrid sampler and server over 8 processes
# ---------------------------------------------------------------------------

def test_hybrid_sample_across_8_processes(model, hybrid_inputs, workers8,
                                          mesh1):
    """(d) cfg-parallel and the displaced pipeline over (cfg 2, pipe 2,
    data 1, model 2), one rank a process: within HYBRID_TOL of the
    reference's sampler on its one-device mesh and of the virtual
    mesh's."""
    cfg, jcfg, jparams, tree = model
    x0, cond = hybrid_inputs
    want = np.asarray(j_sample(
        jparams, jcfg, JCtx(mesh1, JSP(strategy="full", sp_axes=("model",),
                                       batch_axes=("data",)), "prefill"),
        key=jax.random.PRNGKey(7), batch=1, seq_len=SEQ,
        cond=jnp.asarray(cond),
        sc=JSampler(num_steps=4, guidance_scale=4.0, cfg_parallel=True,
                    pipeline=JPipe(pp=2, num_patches=4, warmup_steps=1))))
    ctx = ParallelContext(SPConfig(**HYBRID_SP),
                          mesh=make_mesh(*HYBRID_MESH, device="cpu"))
    virtual = sample(load_jax_params(tree, cfg, device="cpu"), cfg, ctx,
                     noise=torch.from_numpy(x0), batch=1, seq_len=SEQ,
                     cond=torch.from_numpy(cond),
                     sc=procs._sampler(dict(sampler=SAMPLER))).numpy()
    got = [w[0]["latents"].numpy() for w in workers8]
    assert all(np.array_equal(g, got[0]) for g in got)
    gap = float(np.abs(got[0] - virtual).max())
    print(f"8 processes vs the virtual mesh: max|d| {gap:.3e}; vs the "
          f"reference {float(np.abs(got[0] - want).max()):.3e}")
    np.testing.assert_allclose(got[0], want, rtol=HYBRID_TOL, atol=HYBRID_TOL)
    np.testing.assert_allclose(got[0], virtual, rtol=HYBRID_TOL,
                               atol=HYBRID_TOL)
    assert [m["warm"] for m in workers8[0][0]["metrics"]] == [
        True, False, False, False]


def test_hybrid_server_across_8_processes(model, workers8):
    """(e) DiTServer led by process 0 with a DriftPolicy and a tight bound
    on request 0: the virtual-mesh server's latents, drift and warm
    (resync) steps."""
    cfg, _, _, tree = model
    spec = _dit_spec(tree, seed=9)
    srv = DiTServer(load_jax_params(tree, cfg, device="cpu"), cfg,
                    SPConfig(**HYBRID_SP),
                    mesh=make_mesh(*HYBRID_MESH, device="cpu"),
                    sampler=procs._sampler(spec), drift=DriftPolicy(DRIFT),
                    max_batch=2, device="cpu")
    for rid, seq in SERVE_REQUESTS:
        gen = torch.Generator().manual_seed(spec["seed"] + 2 + rid)
        srv.submit(DiTRequest(rid=rid, seq_len=seq, cond=torch.randn(
            (COND_TOKENS, cfg.d_model), generator=gen)))
    want = {r.rid: r for r in srv.serve()}
    got = workers8[0][1]["results"]
    assert all(w[1]["results"] == {} for w in workers8[1:])
    for rid, _ in SERVE_REQUESTS:
        np.testing.assert_allclose(got[rid]["latents"].numpy(),
                                   want[rid].latents.numpy(),
                                   rtol=HYBRID_TOL, atol=HYBRID_TOL)
        np.testing.assert_allclose(got[rid]["kv_drift"], want[rid].kv_drift,
                                   rtol=1e-4, atol=1e-6)
        warm = [d == 0.0 for d in got[rid]["kv_drift"]]
        assert warm == [d == 0.0 for d in want[rid].kv_drift]
        assert got[rid]["resyncs"] == want[rid].resyncs
    assert want[0].resyncs >= 1  # the policy resynced: not vacuous


def test_every_process_allocates_the_same_offsets(workers8):
    """(f) the symmetric heap over the whole hybrid sample (the SP
    attention calls, the KV gathers, the hand-offs, the cfg exchanges):
    the same offsets in every process."""
    offsets = [w[0]["offsets"] for w in workers8]
    assert offsets[0] and all(o == offsets[0] for o in offsets)
    high = [w[0]["heap_bytes"] for w in workers8]
    served = [w[1]["heap_bytes"] for w in workers8]
    print(f"slab high-water mark per process: sample {high} B, served "
          f"{served} B of {procs.SLAB_BYTES['cpu']} B")
    assert max(high + served) <= procs.SLAB_BYTES["cpu"]


def test_a_block_across_two_pipe_stages_is_refused():
    """(g) two processes on (cfg 2, pipe 2, data 1, model 2): each block
    of 4 ranks spans both pipe stages."""
    mesh = Mesh(HYBRID_MESH[1], HYBRID_MESH[0], torch.device("cpu"),
                process=0, procs=2)
    with pytest.raises(ValueError, match="within one coordinate"):
        mesh.check_blocks(("model",))
    q = torch.zeros((2, 8, 2, 8))
    with pytest.raises(ValueError, match="pipe coordinates"):
        sp_attention(q, q, q, cfg=SPConfig(**HYBRID_SP), mesh=mesh)
    Mesh(HYBRID_MESH[1], HYBRID_MESH[0], torch.device("cpu"), process=0,
         procs=4).check_blocks(("model",))


def test_owner_map_follows_the_mesh():
    """The sliced SP list of (cfg 2, pipe 2, data 1, model 4) over 8
    processes: the pipe replicas own different processes, and the flat-rank
    rule (index = flat rank) would not say so."""
    owners = []
    for q in range(8):
        mesh = Mesh(("cfg", "pipe", "data", "model"), (2, 2, 1, 4),
                    torch.device("cpu"), process=q, procs=8)
        owners.append(mesh.owner_map(("cfg", "data", "model")))
    # entry 5 is (cfg 1, model 1): process 4 at pipe 0, process 6 at pipe 1
    assert owners[0].owner(5) == (4, 1) and owners[2].owner(5) == (6, 1)
    assert owners[4].owned == (4, 5) and owners[6].owned == (4, 5)
    assert divmod(5, 8 // 8) != owners[0].owner(5)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _latent_lines(out: str) -> list[tuple[str, str]]:
    """(rid, the SHA-256 digest of its latents) per request line."""
    return re.findall(
        r"^request (\d+): latents \(16, 64\) latency [\d.]+ ms mean\|x\| "
        r"[\d.]+ sha256 ([0-9a-f]{16})", out, re.M)


@pytest.mark.parametrize("mesh", [["--mesh", "host", "--data", "2",
                                   "--model", "2"], ["--mesh", "multipod"]],
                         ids=["host-data", "multipod"])
def test_the_launcher_serves_data_meshes_over_processes(mesh, capfd):
    """``launch.serve --procs 4`` on a mesh with a data axis: exit 0, the
    blocks line, and the latents of the launcher without ``--procs``, bit
    for bit (their digests)."""
    from repro_torch.launch import serve

    argv = ["--arch", "flux-12b", "--reduced", "--device", "cpu", "--seq",
            "16", "--steps", "1", "--requests", "2", *mesh]
    assert serve.main(argv) == 0
    want = _latent_lines(capfd.readouterr().out)
    assert serve.main(argv + ["--procs", "4"]) == 0
    out = capfd.readouterr().out
    got = _latent_lines(out)
    assert len(want) == 2 and got == want
    line = next(l for l in out.splitlines()
                if l.startswith("process mesh: 4 processes"))
    assert "blocks 0: " in line and "data 1" in line
