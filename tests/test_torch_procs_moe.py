"""The port's MoE layer over a process mesh (launch/procs.py) on the CPU:
each process holds only its EP ranks' experts (``moe.held_experts``), the
token dispatch, the output combine, the decode sum and the aux mean are
puts with owner maps into the peers' slabs.

* against the reference: ``moe_block`` prefill over 4 processes on (data
  1, model 4) at capacity 1.25 (drops) and 8.0 (none), its replicated
  decode, and arctic's token-gather decode on (data 2, model 2), each
  within MOE_TOL of the reference's ``moe_block`` at the same EP degree on
  8 fake devices (one subprocess), the aux within 1e-6;
* against the mesh of virtual ranks: reduced qwen2-moe's prefill logits
  and aux bitwise under ring on (model 4) and swift_torus on (pod 2,
  model 2); its teacher-forced decode (bitwise on (model 4), where every
  process decodes the whole batch; within SP_TOL on (data 2, model 2));
  ``ARServer``'s tokens;
* each process's expert bytes 1/EP of the whole, and unheld experts
  refused; the puts each process issues; the same heap offsets on every
  process; the ``"ep"`` misroute (every stage hop of the exchange to the
  sender) breaking the match; training over processes still refused;
* blocks of two ranks a process (2 workers): moe_block's prefill, decode
  and token-gather decode and qwen2-moe's prefill bitwise the virtual
  mesh's, each process holding its 2 EP ranks' experts; ``init_lm(...,
  mesh=)`` cutting each layer as ``held_experts`` cuts the whole;
* the launcher: ``--procs 4`` prints the request lines of ``--procs 1``.

The workers run in one launch of 4 CPU workers and one of 2; every test,
fixture and worker runs with one intra-op thread.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import get_model as j_get_model
from repro_torch.configs import get_reduced
from repro_torch.core import SPConfig
from repro_torch.launch import make_mesh, procs
from repro_torch.launch.mesh import process_mesh
from repro_torch.models import (ParallelContext, get_model, init_lm,
                                lm_forward, torch_dtype)
from repro_torch.models.moe import expert_bytes, held_experts, moe_block
from repro_torch.serving import ARRequest, ARServer

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
PROCS = 4
PAIRS = 2  # the processes of the launch whose blocks hold 2 ranks each
MOE_TOL = 2e-4  # tests/test_moe.py
AUX_TOL = 1e-6
SP_TOL = 1e-4  # tests/multidevice/test_sp_strategies.py
F32 = dict(dtype="float32", sharding_overrides=())
EP_MESH = ((1, 4), ("data", "model"))
GATHER_MESH = ((2, 2), ("data", "model"))
CAPACITIES = (1.25, 8.0)
LM_MESHES = {"ring": (((4,), ("model",)), ("model",)),
             "swift_torus": (((2, 2), ("pod", "model")), ("pod", "model"))}
DECODE_MESHES = {"model": ((4,), ("model",)), "data": GATHER_MESH}
B, L = 2, 32
REQUESTS = [(0, [1, 2, 3], 6), (1, [4, 5, 6, 7], 6), (2, [8, 9, 10, 11, 12], 6)]

_JAX_EP = """
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_reduced
from repro.core import SPConfig
from repro.models import ParallelContext
from repro.models import moe
d = dict(np.load({inputs!r}))
tree = lambda pre: {{"router": {{"w": jnp.asarray(d[pre + "router"])}},
                    **{{k: jnp.asarray(d[pre + k])
                       for k in ("wi_gate", "wi_up", "wo")}}}}
def cfg_of(arch, **m):
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32",
                              sharding_overrides=())
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **m))
def mesh_of(shape):
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
sp = SPConfig(strategy="full", sp_axes=("model",), batch_axes=("data",))
out = {{}}
def run(key, arch, pre, x, shape, mode, caps=(1.25,), **kw):
    for cap in caps:
        cfg = cfg_of(arch, capacity_factor=cap)
        ctx = ParallelContext(mesh_of(shape), sp, mode, **kw)
        y, aux = jax.jit(lambda p, x: moe.moe_block(x, p, cfg, ctx))(
            tree(pre), jnp.asarray(d[x]))
        out[f"{{key}}{{cap}}/y"], out[f"{{key}}{{cap}}/aux"] = (
            np.asarray(y), np.asarray(aux))
run("prefill", "qwen2-moe-a2.7b", "qwen/", "x", {ep_mesh!r}, "prefill",
    {caps!r})
run("decode", "qwen2-moe-a2.7b", "qwen/", "xd", {ep_mesh!r}, "decode")
run("gather", "arctic-480b", "arctic/", "xd", {gather_mesh!r}, "decode",
    ep_token_gather=True)
np.savez({outputs!r}, **out)
"""


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _cfg(arch: str, **moe):
    cfg = dataclasses.replace(get_reduced(arch), **F32)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))


def _layer(arch: str, ep: int, seed: int) -> dict:
    """Layer 0's MoE weights of the reference's EP-padded init, numpy."""
    jcfg = dataclasses.replace(j_get_reduced(arch), **F32)
    params, _ = j_get_model(jcfg).init(jcfg, jax.random.PRNGKey(seed), ep)
    return jax.tree.map(lambda a: np.array(a[0]), params["layers"]["moe"])


def _torch(tree) -> dict:
    return jax.tree.map(lambda a: torch.from_numpy(np.ascontiguousarray(a)),
                        tree)


@pytest.fixture(scope="module")
def blocks():
    """The MoE layers and inputs held against the reference: qwen2-moe's
    (reduced, padded for EP 4) and arctic's (for EP 2), x [2, 16, d] for
    prefill and [4, 1, d] for decode."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(32)
    return dict(qwen=_layer("qwen2-moe-a2.7b", 4, 0),
                arctic=_layer("arctic-480b", 2, 1),
                x=rng.standard_normal((2, 16, 128)).astype(np.float32),
                xd=rng.standard_normal((4, 1, 128)).astype(np.float32))


def _block_case(blocks, arch, tree, x, mesh, mode, cap=1.25, **kw) -> dict:
    return dict(arch=arch, reduced=True, cfg=F32,
                moe={"capacity_factor": cap}, layer=_torch(blocks[tree]),
                x=torch.from_numpy(blocks[x]), mesh=mesh,
                sp=dict(strategy="full", sp_axes=("model",),
                        batch_axes=("data",), comm_backend="pallas",
                        kernel_interpret=False), mode=mode, **kw)


def _block_cases(blocks) -> dict:
    cases = {f"prefill{c}": _block_case(blocks, "qwen2-moe-a2.7b", "qwen",
                                        "x", EP_MESH, "prefill", c)
             for c in CAPACITIES}
    cases["decode1.25"] = _block_case(blocks, "qwen2-moe-a2.7b", "qwen", "xd",
                                      EP_MESH, "decode")
    cases["gather1.25"] = _block_case(blocks, "arctic-480b", "arctic", "xd",
                                      GATHER_MESH, "decode",
                                      ep_token_gather=True)
    return cases


def _lm_spec(strategy: str = "ring", mesh=None, **kw) -> dict:
    mesh, sp_axes = LM_MESHES[strategy] if mesh is None else (mesh, None)
    return dict(arch="qwen2-moe-a2.7b", reduced=True, cfg=F32, seed=7,
                shape=(B, L), mesh=mesh,
                sp=dict(strategy=strategy,
                        sp_axes=sp_axes or tuple(a for a in mesh[1]
                                                 if a != "data"),
                        batch_axes=("data",), comm_backend="pallas",
                        kernel_interpret=False), **kw)


def _ar_spec() -> dict:
    return dict(_lm_spec(), max_len=L, slots=4, requests=REQUESTS)


@pytest.fixture(scope="module")
def workers(blocks):
    """One launch of 4 CPU workers: the moe_block cases, qwen2-moe's
    prefill on both meshes and misrouted, its decode on (model 4) and
    (data 2, model 2), and a served run."""
    bcases = _block_cases(blocks)
    lcases = {s: _lm_spec(s) for s in LM_MESHES}
    lcases["wrong/ep"] = _lm_spec(wrong_route="ep")
    dcases = {k: _lm_spec("ring", m) for k, m in DECODE_MESHES.items()}
    res = procs.launch(procs.chain_job, PROCS, [
        (procs.moe_block_job, (list(bcases.values()),)),
        (procs.lm_prefill_job, (list(lcases.values()),)),
        (procs.lm_decode_job, (list(dcases.values()),)),
        (procs.ar_serve_job, (_ar_spec(),))], device="cpu", threads=1)
    got = {}
    for j, names in enumerate((bcases, lcases, dcases)):
        for n, name in enumerate(names):
            got[("block", "prefill", "decode")[j] + "/" + name] = [
                w[j][n] for w in res]
    got["ar"] = [w[3] for w in res]
    return dict(block=bcases, prefill=lcases, decode=dcases), got


@pytest.fixture(scope="module")
def pairs(blocks):
    """One launch of 2 CPU workers, a block of 2 ranks each: the moe_block
    cases at capacity 1.25 and qwen2-moe's ring prefill on (model 4)."""
    bcases = {k: v for k, v in _block_cases(blocks).items()
              if k.endswith("1.25")}
    lcase = _lm_spec("ring")
    res = procs.launch(procs.chain_job, PAIRS, [
        (procs.moe_block_job, (list(bcases.values()),)),
        (procs.lm_prefill_job, ([lcase],))], device="cpu", threads=1)
    got = {f"block/{name}": [w[0][n] for w in res]
           for n, name in enumerate(bcases)}
    got["prefill/ring"] = [w[1][0] for w in res]
    return dict(bcases, ring=lcase), got


@pytest.fixture(scope="module")
def jax_ep(blocks, tmp_path_factory):
    """The reference's moe_block at EP 4 on (data 1, model 4) (prefill at
    both capacities, decode) and its token-gather decode on (data 2, model
    2), on 8 fake devices with Auto axes, in one subprocess."""
    tmp = tmp_path_factory.mktemp("jax_procs_moe")
    flat = {f"{k}/{n}": (v["w"] if n == "router" else v)
            for k in ("qwen", "arctic") for n, v in blocks[k].items()}
    np.savez(tmp / "in.npz", x=blocks["x"], xd=blocks["xd"], **flat)
    code = _JAX_EP.format(inputs=str(tmp / "in.npz"),
                          outputs=str(tmp / "out.npz"), ep_mesh=EP_MESH[0],
                          gather_mesh=GATHER_MESH[0], caps=CAPACITIES)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


def _assemble(results, key: str) -> torch.Tensor:
    """The whole batch from every process's part (rows and batch slice)."""
    b = max(r["batch"][1] for r in results)
    l = max(r["rows"][1] for r in results)
    first = results[0][key]
    out = torch.full((b, l) + tuple(first.shape[2:]), float("nan"))
    for r in results:
        (b0, b1), (l0, l1) = r["batch"], r["rows"]
        out[b0:b1, l0:l1] = r[key]
    assert not out.isnan().any()
    return out


def _virtual(spec: dict, mode: str = "prefill"):
    """qwen2-moe's case on the mesh of virtual ranks of its mesh, in this
    process: (logits, aux) of the prefill, or the teacher-forced decode's
    logits."""
    cfg, params = procs._lm_params(spec, CPU)
    tokens = procs.lm_inputs(spec, cfg, CPU)["tokens"]
    ctx = ParallelContext(SPConfig(**spec["sp"]), mode, CPU,
                          mesh=make_mesh(*spec["mesh"], device="cpu"))
    with torch.inference_mode():
        if mode == "prefill":
            logits, aux, _ = lm_forward(params, cfg, ctx, tokens=tokens)
            return logits, aux
        bundle = get_model(cfg)
        caches = bundle.init_caches(cfg, B, L, torch.float32, CPU)
        outs = []
        for t in range(L):
            logit, caches = bundle.step(params, {"tokens": tokens[:, t:t + 1]},
                                        caches, t, cfg, ctx)
            outs.append(logit)
        return torch.stack(outs, dim=1)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", CAPACITIES)
def test_moe_prefill_over_processes_matches_reference(workers, jax_ep, cap):
    """moe_block's prefill over 4 processes, one EP rank each (a token
    shard of 4 rows a process): y within MOE_TOL of the reference's at EP
    4, the aux (the mean over every mesh point, gathered by puts) within
    AUX_TOL on every process.  At capacity 1.25 slots are dropped, the
    same as the reference drops."""
    _, got = workers
    res = got[f"block/prefill{cap}"]
    np.testing.assert_allclose(_assemble(res, "y").numpy(),
                               jax_ep[f"prefill{cap}/y"], rtol=MOE_TOL,
                               atol=MOE_TOL)
    for r in res:
        np.testing.assert_allclose(float(r["aux"]), jax_ep[f"prefill{cap}/aux"],
                                   rtol=AUX_TOL)
    assert np.abs(jax_ep["prefill1.25/y"] - jax_ep["prefill8.0/y"]).max() > \
        MOE_TOL, "nothing was dropped at capacity 1.25: the check is vacuous"


def test_moe_decode_over_processes_matches_reference(workers, jax_ep):
    """The replicated decode: each process's EP rank's contribution to
    every token, the four gathered over 'model' by puts and summed in rank
    order, within MOE_TOL of the reference's psum."""
    _, got = workers
    for r in got["block/decode1.25"]:
        np.testing.assert_allclose(r["y"].numpy(), jax_ep["decode1.25/y"],
                                   rtol=MOE_TOL, atol=MOE_TOL)
        np.testing.assert_allclose(float(r["aux"]), jax_ep["decode1.25/aux"],
                                   rtol=AUX_TOL)


def test_token_gather_decode_over_processes_matches_reference(workers,
                                                              jax_ep):
    """arctic's token-gather decode on (data 2, model 2), one point a
    process: the tokens gathered over data, each (EP rank, hidden slice)'s
    partial on a view of the held experts, the partials gathered and
    summed EP-rank-major, the process's batch slice given back."""
    _, got = workers
    res = got["block/gather1.25"]
    assert [r["batch"] for r in res] == [(0, 2), (0, 2), (2, 4), (2, 4)]
    np.testing.assert_allclose(_assemble(res, "y").numpy(),
                               jax_ep["gather1.25/y"], rtol=MOE_TOL,
                               atol=MOE_TOL)
    for r in res:
        np.testing.assert_allclose(float(r["aux"]), jax_ep["gather1.25/aux"],
                                   rtol=AUX_TOL)


# ---------------------------------------------------------------------------
# against the mesh of virtual ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", LM_MESHES)
def test_moe_prefill_over_processes_is_the_virtual_mesh(workers, strategy):
    """qwen2-moe's prefill: each process's logits rows and its aux bitwise
    the mesh of virtual ranks' (a shard over processes is the same shard,
    so the same tokens are dropped at capacity 1.25)."""
    cases, got = workers
    want, aux = _virtual(cases["prefill"][strategy])
    for r in got[f"prefill/{strategy}"]:
        (b0, b1), (l0, l1) = r["batch"], r["rows"]
        assert torch.equal(r["logits"], want[b0:b1, l0:l1])
        assert torch.equal(r["aux"], aux)


@pytest.mark.parametrize("mesh", DECODE_MESHES)
def test_moe_decode_over_processes_is_the_virtual_mesh(workers, mesh):
    """The teacher-forced decode: on (model 4) every process decodes the
    whole batch and the gathered EP ranks' sum is bitwise the virtual
    mesh's; on (data 2, model 2) a process decodes its slice's one row,
    whose products the CPU's BLAS rounds otherwise than the batch's two
    (measured 6.7e-6), so within SP_TOL."""
    cases, got = workers
    want = _virtual(cases["decode"][mesh], "decode")
    for r in got[f"decode/{mesh}"]:
        b0, b1 = r["batch"]
        if mesh == "model":
            assert torch.equal(r["logits"], want)
        else:
            assert (r["logits"] - want[b0:b1]).abs().max() <= SP_TOL * \
                want.abs().max()


def test_moe_ar_server_over_processes_is_the_virtual_mesh(workers):
    """ARServer led by process 0 on (model 4), each process with its EP
    rank's experts: the virtual-mesh server's tokens."""
    _, got = workers
    spec = _ar_spec()
    cfg, params = procs._lm_params(spec, CPU)
    srv = ARServer(params, cfg, SPConfig(**spec["sp"]), batch_slots=4,
                   max_len=L, cache_dtype=torch_dtype(cfg.dtype),
                   device="cpu", mesh=make_mesh(*spec["mesh"], device="cpu"))
    for rid, prompt, new in REQUESTS:
        srv.submit(ARRequest(rid=rid, prompt=torch.tensor(prompt),
                             max_new_tokens=new))
    assert got["ar"][0]["tokens"] == srv.serve()


# ---------------------------------------------------------------------------
# the experts each process holds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name, ep", [("prefill/ring", 4),
                                      ("prefill/swift_torus", 2), ("ar", 4),
                                      ("block/gather1.25", 2)])
def test_each_process_holds_its_experts(workers, name, ep):
    """A process's routed-expert bytes are 1/EP of the whole model's."""
    cases, got = workers
    if name == "block/gather1.25":
        whole = expert_bytes({"layers": [{"moe": _torch(
            cases["block"]["gather1.25"]["layer"])}]})
    else:
        spec = (cases["prefill"][name.split("/")[1]] if "/" in name
                else _ar_spec())
        whole = expert_bytes(procs._lm_params(spec, CPU)[1])
    assert [r["expert_bytes"] for r in got[name]] == [whole // ep] * PROCS


@pytest.mark.parametrize("name", ["prefill1.25", "decode1.25",
                                  "gather1.25"])
def test_blocks_of_two_ranks_are_the_virtual_mesh(pairs, name):
    """moe_block over 2 processes of 2 ranks each.  On (data 1, model 4) a
    process holds 2 EP ranks' experts (the cut [2 m · e_local, (2 m + 2) ·
    e_local), each rank's a view offset from its first): in prefill its
    part is split over its 2 SP ranks, in decode its 2 contributions go
    out as one stack.  On (data 2, model 2) a process is a data slice
    holding both EP ranks, its 2 partials gathered as one stack.  y
    bitwise the virtual mesh's on the same inputs, the aux equal, the
    expert bytes the 2 held EP ranks' share, the heap offsets the same on
    both processes."""
    cases, got = pairs
    spec = cases[name]
    cfg = _cfg(spec["arch"], **spec["moe"])
    mesh = make_mesh(*spec["mesh"], device="cpu")
    ctx = ParallelContext(SPConfig(**spec["sp"]), spec["mode"], CPU,
                          mesh=mesh,
                          ep_token_gather=spec.get("ep_token_gather", False))
    with torch.inference_mode():
        want, aux = moe_block(spec["x"], spec["layer"], cfg, ctx)
    whole = expert_bytes({"layers": [{"moe": spec["layer"]}]})
    res = got[f"block/{name}"]
    for r in res:
        (b0, b1), (l0, l1) = r["batch"], r["rows"]
        assert torch.equal(r["y"], want[b0:b1, l0:l1])
        assert torch.equal(r["aux"], aux)
        assert r["expert_bytes"] == whole * 2 // mesh.shape["model"]
        assert r["offsets"] and r["offsets"] == res[0]["offsets"]


def test_moe_prefill_in_blocks_of_two_is_the_virtual_mesh(pairs):
    """qwen2-moe's ring prefill on (model 4) over 2 processes of 2 ranks
    each: each process's logits rows and its aux bitwise the virtual
    mesh's, its experts half of the whole."""
    cases, got = pairs
    want, aux = _virtual(cases["ring"])
    whole = expert_bytes(procs._lm_params(cases["ring"], CPU)[1])
    for r in got["prefill/ring"]:
        (b0, b1), (l0, l1) = r["batch"], r["rows"]
        assert (l1 - l0) == L // PAIRS
        assert torch.equal(r["logits"], want[b0:b1, l0:l1])
        assert torch.equal(r["aux"], aux)
        assert r["expert_bytes"] == whole // PAIRS


@pytest.mark.parametrize("n_procs, process", [(4, 1), (2, 1)])
def test_init_cuts_each_layer_as_the_whole_is_cut(n_procs, process):
    """``init_lm(..., mesh=)`` on a process mesh cuts each MoE layer as it
    builds it: the same tensors as ``held_experts`` of the whole init, on
    a process holding 1 and 2 of 4 EP ranks."""
    cfg = _cfg("qwen2-moe-a2.7b")
    mesh = process_mesh(make_mesh((4,), ("model",), device="cpu"), process,
                        n_procs)
    gen = lambda: torch.Generator().manual_seed(3)
    cut = init_lm(cfg, gen(), "cpu", mesh=mesh)
    want = held_experts(init_lm(cfg, gen(), "cpu", ep_degree=4), cfg, mesh)
    flat = lambda t: {k: v for k, v in _leaves(t)}
    assert flat(cut).keys() == flat(want).keys()
    for k, v in flat(want).items():
        assert torch.equal(flat(cut)[k], v), k
    assert expert_bytes(cut) * n_procs == expert_bytes(
        init_lm(cfg, gen(), "cpu", ep_degree=4))


def _leaves(tree, prefix=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# ---------------------------------------------------------------------------
# the puts, the heap, the negative control
# ---------------------------------------------------------------------------

def test_puts_of_the_moe_layer_over_processes(workers):
    """The puts each process issues: in prefill 3 exchanges x (P - 1)
    stage puts over 'model' and the aux gather's P - 1 over every axis; in
    decode the contributions' gather, P - 1 over 'model'; in the
    token-gather decode the tokens' gather over data, then the partials'
    over (data, model)."""
    _, got = workers
    want = {"prefill1.25": [("a2a", ("model",))] * 9
            + [("gather", ("data", "model"))] * 3,
            "decode1.25": [("gather", ("model",))] * 3,
            "gather1.25": [("gather", ("data",))]
            + [("gather", ("data", "model"))] * 3}
    for name, puts in want.items():
        for r in got[f"block/{name}"]:
            assert r["puts"] == puts, name


@pytest.mark.parametrize("name", ["block/prefill1.25", "block/gather1.25",
                                  "prefill/swift_torus", "decode/data", "ar"])
def test_every_process_allocates_the_same_heap_offsets(workers, name):
    _, got = workers
    offsets = [r["offsets"] for r in got[name]]
    assert offsets[0] and all(o == offsets[0] for o in offsets)


def test_ep_misroute_breaks_the_match(workers):
    """Every stage hop of the MoE exchange (tokens, expert ids, outputs)
    put to the sender itself: each rank's tokens meet its own experts
    only, and the rows move far from the virtual mesh's on every
    process."""
    cases, got = workers
    spec = dict(cases["prefill"]["wrong/ep"])
    spec.pop("wrong_route")
    want, _ = _virtual(spec)
    for r in got["prefill/wrong/ep"]:
        (b0, b1), (l0, l1) = r["batch"], r["rows"]
        rel = (r["logits"] - want[b0:b1, l0:l1]).abs().max() / want.abs().max()
        assert rel > 0.1


def test_moe_train_and_grad_over_processes_are_refused():
    """Training the MoE family over processes stays ROADMAP Queue 1 item
    12: train mode, or a forward with grad mode on, raises at lm_forward
    and at moe_block."""
    cfg = _cfg("qwen2-moe-a2.7b")
    mesh = process_mesh(make_mesh((4,), ("model",), device="cpu"), 0, PROCS)
    params = init_lm(cfg, device="cpu", mesh=mesh)
    sp = SPConfig(strategy="ring", sp_axes=("model",))
    tokens = torch.zeros((1, L // 4), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        lm_forward(params, cfg, ParallelContext(sp, "train", mesh=mesh),
                   tokens=tokens, seq_len=L)
    with torch.enable_grad(), pytest.raises(NotImplementedError,
                                            match="Queue 1 item 12"):
        moe_block(torch.zeros((1, L // 4, cfg.d_model)),
                  params["layers"][0]["moe"], cfg,
                  ParallelContext(sp, "prefill", mesh=mesh))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_serves_the_moe_lm_over_processes():
    """``launch.serve --arch qwen2-moe-a2.7b --procs 4`` on (model 4), each
    process holding its EP rank's experts: the request lines of the run
    without ``--procs``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    args = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
            "qwen2-moe-a2.7b", "--reduced", "--device", "cpu", "--mesh",
            "host", "--model", "4", "--eager"]
    runs = [subprocess.run(a, env=env, capture_output=True, text=True,
                           timeout=300)
            for a in (args, args + ["--procs", "4"])]
    for p in runs:
        assert p.returncode == 0, p.stderr[-2000:]
    one, four = ([x for x in p.stdout.splitlines() if x.startswith("request ")]
                 for p in runs)
    assert len(one) == 4 and four == one
    assert "process mesh: 4 processes, 1 of 4 ranks each" in runs[1].stdout
