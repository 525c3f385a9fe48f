"""The port's language models over a process mesh (launch/procs.py) on the
CPU: each process runs its batch slice and its run of SP ranks' sequence
shards, the token shifts, the state passes and the decode merge's gather
are puts into the peers' slabs with their rank lists' owner maps.

* (i) reduced qwen2-1.5b in float32 (tests/test_torch_dense.py's weights)
  on SP_MESH (pod 2, data 2, model 2): its SP prefill (swift,
  swift_torus) and its teacher-forced SP decode over 4 processes, two
  ranks each, within SP_TOL of the reference's on 8 fake devices (one
  subprocess running tests/test_torch_dense.py's program).
* (ii) the prefill of qwen2, hymba (4 layers: global and windowed
  attention and the SSD state passes), rwkv6 (K5's plain version per
  owned shard, the token shifts and the WKV state passes), qwen2-vl
  (the shards of its frontend embeddings and M-RoPE positions) and
  whisper (Lq != Lk in the cross-attention) over processes: each process's rows
  bitwise the same rows of the mesh of virtual ranks (every GEMM here runs
  on the same rows as there), and ``last_only`` on the process that holds
  the final position.
* (iii) ``ARServer`` led by process 0: the virtual-mesh server's tokens.
* (iv) the negative controls: every Ulysses hop, every token shift, or
  every put of the SSD state passes, put to the sender itself breaks
  (ii).
* (v) every process allocates the same heap offsets.
* serve_job's negative control on a mesh without a cfg axis (every
  Ulysses hop of a served DiT run to the sender itself) breaks the
  virtual-mesh server's latents.
* P1: reduced qwen2 over (data 2, model 2), ulysses and ring, and
  qwen2-moe (its experts over model, each process holding its EP rank's)
  under ring: each process's rows within SP_TOL of degree 1.
* the refusals: unheld experts (``moe.held_experts``), and, each naming
  its ROADMAP item, train mode and grad (item 12, rwkv6 too), a captured
  ``ARServer`` (item 13), whisper's cached decode (item 10).
* the launcher: ``--procs 4`` prints the tokens of ``--procs 1``.

The workers run in one launch of 4 CPU workers; every test, fixture and
worker runs with one intra-op thread.
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
                                init_whisper, init_whisper_caches, lm_forward,
                                torch_dtype)
from repro_torch.models import whisper as whisper_mod
from repro_torch.models.moe import held_experts, moe_block
from repro_torch.serving import (ARRequest, ARServer, DiTRequest, DiTServer,
                                 SamplerConfig)
from test_torch_dense import _JAX_SP, _flat, perturb

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SP_TOL = 1e-4  # tests/multidevice/test_sp_strategies.py
SP_MESH = ((2, 2, 2), ("pod", "data", "model"))
STRATEGIES = ("swift", "swift_torus")
P1_MESH = ((2, 2), ("data", "model"))
P1_STRATEGIES = ("ulysses", "ring")
B, L = 2, 32
F32 = dict(dtype="float32", sharding_overrides=())
FAMILIES = {"hymba-1.5b": {"n_layers": 4}, "rwkv6-1.6b": {},
            "qwen2-vl-2b": {}}
WHISPER_L = 16  # decoder tokens; the frames are the reduced encoder_seq, 64
REQUESTS = [(0, [1, 2, 3], 6), (1, [4, 5, 6, 7], 6), (2, [8, 9, 10, 11, 12], 6)]
PROCS = 4
# tests/test_torch_procs.py's served DiT run, one request, on (pod 2,
# model 2): no cfg axis, so serve_job's wrong_route misroutes its Ulysses
# hops
DIT_SERVE = dict(arch="flux-12b", reduced=True, cfg={"dtype": "float32"},
                 seed=5, mesh=((2, 2), ("pod", "model")), steps=2,
                 requests=[(2, 48)], wrong_route=True,
                 sp=dict(strategy="swift_torus", sp_axes=("pod", "model"),
                         batch_axes=None, comm_backend="pallas",
                         kernel_interpret=False))
LAST_ROW_TOL = 1e-6  # of max|logits|: a one-row product's last bits


def _sp(strategy: str, mesh=SP_MESH) -> dict:
    if mesh == SP_MESH:
        return dict(strategy=strategy, sp_axes=("pod", "model"),
                    batch_axes=("data",), machine_axis="pod",
                    comm_backend="pallas", kernel_interpret=False)
    return dict(strategy=strategy, sp_axes=("model",), batch_axes=("data",),
                comm_backend="pallas", kernel_interpret=False)


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def qwen2():
    """tests/test_torch_dense.py's reduced qwen2-1.5b in float32: the
    reference's init, perturbed, as a numpy tree; and B x L tokens."""
    torch.set_num_threads(1)
    arch = "qwen2-1.5b"
    jcfg = dataclasses.replace(j_get_reduced(arch), **F32)
    params, _ = j_get_model(jcfg).init(jcfg, jax.random.PRNGKey(0), 1)
    tree = jax.tree.map(np.array, params)
    rng = np.random.default_rng(sum(map(ord, arch)))
    perturb(tree, rng)
    tokens = rng.integers(0, jcfg.vocab, (B, L)).astype(np.int32)
    cfg = dataclasses.replace(get_reduced(arch), **F32)
    return cfg, tree, tokens


def _qwen2_spec(qwen2, strategy: str, mesh=SP_MESH, **kw) -> dict:
    _, tree, tokens = qwen2
    return dict(arch="qwen2-1.5b", reduced=True, cfg=F32, tree=tree,
                tokens=torch.from_numpy(tokens), mesh=mesh,
                sp=_sp(strategy, mesh), **kw)


def _seeded(arch: str, strategy="swift_torus", mesh=SP_MESH, **kw) -> dict:
    cfg = dict(F32, **FAMILIES.get(arch, {}))
    shape = (B, WHISPER_L, 64) if arch == "whisper-tiny" else (B, L)
    return dict(arch=arch, reduced=True, cfg=cfg, seed=11, shape=shape,
                mesh=mesh, sp=_sp(strategy, mesh), **kw)


def _cases(qwen2):
    """The prefill cases of the one launch, by name."""
    cases = {f"qwen2/{s}": _qwen2_spec(qwen2, s) for s in STRATEGIES}
    cases["qwen2/last_only"] = _qwen2_spec(qwen2, "swift_torus",
                                           last_only=True)
    for arch in (*FAMILIES, "whisper-tiny"):
        cases[arch] = _seeded(arch)
    cases["wrong/ulysses"] = _qwen2_spec(qwen2, "swift_torus",
                                         wrong_route="ulysses")
    cases["wrong/shift"] = _seeded("rwkv6-1.6b", wrong_route="shift")
    cases["wrong/state"] = _seeded("hymba-1.5b", wrong_route="state")
    for s in P1_STRATEGIES:
        cases[f"p1/{s}"] = _qwen2_spec(qwen2, s, P1_MESH)
    cases["p1/moe"] = _seeded("qwen2-moe-a2.7b", "ring", P1_MESH,
                              moe={"capacity_factor": 8.0})
    return cases


def _ar_spec(arch: str, qwen2) -> dict:
    spec = (_qwen2_spec(qwen2, "swift") if arch == "qwen2-1.5b"
            else _seeded(arch, "swift"))
    return dict(spec, max_len=L, slots=4, requests=REQUESTS)


@pytest.fixture(scope="module")
def workers(qwen2):
    """One launch of 4 CPU workers, two ranks of SP_MESH each: every
    prefill case (whisper's forward among them), the teacher-forced
    decode and three served runs."""
    cases = _cases(qwen2)
    res = procs.launch(procs.chain_job, PROCS, [
        (procs.lm_prefill_job, (list(cases.values()),)),
        (procs.lm_decode_job, ([_qwen2_spec(qwen2, "swift")],)),
        (procs.ar_serve_job, (_ar_spec("qwen2-1.5b", qwen2),)),
        (procs.ar_serve_job, (_ar_spec("hymba-1.5b", qwen2),)),
        (procs.serve_job, (DIT_SERVE,))],
        device="cpu", threads=1)
    by_name = {}
    for n, name in enumerate(cases):
        by_name[name] = [w[0][n] for w in res]
    by_name["decode"] = [w[1][0] for w in res]
    by_name["ar/qwen2-1.5b"] = [w[2] for w in res]
    by_name["ar/hymba-1.5b"] = [w[3] for w in res]
    by_name["dit/wrong"] = [w[4] for w in res]
    return cases, by_name


@pytest.fixture(scope="module")
def jax_sp(qwen2, tmp_path_factory):
    """The reference's qwen2 SP prefill (swift, swift_torus) and decode on
    SP_MESH over 8 fake devices: tests/test_torch_dense.py's program, in
    one subprocess."""
    _, tree, tokens = qwen2
    tmp = tmp_path_factory.mktemp("jax_procs_lm")
    np.savez(tmp / "in.npz", tokens=tokens, **dict(_flat(tree)))
    code = _JAX_SP.format(inputs=str(tmp / "in.npz"),
                          outputs=str(tmp / "out.npz"), shape=SP_MESH[0],
                          axes=SP_MESH[1], strategies=STRATEGIES)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


def _virtual(spec: dict, mode: str = "prefill", **kw) -> torch.Tensor:
    """The case on the mesh of virtual ranks of its mesh (or at degree 1
    with ``degree1``), in this process."""
    cfg, params = procs._lm_params(spec, CPU)
    inputs = procs.lm_inputs(spec, cfg, CPU)
    mesh = None if kw.pop("degree1", False) else make_mesh(*spec["mesh"],
                                                           device="cpu")
    ctx = ParallelContext(SPConfig(**spec["sp"]), mode, CPU, mesh=mesh)
    with torch.inference_mode():
        return get_model(cfg).apply(params, inputs, cfg, ctx, **kw)


def _assemble(results, key="logits") -> torch.Tensor:
    """The whole batch's logits from every process's rows."""
    b = max(r["batch"][1] for r in results)
    l = max(r["rows"][1] for r in results)
    first = results[0][key]
    out = torch.full((b, l) + tuple(first.shape[2:]), float("nan"))
    for r in results:
        (b0, b1), (l0, l1) = r["batch"], r["rows"]
        out[b0:b1, l0:l1] = r[key]
    assert not out.isnan().any()
    return out


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# (i) against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sp_prefill_over_processes_matches_reference(workers, jax_sp,
                                                     strategy):
    """qwen2's SP prefill over 4 processes, two ranks of SP_MESH each, the
    batch over data: within SP_TOL of the reference's."""
    _, got = workers
    logits = _assemble(got[f"qwen2/{strategy}"])
    assert _rel(logits, jax_sp[f"prefill/{strategy}"]) <= SP_TOL


def test_sp_decode_over_processes_matches_reference(workers, jax_sp):
    """qwen2's teacher-forced decode over 4 processes, the KV cache split
    across them (its slots over data, its positions over (pod, model)),
    the partials gathered by puts: within SP_TOL of the reference's."""
    _, got = workers
    parts = got["decode"]
    logits = torch.cat([parts[q]["logits"] for q in (0, 1)], dim=0)
    assert [p["batch"] for p in parts[:2]] == [(0, 1), (1, 2)]
    assert _rel(logits, jax_sp["decode"]) <= SP_TOL
    for q in (2, 3):  # the processes of a slice merge to the same bits
        assert torch.equal(parts[q]["logits"], parts[q - 2]["logits"])


# ---------------------------------------------------------------------------
# (ii) against the mesh of virtual ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [f"qwen2/{s}" for s in STRATEGIES]
                         + list(FAMILIES))
def test_prefill_over_processes_is_the_virtual_mesh(workers, name):
    """Each process's logits rows are bitwise the same rows of the mesh of
    virtual ranks (same weights, same tokens, same schedule)."""
    cases, got = workers
    want = _virtual(cases[name])
    for r in got[name]:
        (b0, b1), (l0, l1) = r["batch"], r["rows"]
        assert torch.equal(r["logits"], want[b0:b1, l0:l1])


def test_whisper_over_processes_is_the_virtual_mesh(workers):
    """whisper's teacher-forced forward over processes: each process
    encodes its shard of the 64 frames and decodes its shard of the 16
    tokens, the cross-attention's K/V shards at the memory's length (Lq 4,
    Lk 16 a rank): bitwise the virtual mesh's rows."""
    _, got = workers
    want = _virtual(_seeded("whisper-tiny"))
    for r in got["whisper-tiny"]:
        (b0, b1), (l0, l1) = r["batch"], r["rows"]
        assert r["rows"][1] - r["rows"][0] == WHISPER_L // 2
        assert torch.equal(r["logits"], want[b0:b1, l0:l1])


def test_last_only_on_the_process_that_holds_it(workers, qwen2):
    """``last_only``: the final position's logits on the processes whose
    shard ends the sequence, zero rows on the others.  The logits of one
    row are a product of one row by the head (its batch slice's), where
    the virtual mesh's has the batch's two rows: the CPU's BLAS takes
    another path for one row, and the last bits differ (1.7e-7 of
    max|logits|), so they are held within LAST_ROW_TOL, not bitwise."""
    cases, got = workers
    want = _virtual(cases["qwen2/last_only"], last_only=True)
    for r in got["qwen2/last_only"]:
        b0, b1 = r["batch"]
        if r["rows"][1] == L:
            assert _rel(r["logits"], want[b0:b1]) <= LAST_ROW_TOL
        else:
            assert r["logits"].shape[1] == 0


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "hymba-1.5b"])
def test_ar_server_over_processes_is_the_virtual_mesh(workers, qwen2, arch):
    """ARServer led by process 0, each process decoding its slice's slots
    with its part of the caches: the virtual-mesh server's tokens."""
    _, got = workers
    spec = _ar_spec(arch, qwen2)
    cfg, params = procs._lm_params(spec, CPU)
    srv = ARServer(params, cfg, SPConfig(**spec["sp"]), batch_slots=4,
                   max_len=L, cache_dtype=torch_dtype(cfg.dtype),
                   device="cpu", mesh=make_mesh(*SP_MESH, device="cpu"))
    for rid, prompt, new in REQUESTS:
        srv.submit(ARRequest(rid=rid, prompt=torch.tensor(prompt),
                             max_new_tokens=new))
    want = srv.serve()
    results = got[f"ar/{arch}"]
    assert results[0]["tokens"] == want
    assert [r["rows"] for r in results] == [(0, 2), (2, 4)] * 2


# ---------------------------------------------------------------------------
# (iv) negative controls, (v) the heap's symmetry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["wrong/ulysses", "wrong/shift",
                                  "wrong/state"])
def test_misrouted_puts_break_the_match(workers, name):
    """Every Ulysses hop of qwen2's swift_torus, every token shift of
    rwkv6, or every put of hymba's SSD state passes, put to the sender
    itself: the rows move far from the virtual mesh's on every
    process."""
    cases, got = workers
    spec = dict(cases[name])
    spec.pop("wrong_route")
    want = _virtual(spec)
    for r in got[name]:
        (b0, b1), (l0, l1) = r["batch"], r["rows"]
        assert _rel(r["logits"], want[b0:b1, l0:l1]) > 0.1


def test_serve_job_misroutes_ulysses_hops_without_a_cfg_axis(workers):
    """serve_job's ``wrong_route`` on a mesh without a cfg axis puts every
    Ulysses stage hop to the sender itself (chip_smoke.py's serve-procs
    control): the served latents move far from the virtual-mesh
    server's."""
    _, got = workers
    cfg, params = procs._dit_params(DIT_SERVE, CPU)
    srv = DiTServer(params, cfg, SPConfig(**DIT_SERVE["sp"]),
                    mesh=make_mesh(*DIT_SERVE["mesh"], device="cpu"),
                    sampler=SamplerConfig(num_steps=DIT_SERVE["steps"]),
                    device="cpu")
    ((rid, seq),) = DIT_SERVE["requests"]
    gen = torch.Generator().manual_seed(DIT_SERVE["seed"] + 2 + rid)
    srv.submit(DiTRequest(rid=rid, seq_len=seq, cond=torch.randn(
        (256, cfg.d_model), generator=gen)))
    (want,) = srv.serve()
    bad = got["dit/wrong"][0]["latents"][rid]
    assert bad.shape == want.latents.shape
    assert _rel(bad, want.latents) > 1e-2


@pytest.mark.parametrize("name", ["qwen2/swift_torus", "hymba-1.5b",
                                  "rwkv6-1.6b", "whisper-tiny", "decode",
                                  "ar/qwen2-1.5b"])
def test_every_process_allocates_the_same_heap_offsets(workers, name):
    _, got = workers
    offsets = [r["offsets"] for r in got[name]]
    assert offsets[0] and all(o == offsets[0] for o in offsets)


# ---------------------------------------------------------------------------
# P1: the LM prefill over processes computes the sharded forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", P1_STRATEGIES)
def test_p1_lm_prefill_over_processes_matches_degree_1(workers, strategy):
    """Reduced qwen2, float32, B 2 x L 32 over (data 2, model 2), one
    process per rank: each process's rows within SP_TOL of degree 1 (the
    tree before this slice gave every process the whole sequence and got
    rows up to 2.91 off)."""
    cases, got = workers
    spec = cases[f"p1/{strategy}"]
    want = _virtual(spec, degree1=True)
    for r in got[f"p1/{strategy}"]:
        (b0, b1), (l0, l1) = r["batch"], r["rows"]
        assert (l1 - l0, b1 - b0) == (L // 2, 1)
        assert _rel(r["logits"], want[b0:b1, l0:l1]) <= SP_TOL


def test_p1_moe_prefill_over_processes_is_refused(workers):
    """No longer refused: reduced qwen2-moe, float32, B 2 x L 32 over
    (data 2, model 2) under ring, one process per rank, each holding its
    EP rank's experts: each process's rows within SP_TOL of degree 1 (at
    capacity 8.0, which drops nothing: a shard's capacity depends on its
    token count)."""
    cases, got = workers
    want = _virtual(cases["p1/moe"], degree1=True)
    for r in got["p1/moe"]:
        (b0, b1), (l0, l1) = r["batch"], r["rows"]
        assert (l1 - l0, b1 - b0) == (L // 2, 1)
        assert _rel(r["logits"], want[b0:b1, l0:l1]) <= SP_TOL


# ---------------------------------------------------------------------------
# refusals (in this process: each raises before any put)
# ---------------------------------------------------------------------------

def _procs_ctx(mode="prefill", strategy="swift_torus"):
    mesh = process_mesh(make_mesh(*SP_MESH, device="cpu"), 1, PROCS)
    return ParallelContext(SPConfig(**_sp(strategy)), mode, mesh=mesh)


def _small(arch: str, **kw):
    cfg = dataclasses.replace(get_reduced(arch), **F32, **kw)
    init = init_whisper if cfg.family == "audio" else init_lm
    return cfg, init(cfg, device="cpu")


def test_moe_over_processes_is_refused():
    """Experts that are not the process's own are refused by moe_block,
    lm_forward and ARServer, naming held_experts; the cut holds EP rank
    1's experts as clones of the whole's, and leaves a mesh of virtual
    ranks' params as they are."""
    cfg, params = _small("qwen2-moe-a2.7b")
    mesh = process_mesh(make_mesh((4,), ("model",), device="cpu"), 1, PROCS)
    sp = SPConfig(strategy="ring", sp_axes=("model",))
    ctx = ParallelContext(sp, "prefill", mesh=mesh)
    tokens = torch.zeros((1, L // 4), dtype=torch.int64)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="held_experts"):
            lm_forward(params, cfg, ctx, tokens=tokens, seq_len=L)
        with pytest.raises(ValueError, match="held_experts"):
            moe_block(torch.zeros((1, L // 4, cfg.d_model)),
                      params["layers"][0]["moe"], cfg, ctx)
    with pytest.raises(ValueError, match="held_experts"):
        ARServer(params, cfg, sp, max_len=L, mesh=mesh, capture=False)
    held = held_experts(params, cfg, mesh)
    whole, cut = params["layers"][0]["moe"], held["layers"][0]["moe"]
    assert torch.equal(cut["wi_up"], whole["wi_up"][1:2])
    assert cut["wo"].data_ptr() != whole["wo"].data_ptr()
    assert cut["router"]["w"] is whole["router"]["w"]
    assert held_experts(params, cfg, make_mesh((4,), ("model",),
                                               device="cpu")) is params


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "rwkv6-1.6b", "hymba-1.5b"])
def test_train_and_grad_over_processes_are_refused(arch):
    """Train mode, or a forward with grad mode on, over a process mesh:
    refused at lm_forward's entry (rwkv6 has no attention to refuse
    it)."""
    cfg, params = _small(arch)
    tokens = torch.zeros((1, L // 2), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        lm_forward(params, cfg, _procs_ctx("train"), tokens=tokens,
                   seq_len=L)
    with torch.enable_grad(), pytest.raises(NotImplementedError,
                                            match="Queue 1 item 12"):
        lm_forward(params, cfg, _procs_ctx(), tokens=tokens, seq_len=L)


def test_whisper_train_and_cached_decode_over_processes_are_refused():
    cfg, params = _small("whisper-tiny")
    frames = torch.zeros((1, 16, cfg.d_model))
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        whisper_mod.encode(params, frames, cfg, _procs_ctx("train"),
                           seq_len=64)
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        init_whisper_caches(cfg, 2, 32, torch.float32, "cpu",
                            mesh=_procs_ctx().mesh, sp=_procs_ctx().sp)
    with torch.inference_mode(), pytest.raises(NotImplementedError,
                                               match="Queue 1 item 10"):
        whisper_mod.decode_forward(
            params, cfg, _procs_ctx("decode"),
            tokens=torch.zeros((1, 1), dtype=torch.int64),
            memory=frames, caches={}, cur_index=0)


def test_captured_ar_server_over_processes_is_refused():
    cfg, params = _small("qwen2-1.5b")
    ctx = _procs_ctx()
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        ARServer(params, cfg, ctx.sp, max_len=L, mesh=ctx.mesh,
                 capture=True)


def test_shard_positions_must_be_the_shards_own():
    """qwen2-vl's M-RoPE positions over a process mesh: the whole
    sequence's [3, B, L] against a shard of L / 4 rows is refused, as is a
    shard of the wrong length."""
    cfg, params = _small("qwen2-vl-2b")
    ctx = _procs_ctx()
    embeds = torch.zeros((1, L // 2, cfg.d_model))
    whole = torch.zeros((3, 1, L), dtype=torch.int64)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="the shard's own"):
            lm_forward(params, cfg, ctx, inputs_embeds=embeds,
                       positions=whole, seq_len=L)
        with pytest.raises(ValueError, match="holds rows"):
            lm_forward(params, cfg, ctx, inputs_embeds=embeds, seq_len=2 * L)
        with pytest.raises(ValueError, match="needs seq_len"):
            lm_forward(params, cfg, ctx, inputs_embeds=embeds)


def test_process_caches_are_the_process_part():
    """init_lm_caches with a process mesh: this process's slice of the
    slots and its SP ranks' positions; hymba's SSD state whole over the
    slice's SP ranks."""
    cfg, _ = _small("hymba-1.5b")
    ctx = _procs_ctx()
    caches = get_model(cfg).init_caches(cfg, 4, 64, torch.float32, "cpu",
                                        mesh=ctx.mesh, sp=ctx.sp)
    assert caches["k"].shape[1:3] == (2, 32)
    assert caches["ssd_state"].shape[1] == 2
    assert ctx.mesh.held_rows(ctx.sp.sp_axes, 64) == (0, 32)
    assert ctx.mesh.held_batch(("data",), 4) == slice(2, 4)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _serve(*extra) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--eager", *extra], env=env,
        capture_output=True, text=True, timeout=300)


def test_launcher_serves_an_lm_over_processes():
    """``--procs 4`` on (model 4): the request tokens of ``--procs 1``."""
    args = ["--arch", "qwen2-1.5b", "--mesh", "host", "--model", "4"]
    one, four = _serve(*args), _serve(*args, "--procs", "4")
    assert one.returncode == 0, one.stderr[-2000:]
    assert four.returncode == 0, four.stderr[-2000:]
    lines = lambda p: [x for x in p.stdout.splitlines()
                       if x.startswith("request ")]
    assert len(lines(one)) == 4 and lines(four) == lines(one)
    assert "process mesh: 4 processes, 1 of 4 ranks each" in four.stdout


@pytest.mark.parametrize("arch, item", [("rwkv6-1.6b", "one rank")])
def test_launcher_refuses_over_processes(arch, item):
    p = _serve("--arch", arch, "--procs", "4", "--mesh", "host",
               "--model", "4")
    assert p.returncode != 0 and item in p.stderr
