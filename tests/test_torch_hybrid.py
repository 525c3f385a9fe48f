"""The port's cogvideox-5b DiT and its hybrid path — CFG and data mesh
axes, the displaced patch pipeline, the hybrid server — against the
reference, on the CPU.

The model is ``get_reduced("cogvideox-5b")`` in float32 with head_dim 16,
so that the attention width (64) is half of d_model (128), as in the full
config (1536 of 3072); every weight is perturbed (a fresh DiT is the
identity) and two distinct timesteps go in.  Weights, noise and inputs
cross over as numpy arrays.  Tolerances are the reference's own: 1e-5 for
single-rank parity (the DiT tests'), 2e-4 for the hybrid mesh against one
device (tests/multidevice/test_hybrid.py), 0.05 · max|ref| for displaced
against unpipelined (tests/test_pipefusion.py).  The reference runs on its
one-device mesh in this process: its stage hand-off preserves values, so
its mesh result is its single-device result.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.core import PipelineConfig as JPipe
from repro.core import SPConfig as JSP
from repro.core import pipefusion as j_pf
from repro.models import ParallelContext as JCtx
from repro.models.dit import dit_forward as j_dit_forward
from repro.models.dit import dit_forward_displaced as j_displaced
from repro.models.dit import init_dit as j_init_dit
from repro.serving import sched as j_sched
from repro.serving.sampler import SamplerConfig as JSampler
from repro.serving.sampler import hybrid_sample_step as j_hybrid_step
from repro.serving.sampler import sample as j_sample
from repro_torch.comm import trace as t_trace
from repro_torch.configs import get_reduced
from repro_torch.core import PipelineConfig, SPConfig
from repro_torch.core import pipefusion as t_pf
from repro_torch.launch import make_hybrid_mesh, make_mesh
from repro_torch.models import ParallelContext, dit_forward, load_jax_params
from repro_torch.models.dit import COND_TOKENS, dit_forward_displaced
from repro_torch.serving import (DiTRequest, DiTServer, SamplerConfig,
                                 sample, sample_step)
from repro_torch.serving import sched as t_sched
from repro_torch.serving.sampler import hybrid_sample_step

CPU = torch.device("cpu")
DIT_TOL = 1e-5
HYBRID_TOL = 2e-4
DISPLACED_SHARE = 0.05
SEQ = 64  # latent tokens of the sampling cases
BACKENDS = ["xla", "pallas"]
T = torch.from_numpy


def _models(head_dim):
    """(cfg, reference cfg, reference params, port params): reduced
    cogvideox-5b in float32 at ``head_dim``, every weight perturbed."""
    cfg, jcfg = (dataclasses.replace(get("cogvideox-5b"), dtype="float32",
                                     head_dim=head_dim)
                 for get in (get_reduced, j_get_reduced))
    params, _ = j_init_dit(jcfg, jax.random.PRNGKey(0))
    leaves, treedef = jax.tree.flatten(jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(99)
    leaves = [(l + 0.05 * rng.standard_normal(l.shape)).astype(np.float32)
              for l in leaves]
    tree = jax.tree.unflatten(treedef, leaves)
    return (cfg, jcfg, jax.tree.map(jnp.asarray, tree),
            load_jax_params(tree, cfg, device="cpu"))


@pytest.fixture(scope="module")
def model():
    return _models(16)


@pytest.fixture(scope="module")
def cond(model):
    cfg = model[0]
    return np.random.default_rng(1).standard_normal(
        (1, COND_TOKENS, cfg.d_model)).astype(np.float32)


def _jctx(mesh1):
    return JCtx(mesh1, JSP(strategy="full", sp_axes=("model",),
                           batch_axes=("data",)), "prefill")


def _tctx():
    return ParallelContext(SPConfig(strategy="full"), device=CPU)


def _inputs(cfg, seed, batch=2, seq=16):
    rng = np.random.default_rng(seed)
    return dict(
        latents=rng.standard_normal((batch, seq, 64)).astype(np.float32),
        cond=rng.standard_normal((batch, COND_TOKENS, cfg.d_model)
                                 ).astype(np.float32),
        timesteps=np.array([0.3, 0.8][:batch], np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# cogvideox-5b at degree 1 and under swift_torus
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head_dim", [32, 16], ids=["width=d", "width=d/2"])
@pytest.mark.parametrize("where", ["degree1", "swift_torus"])
def test_cogvideox_dit_forward_matches_reference(where, head_dim, mesh1):
    cfg, jcfg, jparams, tparams = _models(head_dim)
    assert cfg.n_heads * cfg.resolved_head_dim == cfg.d_model * head_dim // 32
    inp = _inputs(cfg, 1)
    want = np.asarray(j_dit_forward(jparams, jcfg, _jctx(mesh1), **{
        k: jnp.asarray(x) for k, x in inp.items()}))
    assert float(np.abs(want).max()) > 1e-2  # not vacuous
    if where == "degree1":
        ctx = _tctx()
    else:
        ctx = ParallelContext(
            SPConfig(strategy="swift_torus", sp_axes=("pod", "model"),
                     comm_backend="pallas", kernel_interpret=False),
            mesh=make_mesh((2, 2), ("pod", "model"), device="cpu"))
        assert ctx.sp_degree == 4
    got = dit_forward(tparams, cfg, ctx, **{k: T(x) for k, x in inp.items()})
    _close(got, want, DIT_TOL)


# ---------------------------------------------------------------------------
# core/pipefusion.py, function by function
# ---------------------------------------------------------------------------

def test_partitions_equal_reference():
    for args in ((256, 64, 1), (256, 64, 2), (256, 64, 4), (7, 12, 3)):
        assert t_pf.patch_slices(*args) == j_pf.patch_slices(*args)
    for args in ((2, 1), (2, 2), (42, 2), (42, 6)):
        assert t_pf.stage_layers(*args) == j_pf.stage_layers(*args)
    with pytest.raises(AssertionError):
        t_pf.patch_slices(256, 64, 3)
    with pytest.raises(AssertionError):
        t_pf.stage_layers(42, 4)


def _state(seed, shape=(2, 2, 40, 3, 8)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("start,length", [(0, 16), (16, 8), (32, 8)])
def test_drop_and_update_rows_equal_reference(start, length):
    k, v = _state(2)
    for x, axis in ((k, 2), (k[0], 1)):  # the state, one layer of it
        _close(t_pf.drop_rows(T(x), start, length, axis),
               j_pf.drop_rows(jnp.asarray(x), start, length, axis), 0)
    kn, vn = (x[:, :, :length] * 3.0 for x in _state(3))
    want = j_pf.update_state_rows(j_pf.KVState(jnp.asarray(k), jnp.asarray(v)),
                                  jnp.asarray(kn), jnp.asarray(vn), start)
    state = t_pf.KVState(T(k.copy()), T(v.copy()))
    got = t_pf.update_state_rows(state, T(kn), T(vn), start)
    assert got.k is state.k  # written in place
    _close(got.k, want.k, 0)
    _close(got.v, want.v, 0)
    # one layer at a time, as dit_forward_displaced writes it
    state = t_pf.KVState(T(k.copy()), T(v.copy()))
    for l in range(2):
        t_pf.update_state_rows(state, T(kn[l:l + 1]), T(vn[l:l + 1]), start,
                               first_layer=l)
    _close(state.k, want.k, 0)


@pytest.mark.parametrize("lr", [0, 24])
def test_displaced_attention_equals_reference(lr):
    rng = np.random.default_rng(4)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, kf, vf = mk(2, 16, 4, 8), mk(2, 16, 2, 8), mk(2, 16, 2, 8)
    ks, vs = mk(2, lr, 2, 8), mk(2, lr, 2, 8)
    want = j_pf.displaced_attention(*(jnp.asarray(x)
                                      for x in (q, kf, vf, ks, vs)))
    got = t_pf.displaced_attention(*(T(x) for x in (q, kf, vf, ks, vs)))
    _close(got, want, DIT_TOL)


@pytest.mark.parametrize("per_item", [False, True])
def test_kv_drift_equals_reference(per_item):
    k, v = _state(5)
    k2, v2 = (x + 0.1 * y for x, y in zip((k, v), _state(6)))
    k2[:, 1] += 1.0  # one batch item drifts far more
    jo, jn = (j_pf.KVState(jnp.asarray(a), jnp.asarray(b))
              for a, b in ((k, v), (k2, v2)))
    to, tn = (t_pf.KVState(T(a), T(b)) for a, b in ((k, v), (k2, v2)))
    _close(t_pf.kv_drift(to, tn, per_item=per_item),
           j_pf.kv_drift(jo, jn, per_item=per_item), DIT_TOL)
    zero = t_pf.KVState(torch.zeros_like(to.k), torch.zeros_like(to.v))
    assert torch.isfinite(t_pf.kv_drift(zero, zero, per_item=per_item)).all()
    z = t_pf.init_kv_state(2, 3, 40, 3, 8, torch.float32, CPU)
    j = j_pf.init_kv_state(2, 3, 40, 3, 8, jnp.float32)
    assert z.k.shape == j.k.shape and not z.k.any() and not z.v.any()


# ---------------------------------------------------------------------------
# the displaced forward and the hybrid step
# ---------------------------------------------------------------------------

def _warm_state(model, mesh1, inp):
    """The reference's warm KV state at another timestep, perturbed: stale
    rows that differ from the fresh ones."""
    cfg, jcfg, jparams, _ = model
    _, st = j_dit_forward(jparams, jcfg, _jctx(mesh1), return_layer_kv=True,
                          **{k: jnp.asarray(x) for k, x in
                             dict(inp, timesteps=inp["timesteps"] * 0.5
                                  ).items()})
    rng = np.random.default_rng(7)
    return tuple((np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
                  ).astype(np.float32) for a in st)


def test_dit_forward_return_layer_kv_matches_reference(model, mesh1):
    cfg, jcfg, jparams, tparams = model
    inp = _inputs(cfg, 8)
    jv, jst = j_dit_forward(jparams, jcfg, _jctx(mesh1), return_layer_kv=True,
                            **{k: jnp.asarray(x) for k, x in inp.items()})
    buf = t_pf.init_kv_state(cfg.n_layers, 2, COND_TOKENS + 16,
                             cfg.n_kv_heads, cfg.resolved_head_dim,
                             torch.float32, CPU)
    tv, tst = dit_forward(tparams, cfg, _tctx(), return_layer_kv=True,
                          kv_out=buf, **{k: T(x) for k, x in inp.items()})
    assert tst.k is buf.k
    _close(tv, jv, DIT_TOL)
    _close(tst.k, jst.k, DIT_TOL)
    _close(tst.v, jst.v, DIT_TOL)
    # the x-path is the plain forward's
    plain = dit_forward(tparams, cfg, _tctx(), **{k: T(x) for k, x in
                                                  inp.items()})
    assert torch.equal(plain, tv)


@pytest.mark.parametrize("pp,patches", [(1, 2), (1, 4), (2, 2), (2, 4)])
def test_dit_forward_displaced_matches_reference(model, mesh1, pp, patches):
    cfg, jcfg, jparams, tparams = model
    inp = _inputs(cfg, 9)
    k, v = _warm_state(model, mesh1, inp)
    jv, jst = j_displaced(jparams, jcfg, _jctx(mesh1),
                          kv_state=j_pf.KVState(jnp.asarray(k), jnp.asarray(v)),
                          num_patches=patches, pp=pp,
                          **{n: jnp.asarray(x) for n, x in inp.items()})
    old = t_pf.KVState(T(k.copy()), T(v.copy()))
    tv, tst = dit_forward_displaced(tparams, cfg, _tctx(), kv_state=old,
                                    num_patches=patches, pp=pp,
                                    **{n: T(x) for n, x in inp.items()})
    _close(tv, jv, DIT_TOL)
    _close(tst.k, jst.k, DIT_TOL)
    _close(tst.v, jst.v, DIT_TOL)
    assert np.array_equal(old.k.numpy(), k)  # the stale state is only read
    assert float(np.abs(np.asarray(jst.k) - k).max()) > 1e-2


@pytest.mark.parametrize("sc_kw", [
    dict(), dict(guidance_scale=3.0, cfg_parallel=True)],
    ids=["unguided", "cfg_parallel"])
@pytest.mark.parametrize("warm", [True, False])
def test_hybrid_sample_step_matches_reference(model, mesh1, warm, sc_kw):
    cfg, jcfg, jparams, tparams = model
    rng = np.random.default_rng(10)
    x = rng.standard_normal((1, 16, 64)).astype(np.float32)
    c = rng.standard_normal((1, COND_TOKENS, cfg.d_model)).astype(np.float32)
    pipe = dict(pp=2, warmup_steps=1)
    branches = 2 if sc_kw else 1
    k, v = _state(11, (cfg.n_layers, branches, COND_TOKENS + 16,
                       cfg.n_kv_heads, cfg.resolved_head_dim))
    jx, jst, jm = j_hybrid_step(
        jparams, jcfg, _jctx(mesh1), jnp.asarray(x), jnp.asarray(c),
        jnp.float32(0.75), 0.25,
        JSampler(num_steps=4, pipeline=JPipe(**pipe), **sc_kw),
        j_pf.KVState(jnp.asarray(k), jnp.asarray(v)), warm=warm)
    state = t_pf.KVState(T(k), T(v))
    out = t_pf.KVState(torch.empty_like(state.k), torch.empty_like(state.v))
    tx, tst, tm = hybrid_sample_step(
        tparams, cfg, _tctx(), T(x), T(c), 0.75, 0.25,
        SamplerConfig(num_steps=4, pipeline=PipelineConfig(**pipe), **sc_kw),
        state, warm=warm, out=out)
    assert tst.k is out.k
    _close(tx, jx, DIT_TOL)
    _close(tst.k, jst.k, DIT_TOL)
    for name in ("kv_drift", "kv_drift_per_request"):
        _close(tm[name], jm[name], DIT_TOL)
    assert (float(tm["kv_drift"]) == 0.0) == warm


def _bf16(tree):
    if isinstance(tree, dict):
        return {k: _bf16(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_bf16(v) for v in tree]
    return tree.bfloat16()


def test_cfg_forms_agree_in_bfloat16(model):
    """Stacked and sequential CFG are the same sum, 4 v_c - 3 v_u and
    v_u + 4 (v_c - v_u), and recombine in float32: in bfloat16 the weights
    cancel, and one step of the two forms differed here by 8e-3 of what
    the step moved the latents."""
    cfg, _, _, tparams = model
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    params = _bf16(tparams)
    rng = np.random.default_rng(12)
    x = T(rng.standard_normal((1, SEQ, 64)).astype(np.float32)).bfloat16()
    c = T(rng.standard_normal((1, COND_TOKENS, cfg.d_model)).astype(
        np.float32)).bfloat16()
    seq, par = (sample_step(params, cfg, _tctx(), x, c, 0.75, 0.25,
                            SamplerConfig(num_steps=4, guidance_scale=4.0,
                                          **kw)).float()
                for kw in ({}, {"cfg_parallel": True}))
    moved = float((seq - x.float()).norm())
    assert float((par - seq).norm()) <= 1e-3 * moved


@pytest.mark.parametrize("policy", [None, "drift"])
def test_pipelined_sample_matches_reference(model, mesh1, cond, policy):
    """The whole pipelined loop, with the static schedule (warmup 1,
    resync every 2) or a DriftPolicy whose threshold some displaced steps
    cross: the same warm-step schedule and latents as the reference's."""
    cfg, jcfg, jparams, tparams = model
    pipe = dict(pp=2, warmup_steps=1, resync_every=0 if policy else 2)
    key = jax.random.PRNGKey(7)
    x0 = np.array(jax.random.normal(key, (1, SEQ, 64), jnp.float32))
    kw = {}
    if policy:
        kw = dict(drift_thresholds=[None])
    jm, tm = [], []
    want = j_sample(jparams, jcfg, _jctx(mesh1), key=key, batch=1,
                    seq_len=SEQ, cond=jnp.asarray(cond),
                    sc=JSampler(num_steps=5, pipeline=JPipe(**pipe)),
                    metrics=jm, drift_policy=(j_sched.DriftPolicy(0.02)
                                              if policy else None), **kw)
    got = sample(tparams, cfg, _tctx(), noise=T(x0), batch=1, seq_len=SEQ,
                 cond=T(cond), sc=SamplerConfig(num_steps=5,
                                                pipeline=PipelineConfig(**pipe)),
                 metrics=tm, drift_policy=(t_sched.DriftPolicy(0.02)
                                           if policy else None), **kw)
    schedule = [m["warm"] for m in jm]
    assert [m["warm"] for m in tm] == schedule
    assert schedule.count(True) >= 2 and schedule.count(False) >= 2
    _close([m["kv_drift"] for m in tm], [m["kv_drift"] for m in jm], DIT_TOL)
    _close(got, want, DIT_TOL)


# ---------------------------------------------------------------------------
# the hybrid mesh (cfg, pipe, data, model) of virtual ranks
# ---------------------------------------------------------------------------

def _hybrid_sp(backend):
    return SPConfig(strategy="swift_torus", sp_axes=("model",),
                    batch_axes=("data",), cfg_axis="cfg", pp_axis="pipe",
                    comm_backend=backend, kernel_interpret=False)


_REF = {}  # (sampler config, cond shape) -> the reference's (noise, latents)


def _ref_sample(model, mesh1, cond, sc):
    """The reference's ``sample`` on its one-device mesh (each config once
    per module: both backends compare with the same run)."""
    memo = (sc, cond.shape)
    if memo not in _REF:
        cfg, jcfg, jparams, _ = model
        key = jax.random.PRNGKey(7)
        x0 = np.array(jax.random.normal(key, (1, SEQ, 64), jnp.float32))
        out = j_sample(jparams, jcfg, _jctx(mesh1), key=key, batch=1,
                       seq_len=SEQ, cond=jnp.asarray(cond), sc=sc)
        _REF[memo] = (x0, np.asarray(out))
    return _REF[memo]


def _mesh_sample(model, mesh, sp, x0, cond, sc, **kw):
    cfg, _, _, tparams = model
    ctx = ParallelContext(sp, mesh=mesh)
    return sample(tparams, cfg, ctx, noise=T(x0), batch=1, seq_len=SEQ,
                  cond=T(cond), sc=sc, **kw).numpy()


@pytest.mark.parametrize("backend", BACKENDS)
def test_hybrid_all_warm_matches_sequential_cfg(model, mesh1, cond, backend):
    """cfg-parallel + swift_torus + pipeline on (cfg 2, pipe 2, data 1,
    model 2), every step warm == plain sequential CFG on one device."""
    x0, want = _ref_sample(model, mesh1, cond,
                           JSampler(num_steps=3, guidance_scale=4.0))
    got = _mesh_sample(
        model, make_hybrid_mesh(2, 2, 1, 2, device="cpu"), _hybrid_sp(backend),
        x0, cond, SamplerConfig(num_steps=3, guidance_scale=4.0,
                                cfg_parallel=True,
                                pipeline=PipelineConfig(pp=2, warmup_steps=3)))
    _close(got, want, HYBRID_TOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_hybrid_displaced_matches_reference(model, mesh1, cond, backend):
    """Displaced steps on the hybrid mesh, with one hand-off put over the
    pipe axis per (patch, stage boundary), == the reference's displaced
    sample on one device at the same pp and patches; and within the
    reference's bound of the unpipelined sample, yet not equal to it."""
    jsc = JSampler(num_steps=4, guidance_scale=4.0, cfg_parallel=True,
                   pipeline=JPipe(pp=2, num_patches=4, warmup_steps=1))
    x0, want = _ref_sample(model, mesh1, cond, jsc)
    _, plain = _ref_sample(model, mesh1, cond,
                           JSampler(num_steps=4, guidance_scale=4.0))
    sc = SamplerConfig(num_steps=4, guidance_scale=4.0, cfg_parallel=True,
                       pipeline=PipelineConfig(pp=2, num_patches=4,
                                               warmup_steps=1))
    with t_trace.record("hybrid") as tr:
        got = _mesh_sample(model, make_hybrid_mesh(2, 2, 1, 2, device="cpu"),
                           _hybrid_sp(backend), x0, cond, sc)
    _close(got, want, HYBRID_TOL)
    assert np.isfinite(got).all()
    diff = float(np.abs(got - plain).max())
    assert 0.0 < diff < DISPLACED_SHARE * float(np.abs(plain).max())
    handoffs = [e for e in tr.events if e.stream == "pipe"]
    assert len(handoffs) == 3 * 4 * (2 - 1)  # displaced steps x patches x (pp-1)
    assert all(e.axes == ("pipe",) and e.backend == backend
               for e in handoffs)
    # one batch slice per cfg branch, both pipe ranks: [1, patch rows, d]
    assert {e.shape for e in handoffs} == {(1, COND_TOKENS + SEQ // 4, 128),
                                           (1, SEQ // 4, 128)}


@pytest.mark.parametrize("backend", BACKENDS)
def test_unguided_sampling_on_cfg_axis_mesh(model, mesh1, cond, backend):
    """With a cfg axis but no guidance, the un-doubled batch is not split
    over the cfg axis (``_ctx_for``)."""
    x0, want = _ref_sample(model, mesh1, cond, JSampler(num_steps=2))
    got = _mesh_sample(model, make_hybrid_mesh(2, 1, 1, 2, device="cpu"),
                       _hybrid_sp(backend), x0, cond,
                       SamplerConfig(num_steps=2))
    _close(got, want, HYBRID_TOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_cfg_degree_4_on_4way_cfg_axis(model, mesh1, cond, backend):
    """4 branches (3 conditionings + uncond) split over a 4-way cfg axis
    == the same weighted sum computed sequentially on one device."""
    weights = (2.0, 1.0, 0.5, -2.5)
    conds = np.concatenate([cond, 2.0 * cond, -1.0 * cond,
                            np.zeros_like(cond)]).reshape(
                                4, 1, COND_TOKENS, cond.shape[-1])
    x0, want = _ref_sample(model, mesh1, conds,
                           JSampler(num_steps=2, cfg_weights=weights))
    got = _mesh_sample(model, make_hybrid_mesh(4, 1, 1, 2, device="cpu"),
                       _hybrid_sp(backend), x0, conds,
                       SamplerConfig(num_steps=2, cfg_weights=weights,
                                     cfg_parallel=True))
    _close(got, want, HYBRID_TOL)


# ---------------------------------------------------------------------------
# DiTServer on the hybrid mesh
# ---------------------------------------------------------------------------

def test_dit_server_hybrid_end_to_end(model):
    cfg, _, _, tparams = model
    mesh = make_hybrid_mesh(2, 2, 1, 2, device="cpu")
    srv = DiTServer(tparams, cfg, _hybrid_sp("pallas"), mesh=mesh,
                    sampler=SamplerConfig(
                        num_steps=3, guidance_scale=3.0, cfg_parallel=True,
                        pipeline=PipelineConfig(pp=2, warmup_steps=1)),
                    max_batch=2)
    # stages are contiguous slices of the layer list: the same tensors
    assert [len(s) for s in srv.stages] == [1, 1]
    for s, stage in enumerate(srv.stages):
        assert stage[0] is tparams["layers"][s]
        w = stage[0]["attn"]["wq"]["w"]
        assert w.data_ptr() == tparams["layers"][s]["attn"]["wq"]["w"].data_ptr()
    for i in range(2):
        srv.submit(DiTRequest(rid=i, seq_len=SEQ))
    results = srv.serve()
    assert sorted(r.rid for r in results) == [0, 1]
    for r in results:
        assert r.latents.shape == (SEQ, 64)
        assert bool(torch.isfinite(r.latents).all())
        assert len(r.kv_drift) == 3 and r.kv_drift[0] == 0.0
        assert all(0.0 < d < float("inf") for d in r.kv_drift[1:])
        assert r.resyncs == 0
    assert srv.tracker.counter_total("engine.resyncs") == 0
    # the engine logs the batch's mean drift per step
    (_, stats), = srv.tracker.series_items("engine.kv_drift")
    assert stats.n == 3


def test_dit_server_drift_policy_resyncs(model):
    """A request whose drift bound every displaced step crosses gets a
    resync step after each: the counter and the result say so."""
    cfg, _, _, tparams = model
    srv = DiTServer(tparams, cfg, SPConfig(strategy="full"), device="cpu",
                    sampler=SamplerConfig(
                        num_steps=5, pipeline=PipelineConfig(
                            pp=2, num_patches=2, warmup_steps=1)),
                    drift=t_sched.DriftPolicy(), max_batch=1)
    srv.submit(DiTRequest(rid=0, seq_len=SEQ, drift_threshold=1e-9))
    (r,) = srv.serve()
    # warm, displaced (crosses), resync, displaced (crosses), resync
    assert [d == 0.0 for d in r.kv_drift] == [True, False, True, False, True]
    assert r.resyncs == 2
    assert srv.tracker.counter_total("engine.resyncs") == 2


def test_dp_padding_leaves_requests_bitwise_equal(model):
    """On a data axis of 2, a request served alone (its batch padded with
    a row of pad noise) gives latents bitwise equal to the same request
    batched with another one: pad rows are dropped, and no row reads
    another."""
    cfg, _, _, tparams = model
    mesh = make_hybrid_mesh(1, 1, 2, 2, device="cpu")
    sp = _hybrid_sp("pallas")

    def serve(rids):
        srv = DiTServer(tparams, cfg, sp, mesh=mesh,
                        sampler=SamplerConfig(num_steps=2), max_batch=2)
        assert srv._dp_degree() == 2
        for rid in rids:
            srv.submit(DiTRequest(rid=rid, seq_len=SEQ))
        out = {r.rid: r.latents for r in srv.serve()}
        assert srv.scheduler.admissions == 1
        return out

    both = serve([0, 1])
    for rid in (0, 1):
        alone = serve([rid])
        assert list(alone) == [rid]
        assert torch.equal(alone[rid], both[rid])
    assert not torch.equal(both[0], both[1])


def test_hybrid_mesh_needs_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_hybrid_mesh(2, 2, 1, 2)
    mesh = make_hybrid_mesh(2, 2, 1, 2, device="cpu")
    assert mesh.shape == {"cfg": 2, "pipe": 2, "data": 1, "model": 2}
    assert mesh.device.type == "cpu"


def test_server_keeps_raising_for_unported_options(model):
    """The span profiler and the hierarchical all-to-all are ported
    (tests/test_torch_profiler.py, tests/test_torch_hier.py); the
    pipelined sampler without CFG parallelism still raises."""
    cfg, _, _, tparams = model
    DiTServer(tparams, cfg, SPConfig(strategy="full"), device="cpu",
              profile=True)
    SPConfig(strategy="swift_torus", hier_a2a=True)
    with pytest.raises(NotImplementedError, match="sequential CFG"):
        sample(tparams, cfg, _tctx(), generator=torch.Generator(), batch=1,
               seq_len=SEQ, cond=torch.zeros((1, COND_TOKENS, cfg.d_model)),
               sc=SamplerConfig(num_steps=2, guidance_scale=4.0,
                                pipeline=PipelineConfig(pp=2)))
