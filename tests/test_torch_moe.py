"""The port's MoE layer and MoE LMs (qwen2-moe-a2.7b: shared experts;
arctic-480b: a dense residual MLP) against the reference on the CPU, in
float32, on the reduced configs.

Inputs and parameters are made with numpy and handed to both packages;
the reference runs in process on its 1-device mesh.

* ``_positions_within_group``, ``_route`` (on integer-valued inputs, so
  that probabilities tie and the tie-break toward the lower expert shows)
  and ``padded_n_experts``: equal to the reference's;
* ``moe_block`` prefill at capacity 8.0 (nothing dropped) at EP 1, 2 and
  4 on virtual ranks (the expert dispatch through the staged all-to-all,
  over the put kernels' plain versions or plain copies) against a numpy
  copy of tests/test_moe.py's ``_dense_moe_reference`` (2e-4), and
  against the reference's ``moe_block`` at EP 1; the puts each EP degree
  issues;
* capacity 1.0 with identical tokens (drops): the reference's output at
  EP 1, finite on every EP degree;
* the replicated decode path against the reference (2e-4); the
  token-gather decode (arctic on (data 2, model 2)) against the port's
  replicated path (2e-4);
* the models' prefill against the reference (1e-5 of max|logits|, aux
  too) and their decode against their own forward (5e-5, the reference's
  tolerance in tests/test_decode_consistency.py, at its B 2 x L 16);
* ARServer against the reference's, and the capture rehearsal of
  tests/test_torch_graphs.py on the moe tick.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.core import SPConfig as JSP
from repro.models import ParallelContext as JCtx
from repro.models import get_model as j_get_model
from repro.models import lm as j_lm
from repro.models import moe as j_moe
from repro.serving import ARRequest as JARRequest
from repro.serving import ARServer as JARServer
from repro_torch.comm import trace as t_trace
from repro_torch.configs import MOE_ARCHS, get_reduced
from repro_torch.core import SPConfig
from repro_torch.launch import make_mesh
from repro_torch.models import (ParallelContext, get_model, init_lm,
                                lm_forward, load_jax_lm_params)
from repro_torch.models import moe as t_moe
from repro_torch.serving import ARRequest, ARServer
from test_torch_graphs import guard  # noqa: F401  (the capture rehearsal)

CPU = torch.device("cpu")
T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
J_SP = JSP(strategy="full", sp_axes=("model",), batch_axes=("data",))
SP1 = SPConfig(strategy="full")
MOE_TOL = 2e-4  # tests/test_moe.py
PREFILL_TOL = 1e-5  # of max|logits|
DECODE_TOL = 5e-5  # tests/test_decode_consistency.py, moe family
B, L = 2, 16  # tests/test_decode_consistency.py


def _cfgs(arch, **moe):
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32",
                              sharding_overrides=())
    jcfg = dataclasses.replace(j_get_reduced(arch), dtype="float32",
                               sharding_overrides=())
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
        jcfg = dataclasses.replace(jcfg,
                                   moe=dataclasses.replace(jcfg.moe, **moe))
    return cfg, jcfg


def _layer_moe(arch, ep, seed=0, **moe):
    """Layer 0's MoE weights of an EP-padded init, as numpy, and the
    configs."""
    cfg, jcfg = _cfgs(arch, **moe)
    params, _ = j_get_model(jcfg).init(jcfg, jax.random.PRNGKey(seed), ep)
    tree = jax.tree.map(lambda a: np.array(a[0]), params["layers"]["moe"])
    return cfg, jcfg, tree


def _torch_tree(tree):
    return jax.tree.map(T, tree)


def _dense_moe_reference(x2d, p, cfg):
    """tests/test_moe.py's all-experts-on-all-tokens reference, in numpy
    (float64): no capacity drops."""
    m = cfg.moe
    x = x2d.astype(np.float64)
    logits = x @ p["router"]["w"].astype(np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    ids = np.argsort(-probs, axis=-1, kind="stable")[:, :m.top_k]
    wts = np.take_along_axis(probs, ids, axis=-1)
    wts /= wts.sum(-1, keepdims=True)
    silu = lambda z: z / (1.0 + np.exp(-z))
    outs = np.stack([(silu(x @ p["wi_gate"][e]) * (x @ p["wi_up"][e]))
                     @ p["wo"][e] for e in range(m.n_experts)], 1)
    sel = np.take_along_axis(outs, ids[..., None], axis=1)
    return np.sum(sel * wts[..., None], axis=1)


def _ep_ctx(ep, mode="prefill", backend="pallas", **kw):
    sp = SPConfig(strategy="full", sp_axes=("model",), batch_axes=("data",),
                  comm_backend=backend, kernel_interpret=False)
    return ParallelContext(sp, mode, mesh=make_mesh((ep,), ("model",),
                                                    device="cpu"), **kw)


def _port_block(tree, x, cfg, ctx):
    with torch.inference_mode():
        y, aux = t_moe.moe_block(T(x), _torch_tree(tree), cfg, ctx)
    return y.numpy(), float(aux)


def _ref_block(tree, x, jcfg, mesh1, mode="prefill"):
    y, aux = jax.jit(lambda p, x: j_moe.moe_block(
        x, p, jcfg, JCtx(mesh1, J_SP, mode)))(
            jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    return np.asarray(y), float(aux)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_groups,t", [(3, 7), (5, 64), (17, 200)])
def test_positions_within_group_equal(n_groups, t):
    ids = np.random.default_rng(t).integers(0, n_groups, t).astype(np.int32)
    got = t_moe._positions_within_group(T(ids), n_groups).numpy()
    want = np.asarray(j_moe._positions_within_group(jnp.asarray(ids),
                                                    n_groups))
    np.testing.assert_array_equal(got, want)
    ids = np.array([2, 0, 2, 1, 0, 2, 2])
    np.testing.assert_array_equal(
        t_moe._positions_within_group(T(ids), 3).numpy(), [0, 0, 1, 0, 1, 2, 3])


@pytest.mark.parametrize("top_k,n_experts", [(2, 6), (4, 60)])
def test_route_equal_on_integer_inputs(top_k, n_experts):
    """Integer-valued tokens and router weights in {-1, 0, 1} make many
    tokens' probabilities tie exactly: both packages pick the lower
    expert, with the same weights and aux loss."""
    rng = np.random.default_rng(top_k)
    x = rng.integers(-2, 3, (96, 8)).astype(np.float32)
    w = rng.integers(-1, 2, (8, n_experts)).astype(np.float32)
    ids, wts, aux = t_moe._route(T(x), T(w), top_k, n_experts)
    jids, jwts, jaux = j_moe._route(jnp.asarray(x), jnp.asarray(w), top_k,
                                    n_experts)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x @ w), -1))
    assert (np.sort(probs, -1)[:, -top_k:-1] == np.sort(probs, -1)[
        :, -top_k + 1:]).any(), "no tie among the top-k: the check is vacuous"
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(wts.numpy(), np.asarray(jwts), rtol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("n_experts,ep", [(60, 16), (60, 1), (60, 8),
                                          (4, 3), (128, 16)])
def test_padded_n_experts_equal(n_experts, ep):
    cfg, jcfg = _cfgs("qwen2-moe-a2.7b", n_experts=n_experts)
    assert t_moe.padded_n_experts(cfg, ep) == j_moe.padded_n_experts(jcfg, ep)


# ---------------------------------------------------------------------------
# moe_block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ep,backend", [(1, "xla"), (2, "pallas"),
                                        (4, "pallas"), (4, "xla")])
def test_moe_block_matches_dense_reference(mesh1, ep, backend):
    """Capacity 8.0: the sort-based dispatch, exchanged over ``ep`` virtual
    ranks, computes the dense function (measured max|d| ~1e-6); the
    reference's moe_block at EP 1 agrees.  Under the pallas backend every
    exchange is ep - 1 puts over 'model', each covering every rank (one K3
    launch on the card): three exchanges per block."""
    cfg, jcfg, tree = _layer_moe("qwen2-moe-a2.7b", ep, capacity_factor=8.0,
                                 n_shared_experts=0)
    x = np.random.default_rng(ep).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    with t_trace.record("moe") as tr:
        y, aux = _port_block(tree, x, cfg, _ep_ctx(ep, backend=backend))
    want = _dense_moe_reference(x.reshape(-1, cfg.d_model), tree, cfg)
    np.testing.assert_allclose(y.reshape(-1, cfg.d_model), want,
                               rtol=MOE_TOL, atol=MOE_TOL)
    puts = [e for e in tr.events if e.axes == ("model",)]
    assert len(puts) == (3 * (ep - 1) if backend == "pallas" else 0)
    assert all(e.backend == "pallas" and len(e.perm) == ep for e in puts)
    if ep == 1:
        ry, raux = _ref_block(tree, x, jcfg, mesh1)
        np.testing.assert_allclose(y, ry, rtol=MOE_TOL, atol=MOE_TOL)
        np.testing.assert_allclose(aux, raux, rtol=1e-6)


def test_capacity_drops_match_reference(mesh1):
    """Capacity 1.0 with every token identical: each token's top-2 experts
    are the same, so most slots are dropped.  The port drops the same
    slots as the reference at EP 1; every EP degree stays finite."""
    cfg, jcfg, tree = _layer_moe("qwen2-moe-a2.7b", 4, capacity_factor=1.0,
                                 n_shared_experts=0)
    x = np.broadcast_to(np.random.default_rng(0).standard_normal(
        (1, 1, cfg.d_model)), (2, 16, cfg.d_model)).astype(np.float32)
    y1, _ = _port_block(tree, x, cfg, _ep_ctx(1, backend="xla"))
    ry, _ = _ref_block(tree, x, jcfg, mesh1)
    np.testing.assert_allclose(y1, ry, rtol=MOE_TOL, atol=MOE_TOL)
    full = _dense_moe_reference(x.reshape(-1, cfg.d_model), tree, cfg)
    assert np.abs(y1.reshape(-1, cfg.d_model) - full).max() > 0.1 * np.abs(
        full).max(), "nothing was dropped: the check is vacuous"
    for ep in (2, 4):
        y, _ = _port_block(tree, x, cfg, _ep_ctx(ep))
        assert np.isfinite(y).all()


def test_moe_decode_replicated_path_matches(mesh1):
    """Decode at EP 1 against the reference and the dense function, and on
    (model 4) of virtual ranks (every rank's experts on every token, summed
    in rank order) against EP 1."""
    cfg, jcfg, tree = _layer_moe("qwen2-moe-a2.7b", 4, capacity_factor=8.0,
                                 n_shared_experts=0)
    x = np.random.default_rng(9).standard_normal(
        (4, 1, cfg.d_model)).astype(np.float32)
    y, _ = _port_block(tree, x, cfg, ParallelContext(SP1, "decode", CPU))
    ry, _ = _ref_block(tree, x, jcfg, mesh1, "decode")
    np.testing.assert_allclose(y, ry, rtol=MOE_TOL, atol=MOE_TOL)
    np.testing.assert_allclose(
        y.reshape(-1, cfg.d_model),
        _dense_moe_reference(x.reshape(-1, cfg.d_model), tree, cfg),
        rtol=MOE_TOL, atol=MOE_TOL)
    y4, _ = _port_block(tree, x, cfg, _ep_ctx(4, "decode"))
    np.testing.assert_allclose(y4, y, rtol=MOE_TOL, atol=MOE_TOL)


def test_token_gather_decode_matches_replicated_path():
    """arctic (reduced) on (data 2, model 2): with ep_token_gather the
    expert hidden dims split over data (the serve rule ``expert_mlp ->
    data``) and the partials of every (EP rank, hidden slice) summed equal
    the replicated path's output."""
    cfg, _, tree = _layer_moe("arctic-480b", 2)
    x = np.random.default_rng(4).standard_normal(
        (4, 1, cfg.d_model)).astype(np.float32)
    sp = SPConfig(strategy="full", sp_axes=("model",), batch_axes=("data",))
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    gather = ParallelContext(sp, "decode", mesh=mesh, ep_token_gather=True)
    replicated = ParallelContext(sp, "decode", mesh=mesh)
    y, aux = _port_block(tree, x, cfg, gather)
    ry, raux = _port_block(tree, x, cfg, replicated)
    np.testing.assert_allclose(y, ry, rtol=MOE_TOL, atol=MOE_TOL)
    assert np.isfinite(aux) and np.isfinite(raux)


def test_moe_block_refuses_unpadded_experts():
    cfg, _, tree = _layer_moe("qwen2-moe-a2.7b", 1, n_experts=3)
    with pytest.raises(ValueError, match="padded_n_experts"):
        _port_block(tree, np.zeros((1, 4, cfg.d_model), np.float32), cfg,
                    _ep_ctx(2))


def test_ep_axis_must_be_the_meshs_last_axis():
    """An EP group is 'model''s consecutive ranks of the rank list: a mesh
    with 'model' before another axis is refused, not mis-grouped."""
    cfg, _, tree = _layer_moe("qwen2-moe-a2.7b", 2)
    sp = SPConfig(strategy="full", sp_axes=("model", "pod"))
    ctx = ParallelContext(sp, "prefill", mesh=make_mesh(
        (2, 2), ("model", "pod"), device="cpu"))
    with pytest.raises(ValueError, match="last axis"):
        _port_block(tree, np.zeros((1, 4, cfg.d_model), np.float32), cfg, ctx)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

class _Models:
    def __init__(self, mesh1):
        self.mesh1 = mesh1
        self._cache = {}

    def __getitem__(self, arch):
        if arch not in self._cache:
            cfg, jcfg = _cfgs(arch)
            jb = j_get_model(jcfg)
            params, _ = jb.init(jcfg, jax.random.PRNGKey(0), 1)
            tree = jax.tree.map(np.array, params)
            rng = np.random.default_rng(sum(map(ord, arch)))
            for name in ("ln_attn", "ln_mlp"):  # norm scales start at one
                leaf = tree["layers"][name]["scale"]
                leaf += (rng.standard_normal(leaf.shape) * 0.1).astype(
                    np.float32)
            self._cache[arch] = dict(
                cfg=cfg, jcfg=jcfg, jb=jb, tree=tree,
                jparams=jax.tree.map(jnp.asarray, tree),
                tparams=load_jax_lm_params(tree, cfg, device="cpu"),
                tokens=rng.integers(0, cfg.vocab, (B, L)).astype(np.int32),
                mesh1=self.mesh1)
        return self._cache[arch]


@pytest.fixture(scope="module")
def models(mesh1):
    return _Models(mesh1)


def test_moe_archs_registered():
    assert MOE_ARCHS == ("qwen2-moe-a2.7b", "arctic-480b")


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("ep", [1, 3])
def test_init_mirrors_reference_structure(arch, ep):
    """init_lm's shapes are the reference's, the experts padded for an EP
    axis of ``ep`` (shared_mlp of d_ff moe_d_ff x shared experts,
    dense_mlp of d_ff)."""
    cfg, jcfg = _cfgs(arch)
    mine = init_lm(cfg, torch.Generator().manual_seed(0), "cpu",
                   ep_degree=ep)
    ref, _ = j_get_model(jcfg).init(jcfg, jax.random.PRNGKey(0), ep)
    ref = jax.tree.map(lambda a: tuple(a.shape), ref)
    layer_shapes = jax.tree.map(lambda s: s[1:], ref.pop("layers"),
                                is_leaf=lambda x: isinstance(x, tuple))
    assert jax.tree.map(lambda t: tuple(t.shape), {
        k: v for k, v in mine.items() if k != "layers"}) == ref
    for lp in mine["layers"]:
        assert jax.tree.map(lambda t: tuple(t.shape), lp) == layer_shapes


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_logits_and_aux_match_reference(models, arch):
    """lm_forward's logits (measured at most 1.6e-06 of max|logits|) and
    its aux loss, the layers' load-balance losses times router_aux_coef."""
    m = models[arch]
    with torch.inference_mode():
        logits, aux, _ = lm_forward(m["tparams"], m["cfg"],
                                    ParallelContext(SP1, "prefill", CPU),
                                    tokens=T(m["tokens"]))
    jlogits, jaux, _ = jax.jit(lambda p, t: j_lm.lm_forward(
        p, m["jcfg"], JCtx(m["mesh1"], J_SP, "prefill"), tokens=t))(
            m["jparams"], jnp.asarray(m["tokens"]))
    want = np.asarray(jlogits)
    assert float(np.abs(logits.numpy() - want).max()) <= PREFILL_TOL * float(
        np.abs(want).max())
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert float(aux) > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_matches_own_forward(models, arch):
    m = models[arch]
    cfg = m["cfg"]
    bundle = get_model(cfg)
    ctx = ParallelContext(SP1, "decode", CPU)
    caches = bundle.init_caches(cfg, B, L, torch.float32, "cpu")
    outs = []
    with torch.inference_mode():
        for t in range(L):
            logit, caches = bundle.step(
                m["tparams"], {"tokens": T(m["tokens"][:, t:t + 1])}, caches,
                t, cfg, ctx)
            outs.append(logit)
        full = bundle.apply(m["tparams"], {"tokens": T(m["tokens"])}, cfg,
                            ParallelContext(SP1, "prefill", CPU))
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=DECODE_TOL, atol=DECODE_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_ep_prefill_matches_degree_1(models, arch):
    """The whole model on (pod 2, data 2, model 2) of virtual ranks at
    capacity 8.0 (a shard's capacity depends on its token count, so only
    an undropped run is the same function on every mesh): attention
    through swift on (pod, model), the experts split over model and
    exchanged through the put kernels' plain versions."""
    m = models[arch]
    cfg = dataclasses.replace(m["cfg"], moe=dataclasses.replace(
        m["cfg"].moe, capacity_factor=8.0))
    params = load_jax_lm_params(m["tree"], cfg, device="cpu")
    sp = SPConfig(strategy="swift", sp_axes=("pod", "model"),
                  batch_axes=("data",), machine_axis="pod",
                  comm_backend="pallas", kernel_interpret=False)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    with torch.inference_mode():
        one = get_model(cfg).apply(params, {"tokens": T(m["tokens"])}, cfg,
                                   ParallelContext(SP1, "prefill", CPU))
        got = get_model(cfg).apply(params, {"tokens": T(m["tokens"])}, cfg,
                                   ParallelContext(sp, "prefill", mesh=mesh))
    assert float((got - one).abs().max()) <= PREFILL_TOL * float(
        one.abs().max())


def _serve(m, requests, port):
    if port:
        srv = ARServer(m["tparams"], m["cfg"], SP1, batch_slots=2,
                       max_len=32, device="cpu")
    else:
        srv = JARServer(m["jparams"], m["jcfg"], m["mesh1"], J_SP,
                        batch_slots=2, max_len=32)
    for rid, prompt, new in requests:
        p = np.asarray(prompt, np.int32)
        srv.submit(ARRequest(rid=rid, prompt=T(p), max_new_tokens=new)
                   if port else JARRequest(rid=rid, prompt=jnp.asarray(p),
                                           max_new_tokens=new))
    return srv.serve()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_ar_server_matches_reference(models, arch):
    requests = [(1, [3, 7, 11], 5), (2, [3, 7, 11], 5), (3, [9], 4)]
    got = _serve(models[arch], requests, port=True)
    assert got == _serve(models[arch], requests, port=False)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_tick_makes_no_host_copy_or_sync(models, guard, arch):
    """The capture rehearsal on the moe tick (routing, sorts, dispatch,
    expert products), at degree 1 and with the experts split over (model
    2): no host copy and no device read on its second call."""
    m = models[arch]
    tok = torch.tensor([[3], [5]], dtype=torch.int32)
    cur = torch.tensor(2, dtype=torch.int32)
    sp = SPConfig(strategy="full", sp_axes=("model",), batch_axes=("data",))
    for mesh, spc in ((None, SP1), (make_mesh((2,), ("model",),
                                              device="cpu"), sp)):
        srv = ARServer(m["tparams"], m["cfg"], spc, batch_slots=2,
                       max_len=16, device="cpu", mesh=mesh)
        nxt, caches = guard(lambda: srv._eager_step(srv.caches, tok, cur))
        assert nxt.shape == (2,) and caches["k"] is srv.caches["k"]
