"""The port's hybrid LM (hymba-1.5b: attention in parallel with an SSD
branch, mean-combined; layers {0, n/2, n-1} global, the rest windowed)
against the reference on the CPU, in float32.

Inputs and parameters are made with numpy and handed to both packages
(``load_jax_lm_params``); the reference runs in process on its 1-device
mesh.  Biases, norm scales and the SSD's ``a_log`` start as constants in
both packages; they are drawn first.

* the SSD half of models/ssm.py (chunk scan, influence, decode step)
  against the reference's at 1e-5 of max|ref|, over seeds and lengths,
  the chunk below and equal to L; the distributed SSD state over 2, 4 and
  8 virtual ranks (and two batch slices) against the port at degree 1;
* prefill logits of the reduced config (2 layers, both global) against
  the reference's ``bundle.apply`` at 1e-5 of max|logits|, full and
  ``last_only``;
* the per-layer window rule as the reference's; a 4-layer cut (layer 1
  windowed) decoded token by token against its own prefill at the
  reference's 5e-4 for the hybrid family, and against the reference's
  jitted step; its window masks keys;
* SP prefill on (data 2, model 4) and (pod 2, data 2, model 2) of virtual
  ranks against the port at degree 1 (1e-5);
* ARServer against the reference's ARServer, ROADMAP F4 and F5 on both
  packages, and the capture rehearsal of tests/test_torch_graphs.py on
  the hybrid tick.
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
from repro.models import ssm as jssm
from repro.serving import ARRequest as JARRequest
from repro.serving import ARServer as JARServer
from repro_torch.configs import HYBRID_ARCHS, get_reduced
from repro_torch.core import SPConfig
from repro_torch.launch import make_mesh
from repro_torch.models import (ParallelContext, get_model, init_lm,
                                init_lm_caches, load_jax_lm_params)
from repro_torch.models import lm as t_lm
from repro_torch.models import ssm
from repro_torch.serving import ARRequest, ARServer
from test_torch_graphs import guard  # noqa: F401  (the capture rehearsal)

ARCH = "hymba-1.5b"
CPU = torch.device("cpu")
T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
J_SP = JSP(strategy="full", sp_axes=("model",), batch_axes=("data",))
SP1 = SPConfig(strategy="full")
SSD_TOL = 1e-5  # of max|ref|
PREFILL_TOL = 1e-5  # of max|logits|
DECODE_TOL = 5e-4  # tests/test_decode_consistency.py, hybrid family
SP_TOL = 1e-5  # SP on virtual ranks vs degree 1, of max|logits|
B, L = 2, 40  # above the reduced window of 16
WINDOWED_LAYERS = 4  # the reduced config's 2 layers are both global


def perturb(tree, rng):
    """Draw the leaves the reference initialises as constants: linear
    biases N(0, 0.1^2), norm scales 1 + N(0, 0.1^2), the SSD's a_log
    N(0, 0.5^2) (per-head decay rates around 1)."""
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            perturb(leaf, rng)
        elif name in ("b", "bias", "scale", "norm_scale"):
            noise = (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)
            tree[name] = noise + 1.0 if "scale" in name else noise
        elif name == "a_log":
            tree[name] = (rng.standard_normal(leaf.shape) * 0.5).astype(
                np.float32)


def _build(mesh1, n_layers=None, seed=0):
    cfg = dataclasses.replace(get_reduced(ARCH), dtype="float32",
                              sharding_overrides=())
    jcfg = dataclasses.replace(j_get_reduced(ARCH), dtype="float32",
                               sharding_overrides=())
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
    jb = j_get_model(jcfg)
    params, _ = jb.init(jcfg, jax.random.PRNGKey(seed), 1)
    tree = jax.tree.map(np.array, params)
    rng = np.random.default_rng(seed)
    perturb(tree, rng)
    jparams = jax.tree.map(jnp.asarray, tree)
    tokens = rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)
    jstep = jax.jit(lambda p, b, c, i: jb.step(
        p, b, c, i, jcfg, JCtx(mesh1, J_SP, "decode")))
    return dict(cfg=cfg, jcfg=jcfg, jb=jb, tree=tree, jparams=jparams,
                tparams=load_jax_lm_params(tree, cfg, device="cpu"),
                tokens=tokens, jstep=jstep, mesh1=mesh1)


@pytest.fixture(scope="module")
def model(mesh1):
    return _build(mesh1)


@pytest.fixture(scope="module")
def deep(mesh1):
    """The 4-layer cut: layers 0, 2 and 3 global, layer 1 windowed."""
    return _build(mesh1, n_layers=WINDOWED_LAYERS, seed=1)


def _prefill(m, tokens, ctx=None, **kw):
    ctx = ctx or ParallelContext(SP1, "prefill", CPU)
    with torch.inference_mode():
        return get_model(m["cfg"]).apply(m["tparams"], {"tokens": T(tokens)},
                                         m["cfg"], ctx, **kw).numpy()


def _ref_prefill(m, tokens, **kw):
    return np.asarray(jax.jit(lambda p, t: m["jb"].apply(
        p, {"tokens": t}, m["jcfg"], JCtx(m["mesh1"], J_SP, "prefill"),
        **kw))(m["jparams"], jnp.asarray(tokens)))


def _decode(m, tokens):
    cfg = m["cfg"]
    bundle = get_model(cfg)
    ctx = ParallelContext(SP1, "decode", CPU)
    caches = bundle.init_caches(cfg, tokens.shape[0], tokens.shape[1],
                                torch.float32, "cpu")
    outs = []
    with torch.inference_mode():
        for t in range(tokens.shape[1]):
            logit, caches = bundle.step(m["tparams"],
                                        {"tokens": T(tokens[:, t:t + 1])},
                                        caches, t, cfg, ctx)
            outs.append(logit)
    return torch.stack(outs, dim=1).numpy()


def _ref_decode(m, tokens):
    jc = m["jb"].init_caches(m["jcfg"], tokens.shape[0], tokens.shape[1],
                             jnp.float32)
    outs = []
    for t in range(tokens.shape[1]):
        logit, jc = m["jstep"](m["jparams"],
                               {"tokens": jnp.asarray(tokens[:, t:t + 1])},
                               jc, jnp.int32(t))
        outs.append(np.asarray(logit))
    return np.stack(outs, axis=1)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, b, l, h, p, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    bm, cm = (rng.standard_normal((b, l, h, n)).astype(np.float32)
              for _ in range(2))
    a = (-np.exp(rng.standard_normal(h) * 0.5)).astype(np.float32)
    return x, dt, bm, cm, a


def _close(got, want, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, err_msg
    np.testing.assert_allclose(got, want, rtol=SSD_TOL,
                               atol=SSD_TOL * np.abs(want).max(),
                               err_msg=err_msg)


@pytest.mark.parametrize("seed,l,chunk", [(0, 128, 64), (1, 64, 64),
                                          (2, 96, 32), (3, 40, 64)])
def test_ssd_chunk_scan_matches_reference(seed, l, chunk):
    """All four fields of ssd_chunk_scan, chunk < L (two and three chunks)
    and chunk >= L (one chunk; at L 40 the chunk is L), within 1e-5 of
    max|ref| (measured at most 2.4e-6 on out)."""
    args = _ssd_inputs(seed, 2, l, 4, 32, 8)
    got = ssm.ssd_chunk_scan(*map(T, args), chunk=chunk)
    want = jssm.ssd_chunk_scan(*map(jnp.asarray, args), chunk=chunk)
    for name in ssm.ScanResult._fields:
        _close(getattr(got, name).numpy(), getattr(want, name), name)


def test_ssd_apply_influence_and_decode_step_match_reference():
    rng = np.random.default_rng(7)
    b, l, h, p, n = 2, 16, 3, 8, 4
    out = rng.standard_normal((b, l, h, p)).astype(np.float32)
    infl = rng.standard_normal((b, l, h, n)).astype(np.float32)
    s_in = rng.standard_normal((b, h, p, n)).astype(np.float32)
    _close(ssm.ssd_apply_influence(T(out), T(infl), T(s_in)).numpy(),
           jssm.ssd_apply_influence(*map(jnp.asarray, (out, infl, s_in))))
    x, dt, bm, cm, a = (t[:, 0] if t.ndim > 1 else t
                        for t in _ssd_inputs(8, b, 1, h, p, n))
    got = ssm.ssd_decode_step(*map(T, (x, dt, bm, cm, a, s_in)))
    want = jssm.ssd_decode_step(*map(jnp.asarray, (x, dt, bm, cm, a, s_in)))
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("size,slices", [(2, 1), (4, 1), (8, 1), (4, 2)])
def test_distributed_ssd_state_matches_degree_1(size, slices):
    """The sequence split over ``size`` virtual ranks (in each of
    ``slices`` batch slices): every rank's chunk scan with S_in = 0, the
    exclusive scan of the ranks' (decay, state) and the influence of S_in
    give the one-rank scan's outputs."""
    b, l = 2 * slices, 128
    args = [T(t) for t in _ssd_inputs(size, b, l, 3, 16, 8)]
    want = ssm.ssd_chunk_scan(*args, chunk=16).out
    shards = [[c for xs in torch.chunk(t, slices) for c in
               torch.chunk(xs, size, dim=1)] for t in args[:4]]
    res = [ssm.ssd_chunk_scan(*t, args[4], chunk=16) for t in zip(*shards)]
    s_in = ssm.distributed_state_in([r.a_dev for r in res],
                                    [r.s_out for r in res], ("model",),
                                    size, slices)
    parts = [ssm.ssd_apply_influence(r.out, r.infl, s)
             for r, s in zip(res, s_in)]
    got = torch.cat([torch.cat(parts[i:i + size], dim=1)
                     for i in range(0, len(parts), size)])
    assert float((got - want).abs().max()) <= SSD_TOL * float(
        want.abs().max())


# ---------------------------------------------------------------------------
# the model at degree 1
# ---------------------------------------------------------------------------

def test_hybrid_archs_registered():
    assert HYBRID_ARCHS == ("hymba-1.5b",)


def test_init_mirrors_reference_structure(model):
    """init_lm's and init_lm_caches's shapes (the SSD branch, the SSD
    state) are the reference's."""
    m = model
    mine = init_lm(m["cfg"], torch.Generator().manual_seed(0), device="cpu")
    ref = jax.tree.map(lambda a: tuple(a.shape), m["jparams"])
    layer_shapes = jax.tree.map(lambda s: s[1:], ref.pop("layers"),
                                is_leaf=lambda x: isinstance(x, tuple))
    assert jax.tree.map(lambda t: tuple(t.shape), {
        k: v for k, v in mine.items() if k != "layers"}) == ref
    for lp in mine["layers"]:
        assert jax.tree.map(lambda t: tuple(t.shape), lp) == layer_shapes
    caches = init_lm_caches(m["cfg"], 3, 32, torch.float32, "cpu")
    want = m["jb"].init_caches(m["jcfg"], 3, 32, jnp.float32)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in caches.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}


def test_prefill_logits_match_reference(model):
    """Full and last_only (measured at most 3.8e-06 of max|logits|)."""
    m = model
    want = _ref_prefill(m, m["tokens"])
    got = _prefill(m, m["tokens"])
    last = _prefill(m, m["tokens"], last_only=True)
    assert got.shape == (B, L, m["cfg"].vocab)
    assert _rel(got, want) <= PREFILL_TOL
    assert _rel(last, want[:, -1:]) <= PREFILL_TOL


@pytest.mark.parametrize("n_layers", [2, 4, 32])
def test_per_layer_windows_are_the_references(n_layers):
    cfg = dataclasses.replace(get_reduced(ARCH), n_layers=n_layers)
    jcfg = dataclasses.replace(j_get_reduced(ARCH), n_layers=n_layers)
    assert t_lm.GLOBAL_WINDOW == j_lm.GLOBAL_WINDOW
    assert t_lm._per_layer_windows(cfg) == np.asarray(
        j_lm._per_layer_windows(jcfg)).tolist()


@pytest.fixture(scope="module")
def deep_decoded(deep):
    return _decode(deep, deep["tokens"]), _prefill(deep, deep["tokens"])


def test_decode_matches_own_prefill(deep, deep_decoded):
    """Teacher-forced decode (the windowed decode attention and the SSD
    state) against the same tokens' prefill, on the 4-layer cut, at the
    reference's own tolerance for the hybrid family."""
    dec, full = deep_decoded
    np.testing.assert_allclose(dec, full, rtol=DECODE_TOL, atol=DECODE_TOL)


def test_decode_matches_reference_step(deep, deep_decoded):
    dec, _ = deep_decoded
    np.testing.assert_allclose(dec, _ref_decode(deep, deep["tokens"]),
                               rtol=DECODE_TOL, atol=DECODE_TOL)


def test_window_masks_keys(deep):
    """Layer 1's window of 16 at L 40 changes the logits far beyond the
    tolerances above: it is applied, not ignored."""
    wide = dict(deep, cfg=dataclasses.replace(deep["cfg"], window=None))
    assert t_lm._per_layer_windows(deep["cfg"])[1] == 16
    got, no_window = _prefill(deep, deep["tokens"]), _prefill(
        wide, deep["tokens"])
    assert _rel(no_window, got) > 1000 * PREFILL_TOL


# ---------------------------------------------------------------------------
# SP prefill on virtual ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axes,sp_axes,strategy,backend", [
    ((2, 4), ("data", "model"), ("model",), "swift_torus", "pallas"),
    ((2, 4), ("data", "model"), ("model",), "ring", "xla"),
    ((2, 2, 2), ("pod", "data", "model"), ("pod", "model"), "swift",
     "pallas"),
])
def test_sp_prefill_matches_degree_1(deep, shape, axes, sp_axes, strategy,
                                     backend):
    """The 4-layer cut at B 4 x L 32: attention through the SP schedule,
    the SSD state through the distributed scan, the batch over data
    (measured at most 3.3e-06 of max|logits|)."""
    tokens = np.concatenate([deep["tokens"]] * 2)[:, :32]
    sp = SPConfig(strategy=strategy, sp_axes=sp_axes, batch_axes=("data",),
                  machine_axis="pod", comm_backend=backend,
                  kernel_interpret=False)
    ctx = ParallelContext(sp, "prefill", mesh=make_mesh(shape, axes,
                                                        device="cpu"))
    assert _rel(_prefill(deep, tokens, ctx), _prefill(deep, tokens)) <= SP_TOL


# ---------------------------------------------------------------------------
# ARServer
# ---------------------------------------------------------------------------

def _serve(m, slots, max_len, requests, port):
    if port:
        srv = ARServer(m["tparams"], m["cfg"], SP1, batch_slots=slots,
                       max_len=max_len, device="cpu")
    else:
        srv = JARServer(m["jparams"], m["jcfg"], m["mesh1"], J_SP,
                        batch_slots=slots, max_len=max_len)
    for rid, prompt, new in requests:
        p = np.asarray(prompt, np.int32)
        srv.submit(ARRequest(rid=rid, prompt=T(p), max_new_tokens=new)
                   if port else JARRequest(rid=rid, prompt=jnp.asarray(p),
                                           max_new_tokens=new))
    return srv.serve()


def test_ar_server_matches_reference(deep):
    requests = [(1, [3, 7, 11], 5), (2, [3, 7, 11], 5), (3, [9], 4)]
    got = _serve(deep, 2, 32, requests, port=True)
    assert got == _serve(deep, 2, 32, requests, port=False)
    assert {rid: len(v) for rid, v in got.items()} == {1: 5, 2: 5, 3: 4}


def test_f4_hybrid_slot_state_carries_over_on_both_packages(deep):
    """ROADMAP F4 for the hybrid family: a slot keeps its KV caches and its
    SSD state across requests and shares cur_index, so request 2 (taking
    the slot request 1 freed while request 0 runs) depends on request 1's
    prompt, on the reference and, mirrored, on the port."""
    rng = np.random.default_rng(3)
    long, third = (rng.integers(0, deep["cfg"].vocab, n).tolist()
                   for n in (4, 3))
    runs = {}
    for port in (False, True):
        for second in ([5, 9, 2], [8, 1, 7]):
            reqs = [(0, long, 12), (1, second, 2), (2, third, 4)]
            runs[port, tuple(second)] = _serve(deep, 2, 32, reqs, port)[2]
    assert runs[True, (5, 9, 2)] != runs[True, (8, 1, 7)]
    for second in ((5, 9, 2), (8, 1, 7)):
        assert runs[True, second] == runs[False, second]


def test_f5_cache_dtype_must_be_the_models_on_both_packages(model):
    """ROADMAP F5 binds the hybrid family: a bfloat16 hymba refuses float32
    KV caches in both packages."""
    m = model
    cfg = dataclasses.replace(m["cfg"], dtype="bfloat16")
    jcfg = dataclasses.replace(m["jcfg"], dtype="bfloat16")
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), m["tree"])
    jb = m["jb"]
    with pytest.raises(TypeError):
        jax.jit(lambda p, b, c, i: jb.step(
            p, b, c, i, jcfg, JCtx(m["mesh1"], J_SP, "decode")))(
                jparams, {"tokens": jnp.ones((B, 1), jnp.int32)},
                jb.init_caches(jcfg, B, 8, jnp.float32), jnp.int32(0))
    params = load_jax_lm_params(m["tree"], cfg, device="cpu")
    bundle = get_model(cfg)
    with pytest.raises(TypeError, match="dtype"), torch.inference_mode():
        bundle.step(params, {"tokens": torch.ones((B, 1), dtype=torch.int32)},
                    bundle.init_caches(cfg, B, 8, torch.float32, "cpu"), 0,
                    cfg, ParallelContext(SP1, "decode", CPU))
    caches = bundle.init_caches(cfg, B, 8, torch.bfloat16, "cpu")
    with torch.inference_mode():
        logits, caches = bundle.step(
            params, {"tokens": torch.ones((B, 1), dtype=torch.int32)},
            caches, 0, cfg, ParallelContext(SP1, "decode", CPU))
    assert logits.dtype == torch.bfloat16 and bool(
        torch.isfinite(logits).all())
    assert caches["ssd_state"].dtype == torch.float32
    assert bool(caches["ssd_state"].any())


def test_hybrid_tick_makes_no_host_copy_or_sync(deep, guard):
    """The capture rehearsal of tests/test_torch_graphs.py on the hybrid
    tick: its second call makes no host copy and reads no device value;
    the caches it returns are the server's (written in place)."""
    srv = ARServer(deep["tparams"], deep["cfg"], SP1, batch_slots=2,
                   max_len=16, device="cpu")
    tok = torch.tensor([[3], [5]], dtype=torch.int32)
    cur = torch.tensor(2, dtype=torch.int32)
    nxt, caches = guard(lambda: srv._eager_step(srv.caches, tok, cur))
    assert nxt.shape == (2,)
    assert all(caches[k] is srv.caches[k] for k in ("k", "v", "ssd_state"))
