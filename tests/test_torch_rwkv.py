"""The port's RWKV6 path against the reference on the CPU: the plain
version of the WKV kernel K5, the ssm scan functions, the rwkv6 language
model's prefill and decode on the reduced config, ARServer's greedy
tokens, prefill under SP on virtual ranks, and the reference fault F3.

Inputs are made with numpy from a seed and handed to both packages; the
reference's Pallas WKV kernel runs in interpret mode, as its own tests run
it.  The model's zero-initialised tensors (the decay base w0, the bonus u,
every mu_* and wlora_b) are perturbed first: at init w = 1/e everywhere,
the bonus adds nothing and the token shift is unused, so a comparison
would pass vacuously.  w0 is drawn from RWKV6's own decay initialisation
range [-6, -1] (Finch, arXiv 2404.05892), so w = exp(-exp(w0 + lora))
lies in about [0.69, 0.998]; far from F3's underflow, which needs a mean
decay of about 0.25 or less over a chunk of 64.  Prompts are 128 tokens,
two chunks of 64, so that the state carried between chunks is exercised.
"""
import dataclasses
import pathlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.core import SPConfig as JSP
from repro.kernels.rwkv6_wkv import rwkv6_wkv as j_rwkv6_wkv
from repro.models import ParallelContext as JCtx
from repro.models import get_model as j_get_model
from repro.models import ssm as jssm
from repro.serving import ARRequest as JARRequest
from repro.serving import ARServer as JARServer
from repro_torch.configs import get_reduced
from repro_torch.core import SPConfig
from repro_torch.kernels import rwkv6_wkv, rwkv6_wkv_heads, rwkv6_wkv_ref
from repro_torch.launch import make_mesh
from repro_torch.models import (ParallelContext, get_model, init_lm,
                                init_lm_caches, lm_forward, load_jax_lm_params)
from repro_torch.models import ssm
from repro_torch.serving import ARRequest, ARServer

wkv_mod = importlib.import_module("repro_torch.kernels.rwkv6_wkv")
CPU = torch.device("cpu")
T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
J_SP = JSP(strategy="full", sp_axes=("model",), batch_axes=("data",))
SP1 = SPConfig(strategy="full")


def _wkv_inputs(seed, shape, u_rows):
    """The reference test's distributions: decays sigmoid(N(0, 1)) / 2 +
    1/2, in [0.5, 1]."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    w = (0.5 / (1.0 + np.exp(-rng.standard_normal(shape))) + 0.5).astype(
        np.float32)
    u = (rng.standard_normal((u_rows, shape[-1])) * 0.1).astype(np.float32)
    return r, k, v, w, u


def _naive(r, k, v, w, u):
    """The recurrence step by step in float64 (the reference test's)."""
    bh, l, n = r.shape
    s = np.zeros((bh, n, n))
    out = np.zeros((bh, l, n))
    r, k, v, w, u = (np.asarray(t, np.float64) for t in (r, k, v, w, u))
    for t in range(l):
        kv = k[:, t][:, :, None] * v[:, t][:, None, :]
        out[:, t] = np.einsum("bn,bnm->bm", r[:, t], s + u[:, :, None] * kv)
        s = w[:, t][:, :, None] * s + kv
    return out


# ---------------------------------------------------------------------------
# K5's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("l,n,chunk", [(32, 8, 8), (64, 16, 16), (128, 64, 64),
                                       (64, 32, 64)])
def test_wkv_plain_matches_reference_kernel_and_naive(l, n, chunk, dtype, tol):
    """rwkv6_wkv on the CPU (the plain version) against the reference's
    Pallas kernel in interpret mode and the float64 recurrence of the same
    inputs (rounded to ``dtype`` first, as the kernel reads them), at the
    reference's tolerances: 2e-4 in f32, 5e-2 in bf16 (measured max|d| vs
    the recurrence 4.9e-05 in f32, 5.7e-05 in bf16).  Both packages get
    the same inputs, so the port also holds to the reference kernel at
    2e-4 in either dtype (measured 6.3e-05 and 1.3e-04)."""
    inputs = [T(t).to(getattr(torch, dtype))
              for t in _wkv_inputs(l + n + chunk, (2, l, n), 2)]
    got = rwkv6_wkv(*inputs, chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == (2, l, n)
    exact = [t.float().numpy() for t in inputs]
    want = j_rwkv6_wkv(*(jnp.asarray(t, dtype) for t in exact), chunk=chunk,
                       interpret=True)
    np.testing.assert_allclose(got.numpy(), _naive(*exact), rtol=tol, atol=tol)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=2e-4, atol=2e-4)


def test_wkv_heads_matches_reference_chunk_scan():
    """The model's [B, L, H, N] entry point (mapped to [BH, L, N] as the
    reference test maps it) against the reference's chunk scan output
    (measured max|d| 9.5e-06, tolerance 2e-4)."""
    b, l, h, n = 2, 64, 3, 16
    r, k, v, w, u = _wkv_inputs(1, (b, l, h, n), h)
    got = rwkv6_wkv_heads(*(T(t) for t in (r, k, v, w, u)), chunk=16)
    want = jssm.rwkv6_chunk_scan(*(jnp.asarray(t) for t in (r, k, v, w, u)),
                                 chunk=16).out
    assert got.shape == (b, l, h, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_wkv_wrapper_dispatch_and_checks():
    """CPU tensors run the plain version (no launch counted); an L that the
    chunk does not divide raises ValueError, as the reference asserts."""
    r, k, v, w, u = (T(t) for t in _wkv_inputs(2, (2, 96, 16), 2))
    before = wkv_mod.launch_count()
    assert torch.equal(rwkv6_wkv(r, k, v, w, u, chunk=32),
                       rwkv6_wkv_ref(r, k, v, w, u, chunk=32))
    assert wkv_mod.launch_count() == before
    with pytest.raises(ValueError, match="multiple"):
        rwkv6_wkv(r, k, v, w, u)  # c = 64 does not divide 96
    with pytest.raises(ValueError, match="u has shape"):
        rwkv6_wkv_heads(*(t[None] for t in (r, k, v, w)), u[:1])


@pytest.mark.parametrize("bh,n,sms,split", [
    (128, 64, 132, 1),   # B 4 x L 4096 on an H100: 128 blocks fill it
    (32, 64, 132, 4),    # B 1 x L 1024: 32 rows, 128 blocks
    (64, 64, 132, 2),    # B 2: 64 rows
    (66, 64, 132, 2), (67, 64, 132, 1), (33, 64, 132, 4), (34, 64, 132, 2),
    (32, 32, 132, 2),    # N 32: at most 2 blocks of 16 columns
    (3, 16, 132, 1), (3, 8, 132, 1),  # N 16 and 8 are never split
    (8, 64, 16, 2), (1, 64, 1, 1),
])
def test_wkv_value_split(bh, n, sms, split):
    """The wrapper's value-column split, a pure function of (BH, N, SMs):
    the largest of 1, 2, 4 that keeps 16 or more columns a block and BH x
    split blocks within one wave of the SMs."""
    assert wkv_mod.value_split(bh, n, sms) == split
    assert split in wkv_mod.SPLITS and n // split >= min(
        n, wkv_mod.MIN_SPLIT_COLUMNS)


# ---------------------------------------------------------------------------
# ssm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [64, 32])
def test_chunk_scan_matches_reference(chunk):
    """All four fields of rwkv6_chunk_scan (measured max|d| of out 3.6e-05
    at max|out| 35, of s_out 9.1e-06 at 6.2), tolerance 2e-4 relative."""
    b, l, h, n = 2, 128, 3, 16
    r, k, v, w, u = _wkv_inputs(3, (b, l, h, n), h)
    got = ssm.rwkv6_chunk_scan(*(T(t) for t in (r, k, v, w, u)), chunk=chunk)
    want = jssm.rwkv6_chunk_scan(*(jnp.asarray(t) for t in (r, k, v, w, u)),
                                 chunk=chunk)
    for name in ssm.ScanResult._fields:
        g, x = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == x.shape, name
        np.testing.assert_allclose(g, x, rtol=2e-4, atol=2e-4 * np.abs(x).max(),
                                   err_msg=name)


def test_shard_summary_matches_reference_scan_fields():
    """What an SP rank computes beside K5 (a_dev, s_out, infl) equals the
    reference chunk scan's fields (measured max|d| <= 1.3e-05, tolerance
    2e-4 relative)."""
    b, l, h, n = 2, 128, 3, 16
    r, k, v, w, u = _wkv_inputs(4, (b, l, h, n), h)
    a_dev, s_out, infl = ssm.rwkv6_shard_summary(*(T(t) for t in (r, k, v, w)))
    want = jssm.rwkv6_chunk_scan(*(jnp.asarray(t) for t in (r, k, v, w, u)))
    for g, x in ((a_dev, want.a_dev), (s_out, want.s_out), (infl, want.infl)):
        x = np.asarray(x)
        np.testing.assert_allclose(g.numpy(), x, rtol=2e-4,
                                   atol=2e-4 * np.abs(x).max())


def test_apply_influence_and_decode_step_match_reference():
    """rwkv6_apply_influence with a nonzero S_in and rwkv6_decode_step
    (measured max|d| 0 and 4.8e-07, tolerance 2e-4)."""
    rng = np.random.default_rng(5)
    b, l, h, n = 2, 16, 3, 8
    out, infl = (rng.standard_normal((b, l, h, n)).astype(np.float32)
                 for _ in range(2))
    s_in = rng.standard_normal((b, h, n, n)).astype(np.float32)
    np.testing.assert_allclose(
        ssm.rwkv6_apply_influence(T(out), T(infl), T(s_in)).numpy(),
        np.asarray(jssm.rwkv6_apply_influence(*map(jnp.asarray,
                                                    (out, infl, s_in)))),
        rtol=2e-4, atol=2e-4)
    r, k, v, w, u = _wkv_inputs(6, (b, h, n), h)
    got = ssm.rwkv6_decode_step(*(T(t) for t in (r, k, v, w, u)), T(s_in))
    want = jssm.rwkv6_decode_step(*map(jnp.asarray, (r, k, v, w, u, s_in)))
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("size", [2, 4, 5])
def test_distributed_state_in_is_the_exclusive_composition(size):
    """The Hillis-Steele scan over virtual ranks equals composing the
    ranks' (A, B) in order: S_in(p) = A_{p-1} S_in(p-1) + B_{p-1}."""
    rng = np.random.default_rng(size)
    a = [T(rng.uniform(0.2, 1.0, (2, 3, 4)).astype(np.float32))
         for _ in range(size)]
    bs = [T(rng.standard_normal((2, 3, 4, 4)).astype(np.float32))
          for _ in range(size)]
    got = ssm.distributed_state_in(a, bs, ("model",), size)
    s = torch.zeros_like(bs[0])
    for p in range(size):
        torch.testing.assert_close(got[p], s, rtol=1e-5, atol=1e-6)
        s = a[p][..., None] * s + bs[p]


# ---------------------------------------------------------------------------
# F3: the reference's cumulative decay underflows, and the port inherits it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("decay", [0.3, 0.25, 0.2, 0.1])
def test_f3_chunk_decay_underflow_on_both_packages(decay):
    """ROADMAP F3.  The chunk form divides by D = prod w over the chunk;
    at chunk 64 a uniform decay of 0.25 or less takes log D below -88.7,
    D underflows float32 and k/D overflows, so the WKV kernel and the chunk
    scan of BOTH packages return non-finite outputs.  At chunk 16 the same
    decays stay finite, as does 0.3 at chunk 64.  The port keeps the
    reference's function for parity; this test shows the fault, it does
    not hide it."""
    b, l, h, n = 1, 128, 2, 16
    r, k, v, _, u = _wkv_inputs(7, (b, l, h, n), h)
    w = np.full((b, l, h, n), decay, np.float32)
    flat = lambda x: x.transpose(0, 2, 1, 3).reshape(b * h, l, n)
    for chunk in (64, 16):
        finite = {
            "ref kernel": np.isfinite(np.asarray(j_rwkv6_wkv(
                *(jnp.asarray(flat(t)) for t in (r, k, v, w)), jnp.asarray(u),
                chunk=chunk, interpret=True))).all(),
            "ref scan": np.isfinite(np.asarray(jssm.rwkv6_chunk_scan(
                *map(jnp.asarray, (r, k, v, w, u)), chunk=chunk).out)).all(),
            "port K5 plain": bool(torch.isfinite(rwkv6_wkv_heads(
                *(T(t) for t in (r, k, v, w, u)), chunk=chunk)).all()),
            "port scan": bool(torch.isfinite(ssm.rwkv6_chunk_scan(
                *(T(t) for t in (r, k, v, w, u)), chunk=chunk).out).all()),
        }
        underflows = chunk == 64 and decay <= 0.25
        assert set(finite.values()) == {not underflows}, (chunk, finite)


# ---------------------------------------------------------------------------
# the rwkv6 language model
# ---------------------------------------------------------------------------

def perturb_zero_init(tree, rng):
    """The zero-initialised leaves of the reference's rwkv6 tree, drawn
    from ranges that RWKV6 itself initialises them in (numpy, in place)."""
    tm, cm = tree["layers"]["tm"], tree["layers"]["cm"]
    shape = tm["w0"].shape  # [n_layers, d]
    tm["w0"] = rng.uniform(-6.0, -1.0, shape).astype(np.float32)
    for name in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w"):
        tm[name] = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    for name in ("mu_k", "mu_r"):
        cm[name] = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    tm["u"] = (rng.standard_normal(tm["u"].shape) * 0.5).astype(np.float32)
    wb = tm["wlora_b"]["w"]  # [n_layers, lora, d]; |lora term| ~ 0.01
    tm["wlora_b"]["w"] = (rng.standard_normal(wb.shape) * 0.01
                          / wb.shape[1] ** 0.5).astype(np.float32)


@pytest.fixture(scope="module")
def lm(mesh1):
    cfg = dataclasses.replace(get_reduced("rwkv6-1.6b"), dtype="float32")
    jcfg = dataclasses.replace(j_get_reduced("rwkv6-1.6b"), dtype="float32",
                               sharding_overrides=())
    jb = j_get_model(jcfg)
    params, _ = jb.init(jcfg, jax.random.PRNGKey(0), 1)
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(0)
    perturb_zero_init(tree, rng)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = load_jax_lm_params(tree, cfg, device="cpu")
    tokens = rng.integers(0, cfg.vocab, (2, 128)).astype(np.int32)
    jstep = jax.jit(lambda p, b, c, i: jb.step(
        p, b, c, i, jcfg, JCtx(mesh1, J_SP, "decode")))
    jfull = np.asarray(jb.apply(jparams, {"tokens": jnp.asarray(tokens)}, jcfg,
                                JCtx(mesh1, J_SP, "prefill")))
    return dict(cfg=cfg, jcfg=jcfg, jb=jb, jparams=jparams, tree=tree,
                tparams=tparams, tokens=tokens, jstep=jstep, jfull=jfull,
                mesh1=mesh1)


def _decode(bundle_step, params, cfg, ctx, tokens, caches):
    outs = []
    with torch.inference_mode():
        for t in range(tokens.shape[1]):
            logit, caches = bundle_step(params, {"tokens": T(tokens[:, t:t + 1])},
                                        caches, t, cfg, ctx)
            outs.append(logit)
    return torch.stack(outs, dim=1).numpy()


@pytest.fixture(scope="module")
def decoded(lm):
    """The port's and the reference's teacher-forced decode logits."""
    cfg, tokens = lm["cfg"], lm["tokens"]
    ctx = ParallelContext(SP1, "decode", CPU)
    bundle = get_model(cfg)
    caches = bundle.init_caches(cfg, 2, tokens.shape[1], torch.float32, "cpu")
    port = _decode(bundle.step, lm["tparams"], cfg, ctx, tokens, caches)
    jc = lm["jb"].init_caches(lm["jcfg"], 2, tokens.shape[1], jnp.float32)
    outs = []
    for t in range(tokens.shape[1]):
        logit, jc = lm["jstep"](lm["jparams"],
                                {"tokens": jnp.asarray(tokens[:, t:t + 1])},
                                jc, jnp.int32(t))
        outs.append(np.asarray(logit))
    return port, np.stack(outs, axis=1)


def test_init_lm_mirrors_reference_structure(lm):
    cfg = lm["cfg"]
    mine = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = jax.tree.map(lambda a: tuple(a.shape), lm["jparams"])
    layer_shapes = jax.tree.map(lambda s: s[1:], ref.pop("layers"),
                                is_leaf=lambda x: isinstance(x, tuple))
    assert jax.tree.map(lambda t: tuple(t.shape), {
        k: v for k, v in mine.items() if k != "layers"}) == ref
    assert len(mine["layers"]) == cfg.n_layers
    for lp in mine["layers"]:
        assert jax.tree.map(lambda t: tuple(t.shape), lp) == layer_shapes
        for leaf in (lp["tm"]["w0"], lp["tm"]["u"], lp["tm"]["mu_w"],
                     lp["tm"]["wlora_b"]["w"], lp["cm"]["mu_k"]):
            assert torch.all(leaf == 0)
    caches = init_lm_caches(cfg, 3, 32, torch.float32, "cpu")
    want = lm["jb"].init_caches(lm["jcfg"], 3, 32, jnp.float32)
    assert {k: tuple(v.shape) for k, v in caches.items()} == {
        k: tuple(v.shape) for k, v in want.items()}


def test_prefill_logits_match_reference(lm):
    """lm_forward prefill at SP degree 1 (K5's plain version in every
    layer), B 2, L 128, full and last_only (measured max|d| 1.6e-05 at
    max|logit| 4.6; tolerance 1e-4)."""
    cfg, tokens, jfull = lm["cfg"], lm["tokens"], lm["jfull"]
    ctx = ParallelContext(SP1, "prefill", CPU)
    with torch.inference_mode():
        full, aux, caches = lm_forward(lm["tparams"], cfg, ctx,
                                       tokens=T(tokens))
        last = get_model(cfg).apply(lm["tparams"], {"tokens": T(tokens)}, cfg,
                                    ctx, last_only=True)
    assert caches is None and float(aux) == 0.0
    assert full.shape == (2, 128, cfg.vocab) and last.shape == (2, 1, cfg.vocab)
    np.testing.assert_allclose(full.numpy(), jfull, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(last.numpy(), jfull[:, -1:], rtol=1e-4,
                               atol=1e-4)


def test_decode_matches_reference_step(lm, decoded):
    """Decode logits token by token against the reference's bundle.step
    (measured max|d| 7.1e-06; tolerance 5e-4, the reference's own for the
    ssm family in tests/test_decode_consistency.py)."""
    port, ref = decoded
    np.testing.assert_allclose(port, ref, rtol=5e-4, atol=5e-4)


def test_decode_matches_own_prefill(lm, decoded):
    """The port's teacher-forced decode against its own prefill, at the
    reference's 5e-4 (measured max|d| 4.5e-05; the reference's own pair
    differs by 3.1e-05 on these inputs)."""
    port, _ = decoded
    ctx = ParallelContext(SP1, "prefill", CPU)
    with torch.inference_mode():
        full = get_model(lm["cfg"]).apply(lm["tparams"],
                                          {"tokens": T(lm["tokens"])},
                                          lm["cfg"], ctx)
    np.testing.assert_allclose(port, full.numpy(), rtol=5e-4, atol=5e-4)


def test_bf16_decode_from_f32_caches(lm):
    """A bfloat16 model decoding from float32 caches (ARServer's default):
    the first step's token shift promotes the time mix to float32, the
    shift caches take the activations' dtype from then on, and every
    layer's output stays bfloat16, as the reference's scan carry must."""
    cfg = dataclasses.replace(lm["cfg"], dtype="bfloat16")
    params = load_jax_lm_params(lm["tree"], cfg, device="cpu")
    bundle = get_model(cfg)
    ctx = ParallelContext(SP1, "decode", CPU)
    caches = bundle.init_caches(cfg, 2, 8, torch.float32, "cpu")
    with torch.inference_mode():
        for t in range(3):
            logits, caches = bundle.step(
                params, {"tokens": T(lm["tokens"][:, t:t + 1])}, caches, t,
                cfg, ctx)
            assert logits.dtype == torch.bfloat16
            assert bool(torch.isfinite(logits).all())
            assert caches["shift_tm"].dtype == torch.bfloat16
            assert caches["wkv_state"].dtype == torch.float32


@pytest.mark.parametrize("family", ["audio", "dit"])
def test_other_families_raise(lm, family):
    """The families the LM does not serve (the audio family is whisper's
    model, the DiT has its own) raise, naming the module that serves them.
    The dense, vlm, hybrid and moe families are served
    (tests/test_torch_dense.py, test_torch_hymba.py, test_torch_moe.py)."""
    cfg = dataclasses.replace(lm["cfg"], family=family)
    with pytest.raises(NotImplementedError, match="models/whisper.py"):
        init_lm(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="models/whisper.py"):
        lm_forward(lm["tparams"], cfg, ParallelContext(SP1, device=CPU),
                   tokens=T(lm["tokens"]))


# ---------------------------------------------------------------------------
# ARServer
# ---------------------------------------------------------------------------

# (rid, prompt length, priority, new tokens): rid 2 arrives last with the
# highest priority and takes a slot first; rid 1 waits for a free slot
AR_REQUESTS = ((0, 5, 0.0, 6), (1, 9, 0.0, 4), (2, 3, 5.0, 5))


def test_ar_server_matches_reference(lm):
    """The same greedy tokens as the reference's ARServer: 3 requests of
    different lengths and priorities in 2 slots.  Every logit the port's
    server computed is replayed through the reference's step on the same
    tokens and caches; at every position whose argmax became a token, the
    top-2 logit gap exceeds 100x the largest logit error seen (measured:
    error 1.3e-05, smallest gap 4.9e-02), so equal tokens are no luck."""
    cfg, rng = lm["cfg"], np.random.default_rng(9)
    prompts = {rid: rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for rid, n, _, _ in AR_REQUESTS}
    jsrv = JARServer(lm["jparams"], lm["jcfg"], lm["mesh1"], J_SP,
                     batch_slots=2, max_len=32)
    srv = ARServer(lm["tparams"], cfg, SP1, batch_slots=2, max_len=32,
                   device="cpu")
    for rid, _, prio, new in AR_REQUESTS:
        jsrv.submit(JARRequest(rid=rid, prompt=jnp.asarray(prompts[rid]),
                               max_new_tokens=new, priority=prio))
        srv.submit(ARRequest(rid=rid, prompt=T(prompts[rid]),
                             max_new_tokens=new, priority=prio))
    seen = []
    real = srv.bundle.step

    def recording(params, batch, caches, cur_index, cfg_, ctx):
        used = [s.req is not None and s.pos + 1 >= len(s.req.prompt)
                for s in srv.slots]
        logits, caches = real(params, batch, caches, cur_index, cfg_, ctx)
        seen.append((batch["tokens"].numpy().copy(), cur_index,
                     logits.numpy().copy(), used))
        return logits, caches

    srv.bundle = dataclasses.replace(srv.bundle, step=recording)
    want = jsrv.serve()
    got = srv.serve()
    assert got == want
    assert {rid: len(v) for rid, v in got.items()} == {
        rid: new for rid, _, _, new in AR_REQUESTS}
    # the same counters and queue waits: rid 2 (priority 5) admitted at
    # once, rid 1 waited for a free slot
    for name in ("ar.submitted", "ar.admitted", "ar.ticks", "ar.completed"):
        assert (srv.tracker.counter_total(name)
                == jsrv.tracker.counter_total(name)), name
    assert srv.tracker.counter_total("ar.admitted") == 3
    waits = lambda tr: sorted((tags["rid"], st.mean) for tags, st in
                              tr.series_items("ar.queue_wait_ticks"))
    assert waits(srv.tracker) == waits(jsrv.tracker)
    assert dict(waits(srv.tracker))[1] > 0 == dict(waits(srv.tracker))[2]
    jc = lm["jb"].init_caches(lm["jcfg"], 2, 32, jnp.float32)
    err, gap = 0.0, np.inf
    for tokens, idx, logits, used in seen:
        ref, jc = lm["jstep"](lm["jparams"], {"tokens": jnp.asarray(tokens)},
                              jc, jnp.int32(idx))
        err = max(err, float(np.abs(logits - np.asarray(ref)).max()))
        top2 = np.sort(logits, axis=-1)[:, -2:]
        for row, use in enumerate(used):
            if use:
                gap = min(gap, float(top2[row, 1] - top2[row, 0]))
    print(f"ARServer logits: max|d| {err:.3e}, smallest top-2 gap {gap:.3e}")
    assert gap > 100 * err, (gap, err)


def test_f4_slot_state_carries_over_on_both_packages(lm):
    """ROADMAP F4.  ARServer does not reset a slot's caches when a new
    request takes the slot, so a request's greedy tokens depend on the
    request that held the slot before it: on the reference and, mirrored
    for parity, on the port, with the same tokens."""
    rng = np.random.default_rng(1)
    first, second = (rng.integers(0, lm["cfg"].vocab, (n,)).astype(np.int32)
                     for n in (6, 5))

    def run(reqs, port):
        if port:
            srv = ARServer(lm["tparams"], lm["cfg"], SP1, batch_slots=1,
                           max_len=64, device="cpu")
        else:
            srv = JARServer(lm["jparams"], lm["jcfg"], lm["mesh1"], J_SP,
                            batch_slots=1, max_len=64)
        for rid, prompt in reqs:
            req = ARRequest if port else JARRequest
            srv.submit(req(rid=rid, prompt=T(prompt) if port
                           else jnp.asarray(prompt), max_new_tokens=6))
        return srv.serve()[1]

    for port in (False, True):
        alone = run([(1, second)], port)
        after = run([(0, first), (1, second)], port)
        assert alone != after, port
    assert run([(0, first), (1, second)], True) == run(
        [(0, first), (1, second)], False)


# ---------------------------------------------------------------------------
# prefill under SP on virtual ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axes", [((4,), ("model",)),
                                        ((2, 2), ("pod", "model"))])
def test_sp_prefill_matches_degree_1(lm, shape, axes):
    """Prefill with the sequence sharded over 4 virtual ranks: K5's plain
    version on every rank's 32 tokens, the ranks' states composed by the
    distributed exclusive scan, the token shift across rank boundaries;
    logits within 1e-4 of max|logits| of degree 1 (measured 9.1e-07)."""
    cfg, tokens = lm["cfg"], T(lm["tokens"])
    with torch.inference_mode():
        one = lm_forward(lm["tparams"], cfg, ParallelContext(SP1, device=CPU),
                         tokens=tokens)[0]
        ctx = ParallelContext(SPConfig(strategy="full", sp_axes=axes),
                              mesh=make_mesh(shape, axes, device="cpu"))
        assert ctx.sp_degree == 4
        sp = lm_forward(lm["tparams"], cfg, ctx, tokens=tokens)[0]
    assert float((sp - one).abs().max()) <= 1e-4 * float(one.abs().max())


@pytest.mark.parametrize("shape,axes", [((2, 2), ("data", "model")),
                                        ((2, 2, 2), ("pod", "data",
                                                     "model"))])
def test_sp_prefill_over_batch_axis_matches_degree_1(lm, shape, axes):
    """A batch axis of size 2 beside the SP axes: each batch slice runs
    the token shift and the distributed scan over its own SP ranks (one
    put covers both slices); logits within 1e-4 of max|logits| of
    degree 1, as the test above."""
    cfg, tokens = lm["cfg"], T(lm["tokens"])
    sp_axes = tuple(a for a in axes if a != "data")
    with torch.inference_mode():
        one = lm_forward(lm["tparams"], cfg, ParallelContext(SP1, device=CPU),
                         tokens=tokens)[0]
        ctx = ParallelContext(SPConfig(strategy="full", sp_axes=sp_axes),
                              mesh=make_mesh(shape, axes, device="cpu"))
        sp = lm_forward(lm["tparams"], cfg, ctx, tokens=tokens)[0]
    assert float((sp - one).abs().max()) <= 1e-4 * float(one.abs().max())


def test_entry_points_need_cuda_unless_asked_for_cpu(lm):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    cfg = lm["cfg"]
    with pytest.raises(RuntimeError, match="CUDA"):
        init_lm(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_lm_caches(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_jax_lm_params(lm["tree"], cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ARServer(lm["tparams"], cfg, SP1)


def test_parallel_context_needs_cuda_unless_given_a_device(monkeypatch):
    """ParallelContext without a device or a mesh runs on CUDA, as the
    servers do, so the sampler's noise is drawn where the model runs;
    without CUDA it raises and names device='cpu', and a device given or a
    mesh's device is kept."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ParallelContext(SPConfig(strategy="full"))
    assert ParallelContext(SP1, device="cpu").device == CPU
    mesh = make_mesh((2,), ("model",), device="cpu")
    assert ParallelContext(SP1, mesh=mesh).device == mesh.device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert ParallelContext(SP1).device == torch.device("cuda")


def test_wkv_wrapper_mirrors_the_kernel_constants():
    """The wrapper's split rule and the kernel's instantiations agree: the
    kernel source's MIN_SPLIT_COLUMNS is the wrapper's (the kernel only
    takes splits that leave that many columns a block)."""
    import re
    src = (pathlib.Path(wkv_mod.__file__).resolve().parents[1] / "csrc"
           / "rwkv6_wkv.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["MIN_SPLIT_COLUMNS"]) == wkv_mod.MIN_SPLIT_COLUMNS
