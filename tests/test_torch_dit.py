"""The port's DiT, sampler and server against the reference on the reduced
flux-12b config in float32.

Weights cross over through ``load_jax_params``; the zero-initialised adaLN
and output projections are perturbed first, since a fresh DiT is the
identity and would pass vacuously.  Two distinct timesteps go in, so a
change to the reference's timestep embedding (which ignores t) would fail
parity.
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
from repro.models.dit import dit_forward as j_dit_forward
from repro.models.dit import init_dit as j_init_dit
from repro.serving.sampler import SamplerConfig as JSampler
from repro.serving.sampler import sample_step as j_sample_step
from repro_torch.configs import get_reduced
from repro_torch.core import SPConfig
from repro_torch.kernels import flash_mqkv as fm
from repro_torch.launch import make_mesh
from repro_torch.models import ParallelContext, dit_forward, init_dit, load_jax_params
from repro_torch.serving import (DiTRequest, DiTServer, SamplerConfig, sample,
                                 sample_step)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setup(mesh1):
    cfg = dataclasses.replace(get_reduced("flux-12b"), dtype="float32")
    jcfg = dataclasses.replace(j_get_reduced("flux-12b"), dtype="float32")
    params, _ = j_init_dit(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(0)
    for name in ("ada_f", "proj_out"):
        w = tree[name]["w"]
        tree[name]["w"] = (rng.standard_normal(w.shape) * w.shape[0] ** -0.5
                           ).astype(np.float32)
    w = tree["layers"]["ada"]["w"]  # [n_layers, d, 6d]
    tree["layers"]["ada"]["w"] = (rng.standard_normal(w.shape)
                                  * w.shape[1] ** -0.5).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    jctx = JCtx(mesh1, JSP(strategy="full"), "prefill")
    tparams = load_jax_params(tree, cfg, device="cpu")
    tctx = ParallelContext(SPConfig(strategy="full"), device=CPU)
    return cfg, jcfg, jparams, jctx, tparams, tctx


def test_init_dit_mirrors_reference_structure(setup):
    cfg, jcfg, jparams, *_ = setup
    mine = init_dit(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert len(mine["layers"]) == cfg.n_layers
    ref = jax.tree.map(lambda a: tuple(a.shape), jparams)
    layer_shapes = jax.tree.map(lambda s: s[1:], ref.pop("layers"),
                                is_leaf=lambda x: isinstance(x, tuple))
    got = jax.tree.map(lambda t: tuple(t.shape), {
        k: v for k, v in mine.items() if k != "layers"})
    assert got == ref
    for lp in mine["layers"]:
        assert jax.tree.map(lambda t: tuple(t.shape), lp) == layer_shapes
        assert torch.all(lp["ada"]["w"] == 0)
    assert torch.all(mine["proj_out"]["w"] == 0)


def test_dit_forward_matches_reference(setup):
    cfg, jcfg, jparams, jctx, tparams, tctx = setup
    rng = np.random.default_rng(1)
    latents = rng.standard_normal((2, 16, 64)).astype(np.float32)
    cond = rng.standard_normal((2, 256, cfg.d_model)).astype(np.float32)
    t = np.array([0.3, 0.8], np.float32)
    want = j_dit_forward(jparams, jcfg, jctx, latents=jnp.asarray(latents),
                         cond=jnp.asarray(cond), timesteps=jnp.asarray(t))
    got = dit_forward(tparams, cfg, tctx, latents=torch.from_numpy(latents),
                      cond=torch.from_numpy(cond), timesteps=torch.from_numpy(t))
    assert float(np.abs(np.asarray(want)).max()) > 1e-2  # not vacuous
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("sc_kw", [
    dict(),
    dict(guidance_scale=2.5),
    dict(cfg_weights=(1.5, -0.5)),
    dict(guidance_scale=2.5, cfg_parallel=True),
])
def test_sample_step_matches_reference(setup, sc_kw):
    cfg, jcfg, jparams, jctx, tparams, tctx = setup
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    cond = rng.standard_normal((2, 256, cfg.d_model)).astype(np.float32)
    want = j_sample_step(jparams, jcfg, jctx, jnp.asarray(x), jnp.asarray(cond),
                         jnp.float32(0.75), 0.25, JSampler(num_steps=4, **sc_kw))
    got = sample_step(tparams, cfg, tctx, torch.from_numpy(x),
                      torch.from_numpy(cond), 0.75, 0.25,
                      SamplerConfig(num_steps=4, **sc_kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_sample_loop_matches_reference_steps(setup):
    """sample() draws its noise from the generator, runs Euler steps equal
    to the reference's sample_step loop, times each step, and stops early
    when interrupted."""
    cfg, jcfg, jparams, jctx, tparams, tctx = setup
    cond = torch.zeros((1, 256, cfg.d_model))
    gen = lambda: torch.Generator().manual_seed(7)
    metrics = []
    x = sample(tparams, cfg, tctx, generator=gen(), batch=1, seq_len=16,
               cond=cond, sc=SamplerConfig(num_steps=2), metrics=metrics)
    assert [m["step"] for m in metrics] == [0, 1]
    assert all(m["t_step_s"] > 0 for m in metrics)
    xj = jnp.asarray(torch.randn((1, 16, 64), generator=gen()).numpy())
    for i in range(2):
        xj = j_sample_step(jparams, jcfg, jctx, xj, jnp.asarray(cond.numpy()),
                           jnp.float32(1.0 - i * 0.5), 0.5, JSampler(num_steps=2))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-4, atol=1e-4)
    stopped = sample(tparams, cfg, tctx, generator=gen(), batch=1, seq_len=16,
                     cond=cond, sc=SamplerConfig(num_steps=2),
                     interrupt=lambda i: i == 0)
    assert not torch.equal(stopped, x)


def _serve(cfg, tparams):
    srv = DiTServer(tparams, cfg, SPConfig(strategy="full"),
                    sampler=SamplerConfig(num_steps=3), max_batch=4,
                    device="cpu")
    for rid, seq in ((0, 16), (1, 16), (2, 32)):
        srv.submit(DiTRequest(rid=rid, seq_len=seq))
    return srv, {r.rid: r for r in srv.serve()}


def test_served_slice_matches_reference_sample_loop(setup):
    cfg, jcfg, jparams, jctx, tparams, tctx = setup
    fm.reset_launch_count()
    srv, out = _serve(cfg, tparams)
    assert sorted(out) == [0, 1, 2]
    # two buckets, one step-function build each, no CUDA launch on the CPU
    assert srv.scheduler.admissions == 2
    assert srv.plan_cache.traces == 2 and srv.plan_cache.hits == 0
    assert fm.launch_count() == 0
    dt = 1.0 / 3
    for rid, r in out.items():
        seq = 16 if rid < 2 else 32
        assert r.latents.shape == (seq, 64) and r.sampling_steps == 3
        x = jnp.asarray(srv._noise([DiTRequest(rid=rid, seq_len=seq)], 1,
                                   seq).numpy())
        cond = jnp.zeros((1, 256, cfg.d_model), jnp.float32)
        for i in range(3):
            x = j_sample_step(jparams, jcfg, jctx, x, cond,
                              jnp.float32(1.0 - i * dt), dt,
                              JSampler(num_steps=3))
        assert float(jnp.abs(x[0] - jnp.asarray(
            srv._noise([DiTRequest(rid=rid, seq_len=seq)], 1, seq)[0].numpy())
        ).max()) > 1e-3
        np.testing.assert_allclose(r.latents.numpy(), np.asarray(x[0]),
                                   rtol=1e-4, atol=1e-4)
    # a rerun of the same requests is bitwise equal (noise per rid)
    _, again = _serve(cfg, tparams)
    for rid in out:
        assert torch.equal(again[rid].latents, out[rid].latents)


def test_entry_points_need_cuda_unless_asked_for_cpu(setup):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    cfg, *_, tparams, _ = setup
    with pytest.raises(RuntimeError, match="CUDA"):
        DiTServer(tparams, cfg, SPConfig(strategy="full"))
    with pytest.raises(RuntimeError, match="CUDA"):
        init_dit(cfg)


def test_multi_rank_strategies_not_ported_yet(setup):
    """The flat multi-rank schedules are ported (tests/test_torch_sp.py),
    and so is a batch axis of size > 1 on the mesh: each data slice of the
    batch runs swift_torus on its own model ranks, and the DiT's output is
    the single-rank one.  The hierarchical all-to-all is ported too
    (tests/test_torch_hier.py)."""
    cfg, *_, tparams, tctx = setup
    SPConfig(strategy="swift_torus", hier_a2a=True)
    ctx = dataclasses.replace(
        tctx, sp=SPConfig(strategy="swift_torus"),
        mesh=make_mesh((2, 2), ("data", "model"), device="cpu"))
    assert ctx.sp_degree == 2
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 16, 64)).astype(np.float32))
    cond = torch.from_numpy(
        rng.standard_normal((2, 256, cfg.d_model)).astype(np.float32))
    t = torch.tensor([0.3, 0.8])
    want = dit_forward(tparams, cfg, tctx, latents=x, cond=cond, timesteps=t)
    got = dit_forward(tparams, cfg, ctx, latents=x, cond=cond, timesteps=t)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_rope_table_is_the_rounded_float64_table():
    """The rope table is float64 rounded once to f32, bit for bit, at the
    served lengths: it cannot depend on a device's own f32 pow and sin,
    whose last-ulp differences grow with the position (~1e-4 rad at
    position 1000) and which peaked attention amplifies."""
    from repro_torch.models.blocks import _rope_angles
    rot, theta = 128, 10000.0
    pos = torch.arange(4352)[None]
    sin, cos = _rope_angles(pos, rot, theta)
    freqs = (theta ** (-np.arange(0, rot, 2) / rot)).astype(np.float32)
    ang = (np.arange(4352, dtype=np.float32)[:, None] * freqs).astype(np.float64)
    assert sin.dtype == cos.dtype == torch.float32
    np.testing.assert_array_equal(sin[0].numpy(), np.sin(ang).astype(np.float32))
    np.testing.assert_array_equal(cos[0].numpy(), np.cos(ang).astype(np.float32))
