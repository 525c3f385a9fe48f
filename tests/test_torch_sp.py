"""The port's SP strategies on a mesh of virtual ranks, on the CPU, against
the reference.

* Attention: the examples/quickstart.py problem (B 2, L 64, Hq 8 / Hkv 4,
  D 32, causal) on mesh (pod 2, model 4) with sp_axes (pod, model), so
  that swift_torus plans P_u 4 x P_r 2 and runs the fused ring path's K2
  at every ring step but the last.  Every strategy, with both comm
  backends, is held at 1e-4 to the reference's ``reference_attention`` on
  the same numpy inputs, and to the reference's own ``sp_attention`` over
  8 fake devices (one subprocess for the whole file).  Ulysses needs
  SP (8) | heads, so it runs with ``replicate_kv`` (Hq 8), in both
  packages.
* The DiT: ``dit_forward`` on ``get_reduced("flux-12b")`` with perturbed
  weights and two distinct timesteps, under swift_torus on that mesh,
  against the reference's ``dit_forward`` at degree 1, at 1e-5.  Dropping
  one KV chunk of one Pull-KV stage breaks that by orders of magnitude.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.core import MaskSpec as JMask
from repro.core import SPConfig as JSP
from repro.core import reference_attention as j_reference
from repro.models import ParallelContext as JCtx
from repro.models.dit import dit_forward as j_dit_forward
from repro.models.dit import init_dit as j_init_dit
from repro_torch.comm import kernel_backend as kb
from repro_torch.configs import get_reduced
from repro_torch.core import SPConfig, sp_attention
from repro_torch.core import torus as t_torus
from repro_torch.core.softmax import empty_partial
from repro_torch.core.strategy import resolve_layout
from repro_torch.kernels import flash_mqkv as fm
from repro_torch.kernels import ring_flash as rf
from repro_torch.launch import make_mesh
from repro_torch.models import ParallelContext, dit_forward, load_jax_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
SP_TOL = 1e-4  # tests/multidevice/test_sp_strategies.py
DIT_TOL = 1e-5  # tests/test_torch_dit.py
STRATEGIES = ["full", "ring", "ulysses", "usp", "swift", "swift_torus"]
BACKENDS = ["xla", "pallas"]
MESH = ((2, 4), ("pod", "model"))


def _qkv():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((2, 64, 8, 32)).astype(np.float32),
            rng.standard_normal((2, 64, 4, 32)).astype(np.float32),
            rng.standard_normal((2, 64, 4, 32)).astype(np.float32))


def _cfg(strategy, backend):
    return SPConfig(strategy=strategy, sp_axes=("pod", "model"),
                    batch_axes=None, comm_backend=backend,
                    replicate_kv=strategy == "ulysses")


_JAX_SP = """
import numpy as np, jax
from repro.core import SPConfig, sp_attention
d = np.load({inputs!r})
mesh = jax.make_mesh({shape!r}, {axes!r})
out = {{}}
for strategy in {strategies!r}:
    for backend in {backends!r}:
        cfg = SPConfig(strategy=strategy, sp_axes=("pod", "model"),
                       batch_axes=None, comm_backend=backend,
                       replicate_kv=strategy == "ulysses")
        f = jax.jit(lambda q, k, v: sp_attention(q, k, v, mesh=mesh, cfg=cfg,
                                                 causal=True))
        out[strategy + "/" + backend] = np.asarray(f(d["q"], d["k"], d["v"]))
np.savez({outputs!r}, **out)
"""


@pytest.fixture(scope="module")
def jax_sp(tmp_path_factory):
    """The reference's sp_attention for every strategy and backend, over 8
    fake devices, in one subprocess (the outer run keeps one device)."""
    tmp = tmp_path_factory.mktemp("jax_sp")
    q, k, v = _qkv()
    np.savez(tmp / "in.npz", q=q, k=k, v=v)
    code = _JAX_SP.format(inputs=str(tmp / "in.npz"),
                          outputs=str(tmp / "out.npz"), shape=MESH[0],
                          axes=MESH[1], strategies=STRATEGIES[1:],
                          backends=BACKENDS)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategy_matches_reference(strategy, backend, jax_sp):
    q, k, v = _qkv()
    want = np.asarray(j_reference(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), mask=JMask(causal=True)))
    mesh = make_mesh(*MESH, device="cpu")
    cfg = _cfg(strategy, backend)
    fm.reset_launch_count()
    rf.reset_launch_count()
    got = sp_attention(*(torch.from_numpy(x) for x in (q, k, v)), cfg=cfg,
                       mesh=mesh, causal=True).numpy()
    np.testing.assert_allclose(got, want, rtol=SP_TOL, atol=SP_TOL)
    if strategy != "full":
        np.testing.assert_allclose(got, jax_sp[f"{strategy}/{backend}"],
                                   rtol=SP_TOL, atol=SP_TOL)
    # the CPU runs the kernels' plain versions: nothing launches
    assert fm.launch_count() == rf.launch_count() == 0


def test_planned_layouts():
    """swift_torus reaches a ring of 2 on the test mesh (so K2 runs), and
    flux-12b's 24 heads plan P_u 8 x P_r 2 on both meshes of the card."""
    lay = resolve_layout(_cfg("swift_torus", "pallas"),
                         make_mesh(*MESH, device="cpu"), 8, 4)
    assert (lay.p_ulysses, lay.p_ring) == (4, 2)
    for shape, axes, sp_axes in (((2, 8), ("pod", "model"), ("pod", "model")),
                                 ((16,), ("model",), ("model",))):
        cfg = SPConfig(strategy="swift_torus", sp_axes=sp_axes)
        lay = resolve_layout(cfg, make_mesh(shape, axes, device="cpu"), 24, 24)
        assert (lay.p_ulysses, lay.p_ring, lay.ulysses_outer) == (8, 2, True)


def test_ulysses_needs_sp_to_divide_heads():
    """As in the reference (strategy.py:131): without replicate_kv, SP 8
    does not divide gcd(Hq, Hkv) = 4."""
    mesh = make_mesh(*MESH, device="cpu")
    q, k, v = (torch.from_numpy(x) for x in _qkv())
    cfg = SPConfig(strategy="ulysses", sp_axes=("pod", "model"))
    with pytest.raises(ValueError, match="ulysses needs"):
        sp_attention(q, k, v, cfg=cfg, mesh=mesh, causal=True)


@pytest.mark.parametrize("backend", BACKENDS)
def test_mesh_shape_rules(backend):
    """A data axis of size 2 splits the batch into two slices, each running
    swift_torus (P_u 4 x P_r 2) on its own eight ranks, every put covering
    both slices: the result is the reference's oracle at SP_TOL, and the
    signal word of every one of the 16 ranks is set.  What shard_map cannot split
    raises."""
    q, k, v = (torch.from_numpy(x) for x in _qkv())
    want = np.asarray(j_reference(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                                  mask=JMask(causal=True)))
    cfg = SPConfig(strategy="swift_torus", sp_axes=("pod", "model"),
                   batch_axes=("data",), comm_backend=backend)
    mesh = make_mesh((2, 2, 4), ("pod", "data", "model"), device="cpu")
    heap = kb.heap_for(torch.device("cpu"))
    heap.signals.zero_()
    got = sp_attention(q, k, v, cfg=cfg, causal=True, mesh=mesh).numpy()
    np.testing.assert_allclose(got, want, rtol=SP_TOL, atol=SP_TOL)
    if backend == "pallas":
        for row in ("fused", "landing_copy"):
            assert int(heap.words(row, 0, 16)[0].min()) > 0
    with pytest.raises(ValueError, match="batch 1 does not split"):
        sp_attention(q[:1], k[:1], v[:1], cfg=cfg, causal=True, mesh=mesh)
    with pytest.raises(ValueError, match="split evenly"):
        sp_attention(q[:, :60], k[:, :60], v[:, :60], cfg=cfg, causal=True,
                     mesh=mesh)


# ---------------------------------------------------------------------------
# the DiT under swift_torus against the reference at degree 1
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dit(mesh1):
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
    rng = np.random.default_rng(1)
    inputs = dict(
        latents=rng.standard_normal((2, 16, 64)).astype(np.float32),
        cond=rng.standard_normal((2, 256, cfg.d_model)).astype(np.float32),
        timesteps=np.array([0.3, 0.8], np.float32))
    jctx = JCtx(mesh1, JSP(strategy="full"), "prefill")
    want = np.asarray(j_dit_forward(
        jax.tree.map(jnp.asarray, tree), jcfg, jctx,
        **{k: jnp.asarray(x) for k, x in inputs.items()}))
    assert float(np.abs(want).max()) > 1e-2  # not vacuous
    return cfg, load_jax_params(tree, cfg, device="cpu"), inputs, want


def _dit_sp(cfg, params, inputs, backend="pallas"):
    mesh = make_mesh(*MESH, device="cpu")
    sp = SPConfig(strategy="swift_torus", sp_axes=("pod", "model"),
                  comm_backend=backend, kernel_interpret=False)
    ctx = ParallelContext(sp, mesh=mesh)
    assert ctx.sp_degree == 8 and ctx.device == mesh.device
    return dit_forward(params, cfg, ctx,
                       **{k: torch.from_numpy(x) for k, x in inputs.items()}
                       ).numpy()


@pytest.mark.parametrize("backend", BACKENDS)
def test_dit_forward_under_swift_torus_matches_reference(dit, backend):
    cfg, params, inputs, want = dit
    heap = kb.heap_for(torch.device("cpu"))
    heap.signals.zero_()
    got = _dit_sp(cfg, params, inputs, backend)
    np.testing.assert_allclose(got, want, rtol=DIT_TOL, atol=DIT_TOL)
    if backend == "pallas":
        # the fused ring puts and the (multi-axis) landing copies signalled
        for row in ("fused", "landing_copy"):
            assert int(heap.words(row, 0, 8)[0].min()) > 0


def test_one_dropped_kv_chunk_breaks_parity(dit, monkeypatch):
    """Drop the first Pull-KV stage's chunk of one layer: the output moves
    by far more than the parity tolerance, so the comparison above (and
    chip_smoke.py's, which holds the card to the same kind of limit)
    would catch a lost put."""
    cfg, params, inputs, want = dit
    real = t_torus.ring_attention
    calls = []

    def dropping(q, *args, **kw):
        parts = real(q, *args, **kw)
        calls.append(len(calls))
        if len(calls) == 5:  # stage 0, 3 Pull-Q, then the first Pull-KV
            return [empty_partial(*x.shape, device=x.device) for x in q]
        return parts

    monkeypatch.setattr(t_torus, "ring_attention", dropping)
    got = _dit_sp(cfg, params, inputs)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel > 1e3 * DIT_TOL, rel


def test_ring_path_hands_kernels_unpadded_shards(monkeypatch):
    """The fused ring path gives K1 and K2 the shard's own Lk (136 here,
    not a multiple of the old 128-row padding) and the real positions,
    and swift_torus still matches the reference's oracle at SP_TOL."""
    from repro_torch.core import ring as t_ring
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((1, 1088, h, 32)).astype(np.float32)
               for h in (8, 4, 4))
    shapes = []

    def recording(kernel):
        def call(q_, k_, v_, q_pos, k_pos, **kw):
            assert q_pos.shape[0] == q_.shape[1]
            assert k_pos.shape[0] == k_.shape[1] and bool((k_pos >= 0).all())
            shapes.append((kernel.__name__, q_.shape[1], k_.shape[1]))
            return kernel(q_, k_, v_, q_pos, k_pos, **kw)
        return call

    monkeypatch.setattr(t_ring, "flash_mqkv", recording(t_ring.flash_mqkv))
    monkeypatch.setattr(t_ring, "ring_flash_step",
                        recording(t_ring.ring_flash_step))
    got = sp_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                       cfg=_cfg("swift_torus", "pallas"), causal=True,
                       mesh=make_mesh(*MESH, device="cpu")).numpy()
    want = np.asarray(j_reference(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), mask=JMask(causal=True)))
    np.testing.assert_allclose(got, want, rtol=SP_TOL, atol=SP_TOL)
    names = {name for name, _, _ in shapes}
    assert names == {"flash_mqkv", "ring_flash_step"}
    shard = 1088 // 8
    assert shard % 128 and all(lk == shard for _, _, lk in shapes)
    assert all(lq % shard == 0 for _, lq, _ in shapes)
