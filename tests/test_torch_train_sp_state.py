"""Training over a mesh of virtual ranks for the families whose transfers
go beyond SP attention, on the CPU: rwkv6 (the token shifts and the
distributed WKV state pass), hymba (those of the SSD branch beside SP
attention), the MoE (the expert-parallel exchange) and whisper
(cross-attention under SP, Lq != Lk).

* ``sp_attention`` with Lq != Lk (cross-attention: Lq 16, Lk 48,
  non-causal, GQA) over (model 4) and (pod 2, model 2), for every
  strategy it dispatches and both comm backends: the output and the q, k
  and v gradients against degree 1 within 1e-5 of their max|.|.  Before
  the K/V positions were taken from the K/V shard's own length, this
  raised a shape error in the plain attention's mask.
* Reduced rwkv6-1.6b, hymba-1.5b, qwen2-moe-a2.7b and whisper-tiny
  (float32) over (pod 2, model 2), rwkv6 and the MoE also over (data 2,
  model 2), comm backend "pallas" (on the CPU the put kernels' plain
  versions), against three oracles:
  (a) the reference's degree-1 ``jax.value_and_grad`` on a 1 x 1 mesh of
      Auto axes (ROADMAP F2);
  (b) the reference's own swift_torus gradient over the same mesh on 8
      fake devices (Auto axes, comm backend "xla"), run once, in one
      subprocess for the file;
  (c) the port's own degree 1.
  The loss within 5e-4 (the reference's SP tolerance) of each; every
  gradient within GRAD_TOL (1e-4) of each leaf's max|grad| against (b),
  and against (a) and (c) within the bound that the reference meets
  itself on the same inputs: the test asserts that the reference's own
  gap, (b) against (a), lies under it.  A leaf whose max|grad| is under
  1e-8 (whisper's K biases: zero in exact arithmetic) is compared
  absolutely.  The MoE runs at capacity 8 (nothing dropped, as the
  reference's test_moe_a2a_matches_single) against all three, and at the
  config's own capacity against (b), where both sides drop the same
  tokens; without its load-balance loss (averaged over the ranks' shards
  over a mesh) it equals the port's degree 1 within 1e-5.
"""
import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.core import SPConfig as JSP
from repro.models import ParallelContext as JCtx
from repro.models import get_model as j_get_model
from repro_torch.configs.shapes import InputShape
from repro_torch.core import sp_attention
from repro_torch.kernels import flash_attention
from repro_torch.models import ParallelContext, get_model
from repro_torch.models.blocks import params_from_numpy
from repro_torch.train import SyntheticStream
from repro_torch.train.optimizer import tree_leaves
from test_torch_rwkv import perturb_zero_init
from test_torch_train import GRAD_TOL, SHAPE, SP1, T, _cfgs, _perturb, _rel
from test_torch_train_sp import (MESHES, SP_GRAD_TOL, SP_LOSS_TOL,
                                 STRATEGIES, _mesh, _one_thread, _sp_cfg)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TINY = 1e-8  # a leaf under this max|grad| is compared absolutely
# the bound each family's SP gradient meets against degree 1, the
# reference's own gap under it (of each leaf's max|grad|)
SELF_BOUND = {"rwkv6-1.6b": 1e-4, "hymba-1.5b": 1e-4, "whisper-tiny": 1e-4,
              "qwen2-moe-a2.7b": 2e-3}
NO_DROP = 8.0  # a capacity factor that drops no token
# (arch, mesh, capacity factor or None for the config's own)
CASES = {
    "rwkv6-pod2-model2": ("rwkv6-1.6b", "pod2-model2", None),
    "rwkv6-data2-model2": ("rwkv6-1.6b", "data2-model2", None),
    "hymba-pod2-model2": ("hymba-1.5b", "pod2-model2", None),
    "whisper-pod2-model2": ("whisper-tiny", "pod2-model2", None),
    "moe-pod2-model2": ("qwen2-moe-a2.7b", "pod2-model2", NO_DROP),
    "moe-data2-model2": ("qwen2-moe-a2.7b", "data2-model2", NO_DROP),
    "moe-pod2-model2-own-capacity": ("qwen2-moe-a2.7b", "pod2-model2", None),
}
assert _one_thread  # the module-level one-thread fixture, used here too


# ---------------------------------------------------------------------------
# SP attention with Lq != Lk
# ---------------------------------------------------------------------------

def _cross_inputs(seed=5):
    """B 2, Lq 16 against Lk 48, Hq 8 over Hkv 2 (GQA 4), D 8; q, k, v and
    dO."""
    rng = np.random.default_rng(seed)
    shapes = ((2, 16, 8, 8), (2, 48, 2, 8), (2, 48, 2, 8), (2, 16, 8, 8))
    return [T(rng.standard_normal(s).astype(np.float32)) for s in shapes]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("mesh_name", ["model4", "pod2-model2"])
@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_cross_attention_over_a_mesh_matches_degree_1(strategy, mesh_name,
                                                      backend):
    q, k, v, do = _cross_inputs()
    cfg = _sp_cfg(mesh_name, *STRATEGIES[strategy], backend=backend)
    mesh = _mesh(mesh_name)
    runs = []
    for fn in (lambda a, b, c: sp_attention(a, b, c, cfg=cfg, mesh=mesh),
               flash_attention):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*ins)
        runs.append((o.detach(), torch.autograd.grad(o, ins, do)))
    (o, got), (o1, want) = runs
    assert o.shape == o1.shape
    assert _rel(o.numpy(), o1.numpy()) < SP_GRAD_TOL
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g.numpy(), w.numpy()) < SP_GRAD_TOL


# ---------------------------------------------------------------------------
# the four families over a mesh against the reference
# ---------------------------------------------------------------------------

_JAX_SP = """
import dataclasses, pickle, sys
import jax, numpy as np
from jax.sharding import AxisType
from repro.configs import get_reduced
from repro.core import SPConfig
from repro.models import ParallelContext, get_model
MESHES = %r
out = {}
for key, (arch, mesh_name, cap, tree, batch) in pickle.load(
        open(sys.argv[1], "rb")).items():
    shape, axes, sp_axes, batch_axes = MESHES[mesh_name]
    mesh = jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * 2)
    sp = SPConfig(strategy="swift_torus", sp_axes=sp_axes,
                  batch_axes=batch_axes, machine_axis="pod",
                  comm_backend="xla")
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32",
                              sharding_overrides=())
    if cap is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cap))
    b = get_model(cfg)
    ctx = ParallelContext(mesh, sp, "train")
    p = jax.tree.map(jax.numpy.asarray, tree)
    jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    (loss, _), g = jax.jit(jax.value_and_grad(
        lambda p: b.loss(p, jb, cfg, ctx), has_aux=True))(p)
    out[key] = (float(loss), jax.tree.map(np.asarray, g))
pickle.dump(out, open(sys.argv[2], "wb"))
""" % ({k: MESHES[k] for k in ("pod2-model2", "data2-model2")},)


def _with_capacity(cfg, cap):
    if cap is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cap))


def _case_inputs(arch):
    """The reference's parameter tree (constant leaves drawn, the rwkv6
    decays from RWKV6's range) and the batch, as
    test_torch_train_lm.py's ``check_arch_against_reference`` draws
    them."""
    cfg, jcfg = _cfgs(arch)
    params, _ = j_get_model(jcfg).init(jcfg, jax.random.PRNGKey(0), 1)
    tree = jax.tree.map(np.array, params)
    rng = np.random.default_rng(sum(map(ord, arch)))
    _perturb(tree, rng)
    if cfg.family == "ssm":
        perturb_zero_init(tree, rng)
    batch = SyntheticStream(cfg, InputShape("t", *SHAPE, "training"),
                            seed=3).batch_numpy(0)
    return tree, batch


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Per case: the port's config, the tree, the batch and the
    reference's (loss, gradient tree) at degree 1 on a 1 x 1 Auto-axis
    mesh (in process, once per (arch, capacity)) and over the case's mesh
    on 8 fake devices (one subprocess for every case)."""
    mesh1 = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(AxisType.Auto,) * 2)
    jctx = JCtx(mesh1, JSP(strategy="full", sp_axes=("model",),
                           batch_axes=("data",)), "train")
    inputs = {arch: _case_inputs(arch) for arch, _, _ in CASES.values()}
    deg1, cases, out = {}, {}, {}
    for key, (arch, mesh_name, cap) in CASES.items():
        tree, batch = inputs[arch]
        cfg, jcfg = (_with_capacity(c, cap) for c in _cfgs(arch))
        if (arch, cap) not in deg1:
            jb = j_get_model(jcfg)
            jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
            (loss, _), grads = jax.jit(jax.value_and_grad(
                lambda p: jb.loss(p, jbatch, jcfg, jctx), has_aux=True))(
                    jax.tree.map(jnp.asarray, tree))
            deg1[arch, cap] = (float(loss), jax.tree.map(np.asarray, grads))
        cases[key] = (arch, mesh_name, cap, tree, batch)
        out[key] = dict(cfg=cfg, tree=tree, batch=batch, mesh=mesh_name,
                        deg1=deg1[arch, cap])
    tmp = tmp_path_factory.mktemp("jax_sp_state")
    src, dst = tmp / "in.pkl", tmp / "out.pkl"
    src.write_bytes(pickle.dumps(cases))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_SP, str(src), str(dst)],
                          env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for key, sp in pickle.loads(dst.read_bytes()).items():
        out[key]["sp"] = sp
    return out


def port_loss_and_grads(cfg, tree, batch, mesh_name=None, backend="pallas"):
    """The port's loss and gradients (every leaf, tree order) of ``cfg``
    on the numpy ``tree`` and ``batch``: over ``mesh_name`` under
    swift_torus, or at degree 1 when it is None."""
    params = params_from_numpy(tree, cfg, CPU)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    if mesh_name is None:
        ctx = ParallelContext(SP1, "train", device=CPU)
    else:
        ctx = ParallelContext(_sp_cfg(mesh_name, backend=backend), "train",
                              mesh=_mesh(mesh_name))
    loss, _ = get_model(cfg).loss(params, {k: T(v) for k, v in batch.items()},
                                  cfg, ctx)
    return float(loss.detach()), torch.autograd.grad(loss,
                                                     tree_leaves(params))


def grad_gap(cfg, grads, want) -> float:
    """The largest gap over leaves of max|Δ| / max|want| between two
    gradient lists (``want`` a list of tensors or a numpy tree); a leaf
    whose max|want| is under TINY must agree within TINY absolutely."""
    if isinstance(want, dict):
        want = tree_leaves(params_from_numpy(want, cfg, CPU))
    assert len(grads) == len(want)
    worst = 0.0
    for g, w in zip(grads, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape and np.isfinite(g).all()
        if np.abs(w).max() < TINY:
            assert np.abs(g - w).max() <= TINY
            continue
        worst = max(worst, _rel(g, w))
    return worst


@pytest.mark.parametrize("case", list(CASES))
def test_family_gradients_over_a_mesh_match_reference(case, reference):
    r = reference[case]
    arch, mesh_name, cap = CASES[case]
    cfg = r["cfg"]
    loss, grads = port_loss_and_grads(cfg, r["tree"], r["batch"], mesh_name)
    (loss_a, grads_a), (loss_b, grads_b) = r["deg1"], r["sp"]
    assert np.isfinite([loss, loss_a, loss_b]).all()
    assert _rel(loss, loss_b) < SP_LOSS_TOL
    assert grad_gap(cfg, grads, grads_b) < GRAD_TOL  # (b)
    if cap is None and cfg.family == "moe":
        return  # the config's capacity drops tokens unlike degree 1
    bound = SELF_BOUND[arch]
    ref_gap = grad_gap(cfg, tree_leaves(params_from_numpy(grads_b, cfg, CPU)),
                       grads_a)
    assert ref_gap < bound  # the yardstick: the reference's own gap
    loss_c, grads_c = port_loss_and_grads(cfg, r["tree"], r["batch"])
    for want_loss, want in ((loss_a, grads_a), (loss_c, grads_c)):  # (a), (c)
        assert _rel(loss, want_loss) < SP_LOSS_TOL
        assert grad_gap(cfg, grads, want) < bound
    print(f"{case}: gap vs (a) {grad_gap(cfg, grads, grads_a):.2e}, (b) "
          f"{grad_gap(cfg, grads, grads_b):.2e}, (c) "
          f"{grad_gap(cfg, grads, grads_c):.2e}; reference (b) vs (a) "
          f"{ref_gap:.2e} (bound {bound})")


@pytest.mark.parametrize("mesh_name", ["pod2-model2", "data2-model2"])
def test_moe_without_load_balance_loss_matches_degree_1(mesh_name):
    """The MoE's gap to degree 1 is its load-balance loss, which over a
    mesh is averaged over the ranks' shards (the reference's pmean): with
    that loss's weight at 0 and a capacity that drops nothing, the loss
    and every gradient over the mesh equal degree 1's within SP_GRAD_TOL
    (the bound chip_smoke.py's train-sp-families phase holds the card
    to, at full width)."""
    arch = "qwen2-moe-a2.7b"
    tree, batch = _case_inputs(arch)
    cfg = _with_capacity(_cfgs(arch)[0], NO_DROP)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, router_aux_coef=0.0))
    loss1, want = port_loss_and_grads(cfg, tree, batch)
    loss, got = port_loss_and_grads(cfg, tree, batch, mesh_name)
    assert _rel(loss, loss1) < SP_GRAD_TOL
    assert grad_gap(cfg, got, want) < SP_GRAD_TOL
