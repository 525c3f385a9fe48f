"""Training over a mesh of virtual ranks, on the CPU: the gradient of the
SP attention schedule (core/sp_grad.py ``SPAttention``) and the
attention-only families trained over a mesh.

* ``sp_attention``'s gradient in q, k and v over a mesh against degree 1
  (the flash_mqkv Function), float32, within 1e-5 of each gradient's
  max|grad|, for every strategy it dispatches (swift_torus with the fused
  Pull-Q off and on, swift, usp, ring, ulysses), on meshes (model 4),
  (pod 2, model 2) and (data 2, model 2), causal and unmasked, with GQA,
  through both comm backends (on the CPU "pallas" runs the
  kernels' plain versions); the output with a gradient is bitwise the
  output without one;
* K1b's plain version writes zeros for a KV chunk that the mask hides
  from every row, as a ring step meets it (the kernel's counterpart is
  tests/test_torch_kernels_cuda.py's);
* dropping one ring step's (dK, dV) breaks that parity;
* reduced qwen2-1.5b, qwen2-vl-2b and flux-12b over (pod 2, model 2)
  (qwen2 also through the "xla" backend and over (data 2, model 2)): the
  loss and every parameter
  gradient against the reference's degree-1 ``jax.value_and_grad`` on a
  1 x 1 mesh of Auto axes (loss 5e-4, the reference's own SP tolerance,
  tests/multidevice/test_models_distributed.py; gradients
  tests/test_torch_train.py's 1e-4), and against the reference's own SP
  gradient over the same mesh on 8 fake devices (Auto axes, comm backend
  "xla": its "pallas" ring kernel has no differentiation rule), run once
  in one subprocess;
* remat "full" (each layer's forward, so the SP schedule, runs again in
  the backward) gives the gradients of remat "none" bit for bit;
* ``launch/train.py`` trains over ``--model 2``, ``--data 2`` and
  ``--mesh pod``.
"""
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
from repro_torch.core import SPConfig, sp_attention
from repro_torch.core import sp_grad
from repro_torch.core.strategy import resolve_layout
from repro_torch.kernels import flash_attention
from repro_torch.kernels.flash_mqkv import flash_mqkv_bwd, flash_mqkv_plain
from repro_torch.launch import make_mesh
from repro_torch.launch import train as launch_train
from repro_torch.models import ParallelContext, get_model
from repro_torch.models.blocks import params_from_numpy
from repro_torch.train import SyntheticStream
from repro_torch.train.optimizer import tree_leaves
from test_torch_train import (GRAD_TOL, SHAPE, T, _cfgs, _leaf_names,
                              _perturb, _rel)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SP_GRAD_TOL = 1e-5  # SP vs degree 1, f32, of each gradient's max|grad|
SP_LOSS_TOL = 5e-4  # tests/multidevice/test_models_distributed.py
# (mesh shape, axes, sp_axes, batch_axes)
MESHES = {
    "model4": ((4,), ("model",), ("model",), None),
    "pod2-model2": ((2, 2), ("pod", "model"), ("pod", "model"), None),
    "data2-model2": ((2, 2), ("data", "model"), ("model",), ("data",)),
}
# (strategy, torus_fused_pull_q)
STRATEGIES = {"swift_torus": ("swift_torus", False),
              "swift_torus-fused-q": ("swift_torus", True),
              "swift": ("swift", False), "usp": ("usp", False),
              "ring": ("ring", False), "ulysses": ("ulysses", False)}
MASKS = {"causal": (True, None), "none": (False, None)}
MODEL_ARCHS = ("qwen2-1.5b", "qwen2-vl-2b", "flux-12b")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs: its many small ops slow
    several-fold when the run's workers share the cores and every op
    starts a team of threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sp_cfg(mesh_name, strategy="swift_torus", fused=False, backend="pallas"):
    """ulysses needs SP | heads: it replicates KV (as tests/test_torch_sp.py
    runs it), a repeat that stays outside SPAttention."""
    _, _, sp_axes, batch_axes = MESHES[mesh_name]
    return SPConfig(strategy=strategy, sp_axes=sp_axes, batch_axes=batch_axes,
                    machine_axis="pod", comm_backend=backend,
                    torus_fused_pull_q=fused,
                    replicate_kv=strategy == "ulysses")


def _mesh(mesh_name):
    shape, axes, _, _ = MESHES[mesh_name]
    return make_mesh(shape, axes, device="cpu")


def _attention_inputs(seed=0):
    """B 2, L 16, Hq 8 over Hkv 2 (GQA 4), D 8 (so swift_torus, swift and
    usp plan P_u 2 x P_r 2 on 4 ranks); q, k, v and dO."""
    rng = np.random.default_rng(seed)
    shapes = ((2, 16, 8, 8), (2, 16, 2, 8), (2, 16, 2, 8), (2, 16, 8, 8))
    return [T(rng.standard_normal(s).astype(np.float32)) for s in shapes]


def _grads(fn, q, k, v, do):
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    o = fn(*ins)
    return o.detach(), torch.autograd.grad(o, ins, do)


# ---------------------------------------------------------------------------
# the gradient of sp_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_sp_attention_gradient_matches_degree_1(strategy, mesh_name, mask,
                                                backend):
    q, k, v, do = _attention_inputs()
    causal, window = MASKS[mask]
    cfg = _sp_cfg(mesh_name, *STRATEGIES[strategy], backend=backend)
    mesh = _mesh(mesh_name)
    sp = lambda a, b, c: sp_attention(a, b, c, cfg=cfg, mesh=mesh,
                                      causal=causal, window=window)
    o, got = _grads(sp, q, k, v, do)
    with torch.no_grad():
        assert torch.equal(o, sp(q, k, v))  # the same forward, bitwise
    _, want = _grads(lambda a, b, c: flash_attention(
        a, b, c, causal=causal, window=window), q, k, v, do)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert _rel(g.numpy(), w.numpy()) < SP_GRAD_TOL


def _graph_nodes(fn) -> set:
    """The class names of the autograd graph's nodes under ``fn``."""
    seen, todo = {}, [fn]
    while todo:
        f = todo.pop()
        if f is not None and id(f) not in seen:
            seen[id(f)] = type(f).__name__
            todo += [g for g, _ in f.next_functions]
    return set(seen.values())


def test_sp_attention_goes_through_the_function_only_under_grad():
    q, k, v, do = _attention_inputs(1)
    cfg, mesh = _sp_cfg("pod2-model2"), _mesh("pod2-model2")
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    o = sp_attention(*ins, cfg=cfg, mesh=mesh, causal=True)
    assert "SPAttentionBackward" in _graph_nodes(o.grad_fn)
    with torch.no_grad():
        assert sp_attention(*ins, cfg=cfg, mesh=mesh).grad_fn is None


def test_one_dropped_ring_step_breaks_the_gradient(monkeypatch):
    """Zeroing the (dK, dV) that step 1 of every ring backward adds (the
    share the returning put carries home) moves dK and dV far off."""
    q, k, v, do = _attention_inputs(2)
    cfg, mesh = _sp_cfg("pod2-model2"), _mesh("pod2-model2")
    layout = resolve_layout(cfg, mesh, q.shape[2], k.shape[2])
    real, calls = sp_grad.flash_mqkv_bwd, [0]
    ranks, p_r = layout.size, layout.p_ring
    assert (layout.p_ulysses, p_r) == (2, 2)

    def dropping(*args, **kw):
        dq, dk, dv = real(*args, **kw)
        step = calls[0] // ranks % p_r
        calls[0] += 1
        if step == 1:
            return dq, torch.zeros_like(dk), torch.zeros_like(dv)
        return dq, dk, dv

    monkeypatch.setattr(sp_grad, "flash_mqkv_bwd", dropping)
    _, got = _grads(lambda a, b, c: sp_attention(a, b, c, cfg=cfg, mesh=mesh),
                    q, k, v, do)
    monkeypatch.undo()
    _, want = _grads(lambda a, b, c: flash_attention(a, b, c), q, k, v, do)
    assert calls[0] == ranks * p_r
    assert _rel(got[0].numpy(), want[0].numpy()) < SP_GRAD_TOL  # dq intact
    for g, w in zip(got[1:], want[1:]):
        assert _rel(g.numpy(), w.numpy()) > 1e-2


def _hidden_chunk(dtype=torch.float32, device="cpu", seed=3):
    """q rows at positions 16..31 with (m, l) from the visible keys 0..31,
    and a KV chunk at 40..55, after every row (causal), or at 0..15, in
    the causal past but outside a window of 1."""
    g = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g).to(device=device, dtype=dtype)
    q, o, do = mk(4, 16, 32), mk(4, 16, 32), mk(4, 16, 32)
    kv, vv = mk(2, 32, 32), mk(2, 32, 32)
    k, v = mk(2, 16, 32), mk(2, 16, 32)
    i32 = lambda a: torch.arange(*a, dtype=torch.int32, device=device)
    _, l, m = flash_mqkv_plain(q.float().cpu(), kv.float().cpu(),
                               vv.float().cpu(), i32((16, 32)).cpu(),
                               i32((0, 32)).cpu(), group=2, causal=True,
                               finalize=False)
    return q, k, v, o, do, m.to(device), l.to(device), i32((16, 32)), i32


@pytest.mark.parametrize("where", ["future", "outside-window"])
def test_k1b_writes_zeros_for_a_fully_hidden_chunk(where):
    q, k, v, o, do, m, l, q_pos, i32 = _hidden_chunk()
    k_pos, window = ((i32((40, 56)), None) if where == "future"
                     else (i32((0, 16)), 1))
    for t in flash_mqkv_bwd(q, k, v, o, do, m, l, q_pos, k_pos, group=2,
                            causal=True, window=window):
        assert bool((t == 0).all())


# ---------------------------------------------------------------------------
# reduced models over a mesh against the reference
# ---------------------------------------------------------------------------

_JAX_SP = """
import pickle, sys
import jax, numpy as np
from jax.sharding import AxisType
from repro.configs import get_reduced
from repro.core import SPConfig
from repro.models import ParallelContext, get_model
import dataclasses
mesh = jax.make_mesh((2, 2), ("pod", "model"),
                     axis_types=(AxisType.Auto,) * 2)
sp = SPConfig(strategy="swift_torus", sp_axes=("pod", "model"),
              batch_axes=None, machine_axis="pod", comm_backend="xla")
out = {}
for arch, (tree, batch) in pickle.load(open(sys.argv[1], "rb")).items():
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32",
                              sharding_overrides=())
    b = get_model(cfg)
    ctx = ParallelContext(mesh, sp, "train")
    p = jax.tree.map(jax.numpy.asarray, tree)
    jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    (loss, _), g = jax.jit(jax.value_and_grad(
        lambda p: b.loss(p, jb, cfg, ctx), has_aux=True))(p)
    out[arch] = (float(loss), jax.tree.map(np.asarray, g))
pickle.dump(out, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Per arch: the port's config, the numpy parameter tree (constant
    leaves drawn), the batch, and the reference's (loss, gradient tree) at
    degree 1 on a 1 x 1 Auto-axis mesh (in process) and under swift_torus
    over (pod 2, model 2) on 8 fake devices (one subprocess)."""
    mesh1 = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(AxisType.Auto,) * 2)
    jsp = JSP(strategy="full", sp_axes=("model",), batch_axes=("data",))
    cases, out = {}, {}
    for arch in MODEL_ARCHS:
        cfg, jcfg = _cfgs(arch)
        jb = j_get_model(jcfg)
        params, _ = jb.init(jcfg, jax.random.PRNGKey(0), 1)
        tree = jax.tree.map(np.array, params)
        rng = np.random.default_rng(sum(map(ord, arch)))
        _perturb(tree, rng)
        batch = SyntheticStream(cfg, InputShape("t", *SHAPE, "training"),
                                seed=3).batch_numpy(0)
        if "timesteps" in batch:  # the DiT's timesteps lie in [0, 1]
            batch["timesteps"] = rng.random(SHAPE[1]).astype(np.float32)
        jctx = JCtx(mesh1, jsp, "train")
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: jb.loss(p, jbatch, jcfg, jctx), has_aux=True))(
                jax.tree.map(jnp.asarray, tree))
        cases[arch] = (tree, batch)
        out[arch] = dict(cfg=cfg, tree=tree, batch=batch,
                         deg1=(float(loss), jax.tree.map(np.asarray, grads)))
    tmp = tmp_path_factory.mktemp("jax_sp")
    src, dst = tmp / "in.pkl", tmp / "out.pkl"
    src.write_bytes(pickle.dumps(cases))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_SP, str(src), str(dst)],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for arch, sp in pickle.loads(dst.read_bytes()).items():
        out[arch]["sp"] = sp
    return out


def _port_loss_and_grads(cfg, tree, batch, mesh_name, backend="pallas",
                         remat="full"):
    bundle = get_model(cfg)
    params = params_from_numpy(tree, cfg, CPU)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    ctx = ParallelContext(_sp_cfg(mesh_name, backend=backend), "train",
                          mesh=_mesh(mesh_name), remat=remat)
    loss, _ = bundle.loss(params, {k: T(v) for k, v in batch.items()}, cfg,
                          ctx)
    return float(loss.detach()), torch.autograd.grad(loss,
                                                     tree_leaves(params))


def _check_grads(cfg, grads, want_tree):
    want_t = params_from_numpy(want_tree, cfg, CPU)
    want, names = tree_leaves(want_t), _leaf_names(want_t)
    assert len(grads) == len(want) == len(names)
    top = max(float(w.abs().max()) for w in want)
    for name, g, w in zip(names, grads, want):
        assert bool(torch.isfinite(g).all()), name
        if cfg.rope in ("none", "sinusoidal") and name.endswith("wk/b"):
            # no rotary positions: the K bias's gradient is 0 in exact
            # arithmetic (tests/test_torch_train.py)
            assert float((g - w).abs().max()) < GRAD_TOL * top, name
            continue
        assert _rel(g.numpy(), w.numpy()) < GRAD_TOL, name


@pytest.mark.parametrize("arch,mesh_name,backend", [
    ("qwen2-1.5b", "pod2-model2", "pallas"),
    ("qwen2-1.5b", "pod2-model2", "xla"),
    ("qwen2-1.5b", "data2-model2", "pallas"),
    ("qwen2-vl-2b", "pod2-model2", "pallas"),
    ("flux-12b", "pod2-model2", "pallas")])
def test_model_gradients_over_a_mesh_match_reference(arch, mesh_name,
                                                     backend, reference):
    r = reference[arch]
    loss, grads = _port_loss_and_grads(r["cfg"], r["tree"], r["batch"],
                                       mesh_name, backend)
    for ref_loss, ref_grads in (r["deg1"], r["sp"]):
        assert np.isfinite(ref_loss)
        assert _rel(loss, ref_loss) < SP_LOSS_TOL
        _check_grads(r["cfg"], grads, ref_grads)


def test_remat_full_reruns_the_schedule_to_the_same_gradients(reference):
    """Remat "full" runs SPAttention's forward again inside the backward
    (fresh puts, epochs and receive buffers): the gradients are bitwise
    those of remat "none"."""
    r = reference["qwen2-1.5b"]
    runs = [_port_loss_and_grads(r["cfg"], r["tree"], r["batch"],
                                 "pod2-model2", remat=remat)
            for remat in ("none", "full")]
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("flags", [["--model", "2"], ["--data", "2"],
                                   ["--mesh", "pod"]])
def test_launch_trains_over_meshes(flags, capsys):
    assert launch_train.main(["--arch", "qwen2-1.5b", "--reduced", "--device",
                              "cpu", "--steps", "1", "--seq", "32",
                              "--batch", "2", *flags]) == 0
    out = capsys.readouterr().out
    assert "mesh: " in out and "of virtual ranks on cpu" in out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 1 and all(np.isfinite(losses))
    if flags != ["--data", "2"]:
        assert "swift_torus, P_u " in out
