"""The port's training (src/repro_torch/train, launch/train.py, the
bundles' losses) against the reference on the CPU.

* ``adamw_update`` against the reference's on the same numpy inputs over
  several steps, with clipping engaged, for both ``moments_dtype``s;
  ``schedule`` as tests/test_train_and_checkpoint.py checks it, and equal
  to the reference's;
* ``SyntheticStream`` batches bitwise the reference's;
* the checkpoint round trip and its mismatch assert;
* K1b's plain version (``flash_mqkv_bwd_plain``) against autograd of
  K1's plain version, and ``FlashMQKV`` on the CPU through it;
* per reduced arch whose reference train step is green, the loss and
  every gradient against ``jax.value_and_grad(bundle.loss)`` on the
  1-device mesh (float32: loss within 1e-5, each gradient within 1e-4 of
  its max|grad|), then the parameters after one AdamW step;
* ``Trainer``'s loss falling by more than 0.2 in 40 steps at the
  reference test's config (the port's own criterion: the reference's
  test_loss_decreases_on_synthetic_lm fails on this jax, ROADMAP F2);
* ``launch/train.py --reduced --device cpu``, and the families refused
  over a mesh (rwkv6, hymba, and qwen2-moe at EP > 1; training over a
  mesh is tests/test_torch_train_sp.py's).

Parameters are the reference's ``bundle.init`` trees with their constant
leaves (zero biases, unit norms, the DiT's zero adaLN and output
projections) drawn small first, carried across with the port's loaders.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.configs.shapes import InputShape as JShape
from repro.core import SPConfig as JSP
from repro.models import ParallelContext as JCtx
from repro.models import get_model as j_get_model
from repro.train import checkpoint as j_ckpt
from repro.train.data import SyntheticStream as JStream
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import adamw_update as j_adamw_update
from repro.train.optimizer import init_adamw as j_init_adamw
from repro.train.optimizer import schedule as j_schedule
from repro_torch.configs import get_reduced
from repro_torch.configs.shapes import InputShape
from repro_torch.core import SPConfig
from repro_torch.kernels import flash_attention
from repro_torch.kernels.flash_mqkv import flash_mqkv, flash_mqkv_plain
from repro_torch.kernels.ref import flash_mqkv_bwd_plain
from repro_torch.launch import train as launch_train
from repro_torch.models import ParallelContext, get_model
from repro_torch.models.blocks import params_from_numpy
from repro_torch.train import (AdamWConfig, SyntheticStream, Trainer,
                               adamw_update, checkpoint, init_adamw)
from repro_torch.train.optimizer import schedule, tree_leaves, tree_map

CPU = torch.device("cpu")
T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
J_SP = JSP(strategy="full", sp_axes=("model",), batch_axes=("data",))
SP1 = SPConfig(strategy="full", sp_axes=("model",), batch_axes=("data",))
SHAPE = (32, 2)  # (seq, batch): tests/test_arch_smoke.py's training shape
LOSS_TOL = 1e-5  # relative
GRAD_TOL = 1e-4  # of each tensor's max|grad|
BWD_TOL = 1e-5  # K1b's plain version vs autograd, both f32, of max|grad|
# the archs whose reference train step passes on this jax (ROADMAP F2)
TRAIN_ARCHS = ("qwen2-1.5b", "qwen2-vl-2b", "stablelm-3b", "chatglm3-6b",
               "starcoder2-7b", "whisper-tiny", "flux-12b", "cogvideox-5b")


def _cfgs(arch):
    f32 = dict(dtype="float32", sharding_overrides=())
    return (dataclasses.replace(get_reduced(arch), **f32),
            dataclasses.replace(j_get_reduced(arch), **f32))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# optimizer, schedule, data, checkpoint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_matches_reference(moments):
    """Three updates of an f32 and a bf16 leaf with clipping engaged."""
    rng = np.random.default_rng(0)
    shapes = {"w": ((16, 8), np.float32), "b": ((8,), np.float32),
              "e": ((12, 4), "bfloat16")}
    p0 = {k: (rng.standard_normal(s) * 0.5).astype(np.float32)
          for k, (s, _) in shapes.items()}
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=0.5,
              moments_dtype=moments)
    jcfg, cfg = JAdamWConfig(**kw), AdamWConfig(**kw)
    jp = {k: jnp.asarray(v).astype(shapes[k][1]) for k, v in p0.items()}
    tp = {k: T(v).to(torch.bfloat16 if shapes[k][1] == "bfloat16"
                     else torch.float32) for k, v in p0.items()}
    jst, tst = j_init_adamw(jp, jcfg), init_adamw(tp, cfg)
    for step in range(3):
        g = {k: (rng.standard_normal(s) * 3).astype(np.float32)
             for k, (s, _) in shapes.items()}
        jg = {k: jnp.asarray(v).astype(shapes[k][1]) for k, v in g.items()}
        tg = {k: T(v).to(tp[k].dtype) for k, v in g.items()}
        jp, jst, jm = j_adamw_update(jcfg, jg, jst, jp)
        tp, tst, tm = adamw_update(cfg, tg, tst, tp)
        assert float(jm["grad_norm"]) > cfg.clip_norm  # clipping engaged
        assert _rel(float(tm["grad_norm"]), float(jm["grad_norm"])) < 1e-6
        assert float(tm["lr"]) == float(jm["lr"])
        for k in shapes:
            assert tst.mu[k].dtype == getattr(torch, moments)
            for got, want in ((tp[k], jp[k]), (tst.mu[k], jst.mu[k]),
                              (tst.nu[k], jst.nu[k])):
                np.testing.assert_allclose(
                    got.float().numpy(), np.asarray(want, np.float32),
                    rtol=1e-5, atol=1e-7)
    assert tst.step == int(jst.step) == 3


def test_schedule_warmup_and_decay():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    jcfg = JAdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                        min_lr_frac=0.1)
    steps = (0, 5, 10, 50, 99, 150)
    lrs = [schedule(cfg, s) for s in steps]
    assert lrs[0] < lrs[1] < lrs[2]  # warmup
    assert lrs[2] >= lrs[3] >= lrs[4]  # decay
    assert lrs[4] >= 0.1 * 0.99
    for s, lr in zip(steps, lrs):
        assert _rel(lr, float(j_schedule(jcfg, jnp.int32(s)))) < 1e-6


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen2-vl-2b",
                                  "whisper-tiny", "flux-12b"])
def test_synthetic_stream_is_the_reference_bitwise(arch):
    cfg, jcfg = get_reduced(arch), j_get_reduced(arch)  # the model's dtype
    mine = SyntheticStream(cfg, InputShape("t", 24, 3, "training"), seed=7)
    ref = JStream(jcfg, JShape("t", 24, 3, "training"), seed=7)
    for step in (0, 3):
        got, want = mine.batch(step, CPU), ref.batch(step)
        assert list(got) == list(want)
        for name, w in want.items():
            w = np.asarray(w.astype(jnp.float32) if w.dtype == jnp.bfloat16
                           else w)
            g = got[name]
            assert str(g.dtype).split(".")[-1] == str(want[name].dtype)
            np.testing.assert_array_equal(g.float().numpy() if
                                          g.is_floating_point() else g.numpy(),
                                          w)


def test_checkpoint_roundtrip_and_reference_layout(tmp_path):
    gen = torch.Generator().manual_seed(0)
    tree = {"b": {"d": torch.randn((3,), generator=gen).to(torch.bfloat16),
                  "c": torch.arange(5, dtype=torch.int32)},
            "a": torch.randn((4, 8), generator=gen),
            "layers": [{"w": torch.randn((2, 2), generator=gen)}],
            "step": 7}
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, tree)
    assert checkpoint.exists(path)
    out = checkpoint.load(path, tree_map(
        lambda x: torch.zeros_like(x) if isinstance(x, torch.Tensor) else 0,
        tree))
    for a, b in zip(tree_leaves(tree), tree_leaves(out)):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert int(b) == a
    # the reference reads the same files into a tree of the same leaves
    like = {"a": jnp.zeros((4, 8)),
            "b": {"c": jnp.zeros(5, jnp.int32),
                  "d": jnp.zeros(3, jnp.bfloat16)},
            "layers": [{"w": jnp.zeros((2, 2))}], "step": jnp.zeros(())}
    ref = j_ckpt.load(path, like)
    assert ref["b"]["d"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(ref["b"]["d"], np.float32),
                                  tree["b"]["d"].float().numpy())
    np.testing.assert_array_equal(np.asarray(ref["a"]), tree["a"].numpy())


def test_checkpoint_structure_mismatch_raises(tmp_path):
    path = str(tmp_path / "ckpt2")
    checkpoint.save(path, {"a": torch.zeros(2)})
    with pytest.raises(AssertionError):
        checkpoint.load(path, {"a": torch.zeros(2), "b": torch.zeros(3)})
    with pytest.raises(AssertionError):
        checkpoint.load(path, {"a": torch.zeros(3)})


# ---------------------------------------------------------------------------
# K1b's plain version and the autograd Function
# ---------------------------------------------------------------------------

# (bh, hkv, lq, lk, d, causal, window, padded keys, fully masked row)
BWD_CASES = {
    "causal-gqa": (6, 2, 20, 20, 16, True, None, 0, False),
    "window": (4, 4, 24, 24, 32, True, 7, 0, False),
    "cross": (4, 4, 9, 30, 16, False, None, 0, False),
    "padding": (4, 1, 16, 27, 32, False, None, 5, False),
    "masked-row": (4, 2, 12, 20, 16, True, None, 4, True),
    "head-dim-80": (2, 1, 10, 14, 80, True, None, 0, False),
}


def _bwd_inputs(case, seed=0):
    bh, hkv, lq, lk, d, causal, window, pad, dead = case
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(s, generator=g)
               for s in ((bh, lq, d), (hkv, lk, d), (hkv, lk, d)))
    q_pos = torch.arange(lk - lq, lk, dtype=torch.int32)
    k_pos = torch.arange(lk, dtype=torch.int32)
    if pad:
        k_pos[-pad:] = -1
    if dead:  # row 0 sees only position 0, which is padding
        k_pos[:3] = -1
        q_pos[0] = 0
    do = torch.randn((bh, lq, d), generator=g)
    kw = dict(group=bh // hkv, scale=d ** -0.5, causal=causal, window=window)
    return q, k, v, q_pos, k_pos, do, kw


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_bwd_plain_matches_autograd_of_plain(case):
    """The explicit FA2 backward equals autograd of K1's plain version.
    Both compute in float32 (the sums associate differently): 1e-5 of
    max|grad|."""
    q, k, v, q_pos, k_pos, do, kw = _bwd_inputs(BWD_CASES[case])
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    o, l, m = flash_mqkv_plain(*ins, q_pos, k_pos, **kw)
    want = torch.autograd.grad(o, ins, do)
    o, l, m = o.detach(), l.detach(), m.detach()
    got = flash_mqkv_bwd_plain(q, k, v, o, do, m, l, q_pos, k_pos, **kw)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert _rel(g.numpy(), w.numpy()) < BWD_TOL
    if BWD_CASES[case][-1]:
        dead = l == 0
        assert bool(dead.any()) and bool((got[0][dead] == 0).all())


def test_function_on_cpu_runs_the_plain_backward():
    """flash_mqkv with q/k/v requiring grad goes through FlashMQKV, whose
    CPU backward is flash_mqkv_bwd_plain; a carried state or an
    unfinalized call raises under grad, pointing to the SP schedule's
    gradient."""
    q, k, v, q_pos, k_pos, do, kw = _bwd_inputs(BWD_CASES["causal-gqa"])
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    o, l, m = flash_mqkv(*ins, q_pos, k_pos, **kw)
    assert o.grad_fn is not None and "FlashMQKV" in type(o.grad_fn).__name__
    assert not l.requires_grad and not m.requires_grad
    got = torch.autograd.grad(o, ins, do)
    want = flash_mqkv_bwd_plain(q, k, v, o.detach(), do, m, l, q_pos, k_pos,
                                **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(NotImplementedError, match="core/sp_grad.py"):
        flash_mqkv(*ins, q_pos, k_pos, finalize=False, **kw)
    with pytest.raises(NotImplementedError, match="core/sp_grad.py"):
        flash_mqkv(*ins, q_pos, k_pos, state=(o.detach(), l, m), **kw)
    with torch.no_grad():  # no gradient wanted: the partial call runs
        flash_mqkv(*ins, q_pos, k_pos, finalize=False, **kw)


def test_flash_attention_gradient_matches_autograd_of_plain():
    """ops.flash_attention (head flattening, block padding: padded q rows
    get dO = 0) differentiates through the Function as autograd of
    the plain version does."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(s, generator=g)
               for s in ((2, 13, 6, 16), (2, 13, 2, 16), (2, 13, 2, 16)))
    do = torch.randn((2, 13, 6, 16), generator=g)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*ins, causal=True, window=5),
                              ins, do)
    ref_ins = [t.clone().requires_grad_() for t in (q, k, v)]
    pos = torch.arange(13, dtype=torch.int32)
    flat = lambda t: t.permute(0, 2, 1, 3).reshape(-1, 13, 16)
    o, _, _ = flash_mqkv_plain(*(flat(t) for t in ref_ins), pos, pos,
                               group=3, scale=0.25, causal=True, window=5)
    want = torch.autograd.grad(o, ref_ins,
                               flat(do).contiguous())
    for a, b in zip(got, want):
        assert _rel(a.numpy(), b.numpy()) < BWD_TOL


# ---------------------------------------------------------------------------
# losses and gradients against jax.value_and_grad
# ---------------------------------------------------------------------------

def _perturb(tree, rng):
    """Constant leaves (zero biases and adaLN/output projections, unit
    norm scales) drawn as const + N(0, 0.1²), numpy, in place."""
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            _perturb(leaf, rng)
        elif np.all(leaf == leaf.flat[0]):
            tree[name] = (leaf + rng.standard_normal(leaf.shape) * 0.1
                          ).astype(np.float32)


def _leaf_names(tree, prefix=""):
    """Paths of ``tree_leaves(tree)``, in its order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}{i}/")]
    return [prefix.rstrip("/")]


@pytest.fixture(scope="module")
def arch_setup(mesh1):
    cache = {}

    def get(arch):
        if arch not in cache:
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
            cache[arch] = (cfg, jcfg, jb, tree, batch)
        return cache[arch]

    return get


def check_against_reference(cfg, jcfg, jb, tree, batch, mesh):
    """The port's loss and every gradient of the numpy parameter ``tree``
    on ``batch`` against ``jax.value_and_grad(jb.loss)`` on ``mesh`` (loss
    within LOSS_TOL, each gradient within GRAD_TOL of its max|grad|, every
    reference gradient finite and not all zero), then the parameters after
    one AdamW step on both."""
    jctx = JCtx(mesh, J_SP, "train")
    jparams = jax.tree.map(jnp.asarray, tree)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jb.loss(p, jbatch, jcfg, jctx), has_aux=True))(jparams)

    bundle = get_model(cfg)
    params = params_from_numpy(tree, cfg, CPU)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    ctx = ParallelContext(SP1, "train", CPU)
    tbatch = {k: T(v) for k, v in batch.items()}
    loss, _ = bundle.loss(params, tbatch, cfg, ctx)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    assert np.isfinite(float(jloss))
    assert _rel(float(loss.detach()), float(jloss)) < LOSS_TOL
    jgrads_t = params_from_numpy(jax.tree.map(np.asarray, jgrads), cfg, CPU)
    want = tree_leaves(jgrads_t)
    names = _leaf_names(jgrads_t)
    assert len(grads) == len(want) == len(names)
    top = max(float(w.abs().max()) for w in want)
    for name, g, w in zip(names, grads, want):
        assert bool(torch.isfinite(w).all()), name
        assert float(w.abs().max()) > 0, name
        if cfg.rope in ("none", "sinusoidal") and name.endswith("wk/b"):
            # softmax ignores a shift of a row's scores: without rotary
            # positions the K bias's gradient is 0 in exact arithmetic,
            # rounding noise in both packages; held to the model's
            # largest gradient instead
            assert float((g - w).abs().max()) < GRAD_TOL * top, name
            continue
        assert _rel(g.numpy(), w.numpy()) < GRAD_TOL, name

    # then one AdamW step on both
    opt = AdamWConfig(lr=1e-3)
    jopt = JAdamWConfig(lr=1e-3)
    jnew, _, _ = jax.jit(functools.partial(j_adamw_update, jopt))(
        jgrads, j_init_adamw(jparams, jopt), jparams)
    it = iter(grads)
    new, _, _ = adamw_update(opt, tree_map(lambda _: next(it), params),
                             init_adamw(params, opt), params)
    want = tree_leaves(params_from_numpy(jax.tree.map(np.asarray, jnew),
                                         cfg, CPU))
    for p, w in zip(tree_leaves(new), want):
        np.testing.assert_allclose(p.detach().numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_loss_and_gradients_match_reference(arch, arch_setup, mesh1):
    cfg, jcfg, jb, tree, batch = arch_setup(arch)
    check_against_reference(cfg, jcfg, jb, tree, batch, mesh1)


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
def test_remat_policies_give_the_same_gradients(remat):
    """Activation checkpointing changes what is kept, not the result."""
    cfg, _ = _cfgs("qwen2-1.5b")
    batch = {k: T(v) for k, v in SyntheticStream(
        cfg, InputShape("t", *SHAPE, "training")).batch_numpy(0).items()}
    grads = {}
    for policy in ("none", remat):
        params = get_model(cfg).init(cfg, torch.Generator().manual_seed(0),
                                     CPU)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        ctx = ParallelContext(SP1, "train", CPU, remat=policy)
        loss, _ = get_model(cfg).loss(params, batch, cfg, ctx)
        grads[policy] = torch.autograd.grad(loss, tree_leaves(params))
    for a, b in zip(grads["none"], grads[remat]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Trainer, launcher, refusals
# ---------------------------------------------------------------------------

def test_trainer_loss_decreases_on_synthetic_lm(tmp_path):
    """The reference test's config (tests/test_train_and_checkpoint.py):
    the loss falls by more than 0.2 in 40 steps; the checkpoint holds the
    trained parameters."""
    cfg, _ = _cfgs("qwen2-1.5b")
    shape = InputShape("tiny_train", 64, 4, "training")
    tr = Trainer(cfg, None, SP1, shape,
                 opt_cfg=AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60),
                 ckpt_path=str(tmp_path / "ck"), device="cpu")
    params, history = tr.run(steps=40, log_every=10)
    first, last = history[0]["loss"], history[-1]["loss"]
    assert np.isfinite(last)
    assert last < first - 0.2, (first, last)
    assert [h["step"] for h in history] == [0, 10, 20, 30, 39]
    assert set(history[0]) >= {"loss", "grad_norm", "lr", "step", "wall"}
    assert len(tr.step_seconds) == 40
    back = checkpoint.load(str(tmp_path / "ck"),
                           {"params": params, "step": 0})
    assert int(back["step"]) == 40
    for a, b in zip(tree_leaves(params), tree_leaves(back["params"])):
        assert torch.equal(a.detach(), b)


def test_train_step_updates_in_place():
    cfg, _ = _cfgs("whisper-tiny")
    tr = Trainer(cfg, None, SP1, InputShape("t", 16, 2, "training"),
                 device="cpu")
    params, opt = tr.setup()
    before = [p.detach().clone() for p in tree_leaves(params)]
    ids = [id(p) for p in tree_leaves(params)]
    out, opt, metrics = tr.step_fn(params, opt, tr.stream.batch(0, CPU))
    assert [id(p) for p in tree_leaves(out)] == ids
    assert opt.step == 1 and np.isfinite(float(metrics["loss"]))
    assert all(not torch.equal(a, p.detach())
               for a, p in zip(before, tree_leaves(out)))


def test_launch_train_reduced_on_cpu(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    assert launch_train.main(["--arch", "qwen2-1.5b", "--reduced",
                              "--device", "cpu", "--steps", "3", "--seq",
                              "32", "--batch", "2", "--ckpt", ck]) == 0
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "step     2 loss" in out
    assert "tokens/s" in out and "peak memory not measured (cpu)" in out
    assert checkpoint.exists(ck)


@pytest.mark.parametrize("flags", [["--model", "2"], ["--data", "2"],
                                   ["--mesh", "pod"]])
def test_meshes_are_refused(flags, capsys):
    """Over every mesh the launcher once refused rwkv6, hymba and
    qwen2-moe (ROADMAP Queue 1 item 7, done): now it trains each of them
    one step over it, reduced, on the CPU (the moe family at EP 2 with
    --model 2, EP 8 with --mesh pod and EP 1 with --data 2).  Their
    gradients over a mesh are held to the reference's in
    tests/test_torch_train_sp_state.py."""
    for arch in ("rwkv6-1.6b", "hymba-1.5b", "qwen2-moe-a2.7b"):
        assert launch_train.main(["--arch", arch, "--reduced", "--device",
                                  "cpu", "--steps", "1", "--seq", "16",
                                  "--batch", "2", *flags]) == 0
        out = capsys.readouterr().out
        assert "of virtual ranks on cpu" in out
        losses = [float(line.split()[3]) for line in out.splitlines()
                  if line.startswith("step ")]
        assert len(losses) == 1 and all(np.isfinite(losses)), (arch, out)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_input_specs_mirror_reference(arch):
    """Abstract specs: the reference's shapes and dtypes (meta tensors);
    concrete ones drawn on the device from a torch.Generator."""
    cfg, jcfg = get_reduced(arch), j_get_reduced(arch)
    for kind in ("training", "decode"):
        if cfg.family == "dit" and kind == "decode":
            continue
        shape = InputShape("t", 16, 2, kind)
        mine = get_model(cfg).input_specs(cfg, shape, abstract=True)
        ref = j_get_model(jcfg).input_specs(jcfg, JShape("t", 16, 2, kind),
                                            abstract=True)
        assert list(mine) == list(ref)
        for name, s in mine.items():
            assert s.device.type == "meta"
            assert tuple(s.shape) == tuple(ref[name].shape)
            assert str(s.dtype).split(".")[-1] == str(ref[name].dtype)
        real = get_model(cfg).input_specs(
            cfg, shape, abstract=False,
            generator=torch.Generator().manual_seed(0), device="cpu")
        for name, t in real.items():
            assert t.dtype == mine[name].dtype and t.device == CPU
            if not t.is_floating_point():
                assert 0 <= int(t.min()) and int(t.max()) < max(cfg.vocab, 2)
