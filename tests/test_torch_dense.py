"""The port's dense and vision-language attention LMs against the reference
on the CPU: qwen2-1.5b, stablelm-3b (partial rotary, LayerNorm),
starcoder2-7b (sliding window, GELU), chatglm3-6b (rope2d) and qwen2-vl-2b
(M-RoPE, ``inputs_embeds``), each on its reduced config in float32.

Inputs and parameters are made with numpy and handed to both packages
(``load_jax_lm_params``).  The reference initialises biases at zero and
norms at one; they are drawn small first, so that QKV biases and LayerNorm
biases take part.  Prompts are B 2 x L 40: above starcoder2's reduced
window of 16, so the window masks keys in prefill and in decode.

* prefill logits against the reference's ``bundle.apply`` (1e-5 of
  max|logits|), full and ``last_only``;
* decode logits step by step against the reference's jitted
  ``bundle.step`` and against the port's own prefill (5e-5, the
  reference's tolerance for the dense family in
  tests/test_decode_consistency.py);
* ARServer's tokens against the reference's ARServer on the setups of
  tests/test_serving.py, ROADMAP F4 and F5 on both packages;
* prefill and decode on mesh (pod 2, data 2, model 2) of virtual ranks
  against the reference on 8 fake devices (one subprocess for the file),
  at 1e-4, and decode on (pod 2, model 8) against degree 1;
* the capture rehearsal of tests/test_torch_graphs.py on the dense tick.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.core import SPConfig as JSP
from repro.core.strategy import resolve_layout as j_resolve_layout
from repro.models import ParallelContext as JCtx
from repro.models import get_model as j_get_model
from repro.serving import ARRequest as JARRequest
from repro.serving import ARServer as JARServer
from repro_torch.configs import DENSE_ARCHS, get_config, get_reduced
from repro_torch.core import SPConfig
from repro_torch.core.strategy import resolve_layout
from repro_torch.launch import make_mesh
from repro_torch.models import (ParallelContext, get_model, init_lm,
                                init_lm_caches, load_jax_lm_params)
from repro_torch.serving import ARRequest, ARServer
from test_torch_graphs import guard  # noqa: F401  (the capture rehearsal)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
J_SP = JSP(strategy="full", sp_axes=("model",), batch_axes=("data",))
SP1 = SPConfig(strategy="full")
PREFILL_TOL = 1e-5  # of max|logits|
DECODE_TOL = 5e-5  # tests/test_decode_consistency.py, dense family
SP_TOL = 1e-4  # tests/multidevice/test_sp_strategies.py
B, L = 2, 40
# examples/generate_text.py's mesh: KV sharded over (pod, model), slots
# over data
SP_MESH = ((2, 2, 2), ("pod", "data", "model"))
SP_STRATEGIES = ("swift", "swift_torus")
SP_LEN = 32  # splits over the 4 SP ranks of SP_MESH and the 16 of (pod, model 8)


def perturb(tree, rng):
    """Draw the leaves the reference initialises as constants: linear
    biases and LayerNorm biases N(0, 0.1^2), norm scales 1 + N(0, 0.1^2)
    (numpy, in place)."""
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            perturb(leaf, rng)
        elif name in ("b", "bias", "scale"):
            noise = (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)
            tree[name] = (noise + 1.0) if name == "scale" else noise


def _inputs(cfg, rng, length=L):
    """A prefill batch as numpy: tokens, and for the vlm family the
    stubbed frontend's embeddings and [3, B, L] M-RoPE positions (t, h, w
    of a patch grid, not all equal)."""
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, length)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["inputs_embeds"] = (rng.standard_normal(
            (B, length, cfg.d_model)) * 0.5).astype(np.float32)
        t = np.arange(length)
        batch["positions"] = np.broadcast_to(
            np.stack([t, t // 4, t % 4])[:, None], (3, B, length)).astype(
                np.int32).copy()
    return batch


class _Models:
    """Both packages' models per arch, built on first use."""

    def __init__(self, mesh1):
        self.mesh1 = mesh1
        self._cache = {}

    def __getitem__(self, arch):
        if arch not in self._cache:
            self._cache[arch] = self._build(arch)
        return self._cache[arch]

    def _build(self, arch):
        cfg = dataclasses.replace(get_reduced(arch), dtype="float32",
                                  sharding_overrides=())
        jcfg = dataclasses.replace(j_get_reduced(arch), dtype="float32",
                                   sharding_overrides=())
        jb = j_get_model(jcfg)
        params, _ = jb.init(jcfg, jax.random.PRNGKey(0), 1)
        tree = jax.tree.map(np.array, params)
        rng = np.random.default_rng(sum(map(ord, arch)))
        perturb(tree, rng)
        jparams = jax.tree.map(jnp.asarray, tree)
        jstep = jax.jit(lambda p, b, c, i: jb.step(
            p, b, c, i, jcfg, JCtx(self.mesh1, J_SP, "decode")))
        return dict(cfg=cfg, jcfg=jcfg, jb=jb, tree=tree, jparams=jparams,
                    tparams=load_jax_lm_params(tree, cfg, device="cpu"),
                    batch=_inputs(cfg, rng), jstep=jstep, mesh1=self.mesh1)


@pytest.fixture(scope="module")
def models(mesh1):
    return _Models(mesh1)


def _prefill(m, batch, ctx=None, **kw):
    ctx = ctx or ParallelContext(SP1, "prefill", CPU)
    with torch.inference_mode():
        return get_model(m["cfg"]).apply(
            m["tparams"], {k: T(v) for k, v in batch.items()}, m["cfg"], ctx,
            **kw).numpy()


def _ref_prefill(m, batch, **kw):
    return np.asarray(m["jb"].apply(
        m["jparams"], {k: jnp.asarray(v) for k, v in batch.items()},
        m["jcfg"], JCtx(m["mesh1"], J_SP, "prefill"), **kw))


def _decode_batch(batch, t):
    """Step t's decode inputs: the token, and the vlm's positions."""
    out = {"tokens": batch["tokens"][:, t:t + 1]}
    if "positions" in batch:
        out["positions"] = batch["positions"][:, :, t:t + 1]
    return out


def _decode(m, batch, ctx=None):
    """The port's teacher-forced decode logits [B, L, V]."""
    cfg = m["cfg"]
    length = batch["tokens"].shape[1]
    ctx = ctx or ParallelContext(SP1, "decode", CPU)
    bundle = get_model(cfg)
    caches = bundle.init_caches(cfg, B, length, torch.float32, ctx.device)
    outs = []
    with torch.inference_mode():
        for t in range(length):
            logit, caches = bundle.step(
                m["tparams"], {k: T(v) for k, v in
                               _decode_batch(batch, t).items()},
                caches, t, cfg, ctx)
            outs.append(logit)
    return torch.stack(outs, dim=1).numpy()


def _ref_decode(m, batch):
    jc = m["jb"].init_caches(m["jcfg"], B, batch["tokens"].shape[1],
                             jnp.float32)
    outs = []
    for t in range(batch["tokens"].shape[1]):
        logit, jc = m["jstep"](m["jparams"], {
            k: jnp.asarray(v) for k, v in _decode_batch(batch, t).items()},
            jc, jnp.int32(t))
        outs.append(np.asarray(logit))
    return np.stack(outs, axis=1)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# degree 1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_init_mirrors_reference_structure(models, arch):
    """init_lm's and init_lm_caches's shapes are the reference's."""
    m = models[arch]
    mine = init_lm(m["cfg"], torch.Generator().manual_seed(0), device="cpu")
    ref = jax.tree.map(lambda a: tuple(a.shape), m["jparams"])
    layer_shapes = jax.tree.map(lambda s: s[1:], ref.pop("layers"),
                                is_leaf=lambda x: isinstance(x, tuple))
    assert jax.tree.map(lambda t: tuple(t.shape), {
        k: v for k, v in mine.items() if k != "layers"}) == ref
    assert len(mine["layers"]) == m["cfg"].n_layers
    for lp in mine["layers"]:
        assert jax.tree.map(lambda t: tuple(t.shape), lp) == layer_shapes
    caches = init_lm_caches(m["cfg"], 3, 32, torch.float32, "cpu")
    want = m["jb"].init_caches(m["jcfg"], 3, 32, jnp.float32)
    assert {k: tuple(v.shape) for k, v in caches.items()} == {
        k: tuple(v.shape) for k, v in want.items()}


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_prefill_logits_match_reference(models, arch):
    """lm_forward prefill at SP degree 1 (K1's plain version), full and
    last_only; qwen2-vl through inputs_embeds and [3, B, L] positions
    (measured at most 1.2e-06 of max|logits|)."""
    m = models[arch]
    want = _ref_prefill(m, m["batch"])
    got = _prefill(m, m["batch"])
    last = _prefill(m, m["batch"], last_only=True)
    assert got.shape == (B, L, m["cfg"].vocab) and last.shape == (B, 1, m["cfg"].vocab)
    assert _rel(got, want) <= PREFILL_TOL
    assert _rel(last, want[:, -1:]) <= PREFILL_TOL


@pytest.fixture(scope="module")
def decoded(models):
    """{arch: (port decode, reference decode)}, built on first use; the
    vlm decodes tokens at the M-RoPE positions of its batch."""
    out = {}

    def get(arch):
        if arch not in out:
            m = models[arch]
            batch = {k: v for k, v in m["batch"].items()
                     if k != "inputs_embeds"}
            out[arch] = (batch, _decode(m, batch), _ref_decode(m, batch))
        return out[arch]
    return get


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_decode_matches_reference_step(models, decoded, arch):
    """(measured max|d| at most 4.1e-06.)"""
    _, port, ref = decoded(arch)
    np.testing.assert_allclose(port, ref, rtol=DECODE_TOL, atol=DECODE_TOL)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_decode_matches_own_prefill(models, decoded, arch):
    """Teacher-forced decode (core/decode.py) against the same tokens'
    prefill, at the reference's own tolerance for this check."""
    batch, port, _ = decoded(arch)
    full = _prefill(models[arch], batch)
    np.testing.assert_allclose(port, full, rtol=DECODE_TOL, atol=DECODE_TOL)


def test_sliding_window_masks_keys(models):
    """starcoder2's reduced window (16) at L 40 changes the logits far
    beyond the tolerances above, on both packages alike: the window is
    applied, not ignored, in the prefill the decode was held to."""
    m = models["starcoder2-7b"]
    assert m["cfg"].window == 16 < L
    wide = dict(m, cfg=dataclasses.replace(m["cfg"], window=None),
                jcfg=dataclasses.replace(m["jcfg"], window=None))
    got, no_window = _prefill(m, m["batch"]), _prefill(wide, m["batch"])
    assert _rel(no_window, got) > 1000 * PREFILL_TOL
    assert _rel(_ref_prefill(wide, m["batch"]), no_window) <= PREFILL_TOL


def test_bf16_model_decodes_from_bf16_caches(models):
    """A bfloat16 qwen2 decoding from bfloat16 caches: logits bfloat16 and
    finite, caches still bfloat16 and written in place."""
    m = models["qwen2-1.5b"]
    cfg = dataclasses.replace(m["cfg"], dtype="bfloat16")
    params = load_jax_lm_params(m["tree"], cfg, device="cpu")
    bundle = get_model(cfg)
    ctx = ParallelContext(SP1, "decode", CPU)
    caches = bundle.init_caches(cfg, B, 8, torch.bfloat16, "cpu")
    k_cache = caches["k"]
    with torch.inference_mode():
        for t in range(3):
            logits, caches = bundle.step(
                params, {"tokens": T(m["batch"]["tokens"][:, t:t + 1])},
                caches, t, cfg, ctx)
            assert logits.dtype == torch.bfloat16
            assert bool(torch.isfinite(logits).all())
    assert caches["k"] is k_cache and caches["k"].dtype == torch.bfloat16
    assert bool((k_cache[:, :, :3] != 0).any(dim=(1, 3, 4)).all())
    assert not bool(k_cache[:, :, 3:].any())


def test_f5_cache_dtype_must_be_the_models_on_both_packages(models):
    """ROADMAP F5.  A bfloat16 attention model decoding from float32
    caches (ARServer's default): the reference's cache update refuses the
    mixed dtypes (TypeError), and the port refuses them the same way."""
    m = models["qwen2-1.5b"]
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


# ---------------------------------------------------------------------------
# ARServer
# ---------------------------------------------------------------------------

# tests/test_serving.py's two setups: (slots, max_len, requests as
# (rid, prompt, new tokens))
AR_SETUPS = {
    "same-prompt": (2, 32, [(1, [3, 7, 11], 5), (2, [3, 7, 11], 5)]),
    "queue-overflow": (2, 16, [(i, [i + 1], 3) for i in range(5)]),
}


def _serve(m, slots, max_len, requests, port, mesh=None, sp=SP1):
    if port:
        srv = ARServer(m["tparams"], m["cfg"], sp, batch_slots=slots,
                       max_len=max_len, device="cpu", mesh=mesh)
    else:
        srv = JARServer(m["jparams"], m["jcfg"], m["mesh1"], J_SP,
                        batch_slots=slots, max_len=max_len)
    for rid, prompt, new in requests:
        p = np.asarray(prompt, np.int32)
        srv.submit(ARRequest(rid=rid, prompt=T(p), max_new_tokens=new)
                   if port else JARRequest(rid=rid, prompt=jnp.asarray(p),
                                           max_new_tokens=new))
    return srv.serve()


@pytest.mark.parametrize("setup", AR_SETUPS)
def test_ar_server_matches_reference(models, setup):
    m = models["qwen2-1.5b"]
    slots, max_len, requests = AR_SETUPS[setup]
    got = _serve(m, slots, max_len, requests, port=True)
    assert got == _serve(m, slots, max_len, requests, port=False)
    assert {rid: len(v) for rid, v in got.items()} == {
        rid: new for rid, _, new in requests}


def test_ar_server_runs_on_its_mesh_device(models):
    """With a mesh the server runs on the mesh's device: a device given
    beside it must be that one."""
    m = models["qwen2-1.5b"]
    mesh = make_mesh(*SP_MESH, device="cpu")
    srv = ARServer(m["tparams"], m["cfg"], _sp_cfg("swift"), max_len=16,
                   mesh=mesh)
    assert srv.device == mesh.device == srv.caches["k"].device
    with pytest.raises(ValueError, match="mesh"):
        ARServer(m["tparams"], m["cfg"], _sp_cfg("swift"), max_len=16,
                 device="cuda", mesh=mesh)


def test_f4_attention_slot_state_carries_over_on_both_packages(models):
    """ROADMAP F4 for attention models.  Two slots share one cur_index and
    keep their caches: request 2 takes the slot request 1 freed while
    request 0 still runs, so it is decoded at request 0's positions and
    attends request 1's keys below them.  Its tokens therefore depend on
    request 1's prompt, on the reference and, mirrored, on the port."""
    m = models["qwen2-1.5b"]
    rng = np.random.default_rng(3)
    long, third = (rng.integers(0, m["cfg"].vocab, n).tolist() for n in (4, 3))
    runs = {}
    for port in (False, True):
        for second in ([5, 9, 2], [8, 1, 7]):
            reqs = [(0, long, 12), (1, second, 2), (2, third, 4)]
            runs[port, tuple(second)] = _serve(m, 2, 32, reqs, port)[2]
    assert runs[True, (5, 9, 2)] != runs[True, (8, 1, 7)]
    for second in ((5, 9, 2), (8, 1, 7)):
        assert runs[True, second] == runs[False, second]


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen2-vl-2b"])
def test_dense_tick_makes_no_host_copy_or_sync(models, guard, arch):
    """The capture rehearsal of tests/test_torch_graphs.py on the attention
    tick, at degree 1 and on SP_MESH: its second call makes no host copy
    and reads no device value, so it can be captured on the card."""
    m = models[arch]
    tok = torch.tensor([[3], [5]], dtype=torch.int32)
    cur = torch.tensor(2, dtype=torch.int32)
    for mesh, sp in ((None, SP1), (make_mesh(*SP_MESH, device="cpu"),
                                   _sp_cfg("swift"))):
        srv = ARServer(m["tparams"], m["cfg"], sp, batch_slots=2,
                       max_len=16, device="cpu", mesh=mesh)
        nxt, caches = guard(lambda: srv._eager_step(srv.caches, tok, cur))
        assert nxt.shape == (2,) and caches["k"] is srv.caches["k"]


# ---------------------------------------------------------------------------
# SP on virtual ranks, against the reference on 8 fake devices
# ---------------------------------------------------------------------------

def _sp_cfg(strategy):
    return SPConfig(strategy=strategy, sp_axes=("pod", "model"),
                    batch_axes=("data",), machine_axis="pod",
                    comm_backend="pallas", kernel_interpret=False)


_JAX_SP = """
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_reduced
from repro.core import SPConfig
from repro.models import ParallelContext, get_model
d = dict(np.load({inputs!r}))
tree = {{}}
for key, val in d.items():
    if key.startswith("p/"):
        node = tree
        *path, leaf = key[2:].split("/")
        for k in path:
            node = node.setdefault(k, {{}})
        node[leaf] = jnp.asarray(val)
cfg = dataclasses.replace(get_reduced("qwen2-1.5b"), dtype="float32",
                          sharding_overrides=())
bundle = get_model(cfg)
mesh = jax.make_mesh({shape!r}, {axes!r})
tokens = jnp.asarray(d["tokens"])
out = {{}}
for strategy in {strategies!r}:
    sp = SPConfig(strategy=strategy, sp_axes=("pod", "model"),
                  batch_axes=("data",))
    f = jax.jit(lambda p, t: bundle.apply(
        p, {{"tokens": t}}, cfg, ParallelContext(mesh, sp, "prefill")))
    out["prefill/" + strategy] = np.asarray(f(tree, tokens))
sp = SPConfig(strategy="swift", sp_axes=("pod", "model"), batch_axes=("data",))
step = jax.jit(lambda p, b, c, i: bundle.step(
    p, b, c, i, cfg, ParallelContext(mesh, sp, "decode")))
caches = bundle.init_caches(cfg, tokens.shape[0], tokens.shape[1], jnp.float32)
logits = []
for t in range(tokens.shape[1]):
    logit, caches = step(tree, {{"tokens": tokens[:, t:t + 1]}}, caches,
                         jnp.int32(t))
    logits.append(np.asarray(logit))
out["decode"] = np.stack(logits, axis=1)
np.savez({outputs!r}, **out)
"""


def _flat(tree, prefix="p"):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


@pytest.fixture(scope="module")
def jax_sp(models, tmp_path_factory):
    """The reference's qwen2 prefill (swift and swift_torus) and decode on
    SP_MESH over 8 fake devices, in one subprocess (the outer run keeps
    one device)."""
    m = models["qwen2-1.5b"]
    tmp = tmp_path_factory.mktemp("jax_dense_sp")
    tokens = m["batch"]["tokens"][:, :SP_LEN]
    np.savez(tmp / "in.npz", tokens=tokens, **dict(_flat(m["tree"])))
    code = _JAX_SP.format(inputs=str(tmp / "in.npz"),
                          outputs=str(tmp / "out.npz"), shape=SP_MESH[0],
                          axes=SP_MESH[1], strategies=SP_STRATEGIES)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(tmp / "out.npz")), {"tokens": tokens}


def test_sp_plan_is_the_references():
    """On SP_MESH, qwen2-1.5b's full 12 query and 2 KV heads plan the same
    (P_u, P_r) placement in both packages, for swift and swift_torus."""
    mesh = make_mesh(*SP_MESH, device="cpu")
    jmesh = types.SimpleNamespace(shape=dict(zip(SP_MESH[1], SP_MESH[0])))
    cfg = get_config("qwen2-1.5b")
    for strategy in SP_STRATEGIES:
        mine = resolve_layout(_sp_cfg(strategy), mesh, cfg.n_heads,
                              cfg.n_kv_heads)
        ref = j_resolve_layout(JSP(strategy=strategy, sp_axes=("pod", "model"),
                                   batch_axes=("data",)), jmesh, cfg.n_heads,
                               cfg.n_kv_heads)
        assert (mine.p_ulysses, mine.p_ring, mine.ulysses_outer) == (
            ref.p_ulysses, ref.p_ring, ref.ulysses_outer)


@pytest.mark.parametrize("strategy", SP_STRATEGIES)
def test_sp_prefill_matches_reference(models, jax_sp, strategy):
    """Prefill on SP_MESH of virtual ranks: the attention of every layer
    through the SP schedule on the kernel route (K1, K2 and the put
    kernels' plain versions), the batch split over data."""
    want, batch = jax_sp
    ctx = ParallelContext(_sp_cfg(strategy), "prefill",
                          mesh=make_mesh(*SP_MESH, device="cpu"))
    got = _prefill(models["qwen2-1.5b"], batch, ctx)
    assert _rel(got, want[f"prefill/{strategy}"]) <= SP_TOL


def test_sp_decode_matches_reference(models, jax_sp):
    """Decode with the KV cache sharded on L over the 4 SP ranks of
    SP_MESH and the slots over data."""
    want, batch = jax_sp
    ctx = ParallelContext(_sp_cfg("swift"), "decode",
                          mesh=make_mesh(*SP_MESH, device="cpu"))
    got = _decode(models["qwen2-1.5b"], batch, ctx)
    assert _rel(got, want["decode"]) <= SP_TOL


def test_sp_decode_on_pod_mesh_matches_degree_1(models):
    """Decode over 16 SP ranks of (pod 2, model 8), 2 positions per rank,
    starcoder2's window crossing rank boundaries: the degree-1 logits."""
    for arch in ("qwen2-1.5b", "starcoder2-7b"):
        m = models[arch]
        batch = {"tokens": m["batch"]["tokens"][:, :SP_LEN]}
        sp = SPConfig(strategy="swift_torus", sp_axes=("pod", "model"),
                      batch_axes=None, machine_axis="pod")
        ctx = ParallelContext(sp, "decode", mesh=make_mesh(
            (2, 8), ("pod", "model"), device="cpu"))
        one = _decode(m, batch)
        assert _rel(_decode(m, batch, ctx), one) <= SP_TOL


def test_sp_decode_refuses_uneven_shards(models):
    m = models["qwen2-1.5b"]
    ctx = ParallelContext(_sp_cfg("swift"), "decode",
                          mesh=make_mesh(*SP_MESH, device="cpu"))
    with pytest.raises(ValueError, match="split evenly"):
        _decode(m, {"tokens": m["batch"]["tokens"][:, :6]}, ctx)
