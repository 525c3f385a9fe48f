"""The port's whisper-tiny (models/whisper.py, the audio family) against
the reference on the CPU, on its reduced config in float32 (encoder_seq
64, d 128, 2 + 2 layers; decoder prompts of 24 tokens, so cross-attention
has Lq != Lk).

* prefill logits against the reference's ``bundle.apply`` (1e-5 of
  max|logits|), and the encoder's memory against ``encode``;
* decode step by step with caches against the reference's jitted
  ``bundle.step`` (5e-5, the decode tolerance of
  tests/test_decode_consistency.py), and against the port's own prefill;
* parameter carry-over: ``init_whisper`` mirrors the reference's tree,
  ``load_jax_whisper_params`` splits its stacked layers.

Parameters are the reference's ``init_whisper`` with biases and norms
drawn small first (the reference starts them at zero and one).
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
from repro.models import whisper as j_whisper
from repro_torch.configs import get_reduced
from repro_torch.core import SPConfig
from repro_torch.models import (ParallelContext, get_model, init_whisper,
                                init_whisper_caches, load_jax_whisper_params)
from repro_torch.models import whisper as t_whisper
from repro_torch.models.blocks import sinusoidal_embedding, sinusoidal_rows

CPU = torch.device("cpu")
T = lambda a: torch.from_numpy(np.array(a))
J_SP = JSP(strategy="full", sp_axes=("model",), batch_axes=("data",))
SP1 = SPConfig(strategy="full")
PREFILL_TOL = 1e-5  # of max|logits|
DECODE_TOL = 5e-5  # tests/test_decode_consistency.py
B, L = 2, 24
ARCH = "whisper-tiny"


def _perturb(tree, rng):
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            _perturb(leaf, rng)
        elif name in ("b", "bias", "scale"):
            noise = (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)
            tree[name] = (noise + 1.0) if name == "scale" else noise


@pytest.fixture(scope="module")
def model(mesh1):
    f32 = dict(dtype="float32", sharding_overrides=())
    cfg = dataclasses.replace(get_reduced(ARCH), **f32)
    jcfg = dataclasses.replace(j_get_reduced(ARCH), **f32)
    jb = j_get_model(jcfg)
    params, _ = jb.init(jcfg, jax.random.PRNGKey(0), 1)
    tree = jax.tree.map(np.array, params)
    rng = np.random.default_rng(5)
    _perturb(tree, rng)
    batch = {
        "frames": (rng.standard_normal((B, cfg.encoder_seq, cfg.d_model))
                   * 0.5).astype(np.float32),
        "tokens": rng.integers(0, cfg.vocab, (B, L)).astype(np.int32),
    }
    return dict(cfg=cfg, jcfg=jcfg, jb=jb, tree=tree,
                jparams=jax.tree.map(jnp.asarray, tree),
                tparams=load_jax_whisper_params(tree, cfg, device="cpu"),
                batch=batch, mesh1=mesh1)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_prefill_matches_reference(model):
    m = model
    jctx = JCtx(m["mesh1"], J_SP, "prefill")
    jb = {k: jnp.asarray(v) for k, v in m["batch"].items()}
    want = np.asarray(m["jb"].apply(m["jparams"], jb, m["jcfg"], jctx))
    ctx = ParallelContext(SP1, "prefill", CPU)
    with torch.inference_mode():
        got = get_model(m["cfg"]).apply(
            m["tparams"], {k: T(v) for k, v in m["batch"].items()}, m["cfg"],
            ctx).numpy()
        mem = t_whisper.encode(m["tparams"], T(m["batch"]["frames"]),
                               m["cfg"], ctx).numpy()
    assert got.shape == (B, L, m["cfg"].vocab)
    assert _rel(got, want) < PREFILL_TOL
    jmem = j_whisper.encode(m["jparams"], jb["frames"], m["jcfg"], jctx)
    assert _rel(mem, np.asarray(jmem)) < PREFILL_TOL


@pytest.fixture(scope="module")
def decoded(model):
    """Teacher-forced decode of the prompt, one token per step, in both
    packages from the same encoder memory: per-step logits [B, L, V]."""
    m = model
    cfg, jcfg = m["cfg"], m["jcfg"]
    jctx = JCtx(m["mesh1"], J_SP, "decode")
    memory = np.asarray(j_whisper.encode(
        m["jparams"], jnp.asarray(m["batch"]["frames"]), jcfg,
        JCtx(m["mesh1"], J_SP, "prefill")))
    jstep = jax.jit(lambda p, b, c, i: m["jb"].step(p, b, c, i, jcfg, jctx))
    jc = j_whisper.init_whisper_caches(jcfg, B, L, jnp.float32)
    ctx = ParallelContext(SP1, "decode", CPU)
    tc = init_whisper_caches(cfg, B, L, torch.float32, device="cpu")
    bundle = get_model(cfg)
    toks = m["batch"]["tokens"]
    ref, got = [], []
    for t in range(L):
        jl, jc = jstep(m["jparams"], {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                      "encoder_out": jnp.asarray(memory)},
                       jc, jnp.int32(t))
        ref.append(np.asarray(jl))
        with torch.inference_mode():
            tl, tc2 = bundle.step(m["tparams"],
                                  {"tokens": T(toks[:, t:t + 1]),
                                   "encoder_out": T(memory)}, tc, t, cfg, ctx)
        assert tc2 is tc  # written in place
        got.append(tl.numpy())
    return np.stack(got, 1), np.stack(ref, 1), memory


def test_decode_matches_reference_step(decoded):
    got, ref, _ = decoded
    assert _rel(got, ref) < DECODE_TOL


def test_decode_matches_own_prefill(model, decoded):
    m = model
    got, _, memory = decoded
    with torch.inference_mode():
        logits, caches = t_whisper.decode_forward(
            m["tparams"], m["cfg"], ParallelContext(SP1, "prefill", CPU),
            tokens=T(m["batch"]["tokens"]), memory=T(memory))
    assert caches is None
    assert _rel(got, logits.numpy()) < DECODE_TOL


def test_decode_position_row_is_the_table_row():
    """The one row decode computes is bitwise the row of the port's table
    (the same f32 products), and the reference's row to within the angle's
    rounding: XLA may take the frequencies' division as a product by the
    reciprocal, an ulp off, and at position 300 an ulp of the angle is
    ~3e-5."""
    idx = torch.tensor(300)
    row = sinusoidal_rows(idx, 384)
    np.testing.assert_array_equal(row.numpy(),
                                  sinusoidal_embedding(301, 384)[300].numpy())
    from repro.models.blocks import sinusoidal_embedding as j_table
    np.testing.assert_allclose(row.numpy(), np.asarray(j_table(301, 384)[300]),
                               rtol=0, atol=1e-4)


def test_init_mirrors_reference_and_params_carry_over(model):
    m = model
    cfg = m["cfg"]
    mine = init_whisper(cfg, torch.Generator().manual_seed(0), device="cpu")
    shape = lambda t: tuple(t.shape)
    ref = jax.tree.map(lambda a: tuple(a.shape), m["jparams"])
    for stack, n in (("enc_layers", cfg.encoder_layers),
                     ("dec_layers", cfg.n_layers)):
        per_layer = jax.tree.map(lambda s: s[1:], ref.pop(stack),
                                 is_leaf=lambda x: isinstance(x, tuple))
        assert len(mine[stack]) == len(m["tparams"][stack]) == n
        for lp, tp in zip(mine[stack], m["tparams"][stack]):
            assert jax.tree.map(shape, lp) == per_layer
            assert jax.tree.map(shape, tp) == per_layer
    assert jax.tree.map(shape, {k: v for k, v in mine.items()
                                if not k.endswith("layers")}) == ref
    # layer i of the loaded params is slice i of the reference's stack
    for i in range(cfg.n_layers):
        np.testing.assert_array_equal(
            m["tparams"]["dec_layers"][i]["cross_attn"]["wk"]["w"].numpy(),
            m["tree"]["dec_layers"]["cross_attn"]["wk"]["w"][i])
    with pytest.raises(ValueError, match="audio"):
        init_whisper(get_reduced("qwen2-1.5b"), device="cpu")
