"""Training of the port's rwkv6, hybrid and moe families against the
reference on the CPU.

* K5b's plain version (``rwkv6_wkv_bwd_plain``) against autograd of K5's
  plain version, float32, over several (B, L, H, N, chunk), L below the
  chunk among them; ``WKV`` on the CPU runs the plain backward, and a
  forward without grad does not go through it;
* ``check_arch_against_reference``, which test_torch_train_rwkv_hymba.py
  and test_torch_train_moe.py run per reduced arch of these families
  (rwkv6-1.6b, hymba-1.5b, qwen2-moe-a2.7b, arctic-480b; float32,
  constant leaves perturbed, the rwkv6 decays drawn from RWKV6's range):
  the loss and every gradient against ``jax.value_and_grad(bundle.loss)``
  on a 1 x 1 mesh of Auto axes (tests/conftest.py's mesh1 has jax 0.9's
  Explicit axes, on which the reference's untied lm_head einsum raises:
  ROADMAP F2), then the parameters after one AdamW step;
* ``launch/train.py --reduced --device cpu`` for one arch of each family;
* ROADMAP F6: on a chunk whose summed log-decay overflows exp above the
  diagonal, the reference's SSD gradient is non-finite and the port's is
  finite, with the forward bitwise what the port computed before it
  masked the exponent; at small decays both gradients agree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.models import get_model as j_get_model
from repro.models import ssm as jssm
from repro_torch.configs.shapes import InputShape
from repro_torch.kernels import rwkv6_wkv_heads
from repro_torch.kernels.ref import rwkv6_wkv_bwd_plain, rwkv6_wkv_ref
from repro_torch.kernels.rwkv6_wkv import (rwkv6_wkv_heads_bwd,
                                           rwkv6_wkv_heads_bwd_plain)
from repro_torch.launch import train as launch_train
from repro_torch.models import ssm
from repro_torch.train import SyntheticStream
from test_torch_rwkv import perturb_zero_init
from test_torch_train import (SHAPE, T, _cfgs, _perturb, _rel,
                              check_against_reference)

BWD_TOL = 1e-5  # K5b's plain version vs autograd, both f32, of max|grad|
SSD_TOL = 1e-5  # the port's SSD gradient vs the reference's, of max|grad|


# ---------------------------------------------------------------------------
# K5b's plain version and the autograd Function
# ---------------------------------------------------------------------------

# (B, L, H, N, chunk): several chunks, one chunk, L below the chunk
WKV_CASES = {
    "chunks-16": (2, 64, 3, 16, 16),
    "chunks-64": (2, 128, 2, 32, 64),
    "one-chunk": (1, 32, 2, 8, 32),
    "short-L": (3, 24, 2, 8, 64),
    "n64": (1, 128, 1, 64, 64),
}


def _wkv_inputs(case, seed=0):
    """[B, L, H, N] inputs, decays from RWKV6's range exp(-exp(U[-6, -1]))
    (ROADMAP F3), u [H, N], dO."""
    b, l, h, n, _ = case
    rng = np.random.default_rng(seed)
    mk = lambda: T(rng.standard_normal((b, l, h, n)).astype(np.float32))
    r, k, v = mk(), mk(), mk()
    w = T(np.exp(-np.exp(rng.uniform(-6.0, -1.0, (b, l, h, n)))
                 ).astype(np.float32))
    u = T((rng.standard_normal((h, n)) * 0.5).astype(np.float32))
    return r, k, v, w, u, mk()


def _flat(t):
    b, l, h, n = t.shape
    return t.permute(0, 2, 1, 3).reshape(b * h, l, n)


@pytest.mark.parametrize("case", list(WKV_CASES))
def test_wkv_bwd_plain_matches_autograd_of_plain(case):
    """The explicit chunked backward against autograd of rwkv6_wkv_ref, u
    shared by the batch's rows (its gradient summed over them): 1e-5 of
    each gradient's max|grad|."""
    b, l, h, n, chunk = WKV_CASES[case]
    r, k, v, w, u, do = _wkv_inputs(WKV_CASES[case])
    ins = [t.clone().requires_grad_() for t in (r, k, v, w, u)]
    o = rwkv6_wkv_ref(*(_flat(t) for t in ins[:4]), ins[4].repeat(b, 1),
                      chunk=chunk)
    want = torch.autograd.grad(o, ins, _flat(do))
    got = rwkv6_wkv_bwd_plain(*(_flat(t) for t in (r, k, v, w)), u,
                              _flat(do), chunk=chunk)
    for g, x in zip(got, want):
        assert g.shape == (x.shape if x.dim() == 2 else (b * h, l, n))
        assert bool(torch.isfinite(g).all())
        x = x if x.dim() == 2 else _flat(x)
        assert _rel(g.numpy(), x.numpy()) < BWD_TOL


def test_wkv_bwd_plain_per_row_bonus_and_clip_edges():
    """u with one row per (batch, head) row keeps its gradient per row;
    decays at the clip's edges (exactly 1, below 1e-6) follow torch.clamp's
    rule, as autograd of the plain forward does; bfloat16 inputs give
    gradients in their dtypes."""
    b, l, h, n, chunk = 2, 32, 2, 8, 16
    r, k, v, w, _, do = _wkv_inputs((b, l, h, n, chunk), seed=1)
    w[0, 3] = 1.0
    w[1, 5, 0] = 1e-7
    u = torch.randn((b * h, n), generator=torch.Generator().manual_seed(2))
    ins = [t.clone().requires_grad_() for t in
           (_flat(r), _flat(k), _flat(v), _flat(w), u)]
    want = torch.autograd.grad(rwkv6_wkv_ref(*ins, chunk=chunk), ins,
                               _flat(do))
    got = rwkv6_wkv_bwd_plain(*(_flat(t) for t in (r, k, v, w)), u,
                              _flat(do), chunk=chunk)
    for g, x in zip(got, want):
        assert _rel(g.numpy(), x.numpy()) < BWD_TOL
    dw = got[3].reshape(b, h, l, n)
    assert bool((dw[1, 0, 5] == 0).all())  # below the clip: no gradient
    assert bool((dw[0, :, 3] != 0).all())  # at w == 1: passed, as clamp does
    half = [t.to(torch.bfloat16) for t in (r, k, v)]
    out = rwkv6_wkv_heads_bwd_plain(*half, w, u[:h].to(torch.bfloat16), do,
                                    chunk=chunk)
    assert [t.dtype for t in out] == [torch.bfloat16] * 3 + [
        torch.float32, torch.bfloat16]


def test_wkv_function_on_cpu_runs_the_plain_backward():
    """rwkv6_wkv_heads with an input that requires grad goes through WKV,
    whose CPU backward is rwkv6_wkv_heads_bwd_plain (bitwise); without
    grad it returns the plain forward directly; the CPU backward has no
    negative-control switch."""
    case = WKV_CASES["chunks-16"]
    r, k, v, w, u, do = _wkv_inputs(case, seed=3)
    ins = [t.clone().requires_grad_() for t in (r, k, v, w, u)]
    o = rwkv6_wkv_heads(*ins, chunk=case[-1])
    assert o.grad_fn is not None and "WKV" in type(o.grad_fn).__name__
    got = torch.autograd.grad(o, ins, do)
    want = rwkv6_wkv_heads_bwd(r, k, v, w, u, do, chunk=case[-1])
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    with torch.no_grad():
        plain = rwkv6_wkv_heads(*ins, chunk=case[-1])
    assert plain.grad_fn is None and torch.equal(plain, o.detach())
    with pytest.raises(ValueError, match="carries dS"):
        rwkv6_wkv_heads_bwd(r, k, v, w, u, do, chunk=case[-1], carry=False)


# ---------------------------------------------------------------------------
# losses and gradients against jax.value_and_grad on an Auto-axis mesh
# ---------------------------------------------------------------------------

def check_arch_against_reference(arch):
    """The loss and every gradient of reduced ``arch`` against the
    reference's on the 1 x 1 (data, model) mesh with Auto axes, then one
    AdamW step (tests/test_torch_train.py's tolerances).  Constant leaves
    are drawn as tests/test_torch_train.py draws them; the rwkv6 decays,
    mixes and bonus from RWKV6's own ranges as tests/test_torch_rwkv.py
    draws them (near the fresh init, w = 1/e, the reference's own
    gradient is NaN at L 32: ROADMAP F3).  The parametrised tests live in
    test_torch_train_rwkv_hymba.py and test_torch_train_moe.py, so that
    the families' reference runs spread over the run's workers."""
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    cfg, jcfg = _cfgs(arch)
    jb = j_get_model(jcfg)
    params, _ = jb.init(jcfg, jax.random.PRNGKey(0), 1)
    tree = jax.tree.map(np.array, params)
    rng = np.random.default_rng(sum(map(ord, arch)))
    _perturb(tree, rng)
    if cfg.family == "ssm":
        perturb_zero_init(tree, rng)
    batch = SyntheticStream(cfg, InputShape("t", *SHAPE, "training"),
                            seed=3).batch_numpy(0)
    check_against_reference(cfg, jcfg, jb, tree, batch, mesh)


@pytest.mark.parametrize("arch", ("rwkv6-1.6b", "hymba-1.5b",
                                  "qwen2-moe-a2.7b"))  # one of each family
def test_launch_train_reduced_on_cpu(arch, capsys):
    assert launch_train.main(["--arch", arch, "--reduced", "--device", "cpu",
                              "--steps", "2", "--seq", "16", "--batch", "2",
                              "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "tokens/s" in out and "peak memory not measured (cpu)" in out


# ---------------------------------------------------------------------------
# ROADMAP F6: the SSD scan's masked exponent
# ---------------------------------------------------------------------------

def _ssd_inputs(dt_value=None, a=(-1.0, -8.0), seed=0):
    """B 1, L 64, H 2, P 4, N 4 (one chunk of 64); dt ≡ ``dt_value`` or
    drawn small."""
    rng = np.random.default_rng(seed)
    b, l, h, p, n = 1, 64, 2, 4, 4
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = (np.full((b, l, h), dt_value, np.float32) if dt_value is not None
          else rng.uniform(0.01, 0.1, (b, l, h)).astype(np.float32))
    bm = rng.standard_normal((b, l, h, n)).astype(np.float32)
    cm = rng.standard_normal((b, l, h, n)).astype(np.float32)
    g = rng.standard_normal((b, l, h, p)).astype(np.float32)
    return x, dt, bm, cm, np.asarray(a, np.float32), g


def _former_ssd_out(x, dt, bm, cm, a, chunk=64):
    """The port's SSD chunk scan output as it was computed before F6's
    repair (exp over the whole square, then the part above the diagonal
    selected away), for the bitwise check of the forward."""
    b, l, h, p_ = x.shape
    n = bm.shape[-1]
    c = min(chunk, l)
    nc = l // c
    dtf, af = dt.float(), a.float()
    loggam = dtf.reshape(b, nc, c, h) * af
    t_ = torch.cumsum(loggam, dim=2)
    xs_ = (x.float() * dtf[..., None]).reshape(b, nc, c, h, p_)
    bc = bm.float().reshape(b, nc, c, h, n)
    cc = cm.float().reshape(b, nc, c, h, n)
    lmat = torch.exp(t_[:, :, :, None] - t_[:, :, None, :]).permute(
        0, 1, 4, 2, 3)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool))
    lmat = torch.where(tri, lmat, torch.zeros(()))
    cb = torch.einsum("bgthn,bgshn->bghts", cc, bc)
    out = torch.einsum("bghts,bgshp->bgthp", cb * lmat, xs_)
    gam_c = torch.exp(t_[:, :, -1])
    tail = torch.exp(t_[:, :, -1][:, :, None] - t_)
    b_chunk = torch.einsum("bgshp,bgshn->bghpn", tail[..., None] * xs_, bc)
    c_infl = torch.exp(t_)
    s = torch.zeros((b, h, p_, n))
    o_corr = []
    for g in range(nc):
        o_corr.append(torch.einsum("bthn,bhpn->bthp",
                                   c_infl[:, g, ..., None] * cc[:, g], s))
        s = gam_c[:, g, :, None, None] * s + b_chunk[:, g]
    return (out + torch.stack(o_corr, dim=1)).reshape(b, l, h, p_)


def _ssd_grads(args):
    """d⟨out, g⟩ / d(x, dt, bm, cm, a) in both packages."""
    *ins, g = args
    jfn = lambda *t: jnp.sum(jssm.ssd_chunk_scan(*t).out * g)
    jg = jax.jit(jax.grad(jfn, argnums=tuple(range(5))))(
        *map(jnp.asarray, ins))
    tins = [T(t).requires_grad_() for t in ins]
    out = ssm.ssd_chunk_scan(*tins).out
    tg = torch.autograd.grad(out, tins, T(g))
    return [np.asarray(t) for t in jg], [t.numpy() for t in tg], out.detach()


def test_f6_ssd_gradient_finite_where_the_reference_overflows():
    """dt ≡ 0.5 and a = (−1, −8): head 1's summed log-decay over the chunk
    reaches −256, exp(T_t − T_s) above the diagonal overflows, and the
    reference's gradient is 0 · inf = NaN while its forward stays finite.
    The port masks the exponent first: a finite gradient, and the forward
    bitwise what it was."""
    args = _ssd_inputs(dt_value=0.5)
    jg, tg, out = _ssd_grads(args)
    jout = np.asarray(jssm.ssd_chunk_scan(*map(jnp.asarray, args[:5])).out)
    assert np.isfinite(jout).all()
    assert not all(np.isfinite(g).all() for g in jg)  # the reference's F6
    assert all(np.isfinite(g).all() for g in tg)
    assert torch.equal(out, _former_ssd_out(*map(T, args[:5])))


def test_f6_ssd_gradient_matches_reference_at_small_decays():
    """Where the reference's gradient is finite, the port's equals it
    within 1e-5 of each gradient's max, and the forward is bitwise the
    former one."""
    args = _ssd_inputs(seed=1)
    jg, tg, out = _ssd_grads(args)
    for j, t in zip(jg, tg):
        assert np.isfinite(j).all()
        assert _rel(t, j) < SSD_TOL
    assert torch.equal(out, _former_ssd_out(*map(T, args[:5])))
