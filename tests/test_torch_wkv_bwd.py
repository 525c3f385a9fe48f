"""K5b's plain version (kernels/ref.py:rwkv6_wkv_bwd_plain) and its launch
plan (kernels/rwkv6_wkv.py:k5b_plan), on the CPU.

The plain backward runs the three passes the CUDA kernel runs: the
chunks' entry states, the gradients of their exit states, then each
chunk's gradients given both.  Here:

* it is bitwise the single-sweep form it was split from (a forward sweep
  for the entry states, then one backward sweep carrying dS), kept below;
* the chunk pass run over the chunks in a shuffled order gives bitwise the
  same gradients: a chunk reads nothing of the others but S_in and dS;
* its gradients match ``jax.vjp`` of the reference's
  ``repro.models.ssm.rwkv6_chunk_scan(...).out`` within 1e-5 of each
  gradient's max|ref| in float32 (decays from RWKV6's range, ROADMAP F3);
* ``k5b_plan`` keeps every block within the card's shared memory, two
  blocks of the chunk pass and of the states' launch a SM at (64, 64), and
  gives the grids of rwkv6-1.6b's training shape.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.kernels.ref import (WKV_EPS, rwkv6_wkv_bwd_plain,
                                     wkv_bwd_chunk, wkv_bwd_entry_states,
                                     wkv_bwd_exit_grads, wkv_bwd_operands,
                                     wkv_chunk)

# the module (kernels/__init__.py exports its function under the same name)
wkv = importlib.import_module("repro_torch.kernels.rwkv6_wkv")

VJP_TOL = 1e-5  # plain gradients vs jax.vjp, float32, of max|ref|
SHAPE = (2, 96, 2, 16, 32)  # (B, L, H, N, chunk): three chunks
T = lambda a: torch.from_numpy(np.ascontiguousarray(a))


def _inputs(b, l, h, n, seed=0):
    """[B, L, H, N] float32 r, k, v, dO, decays exp(-exp(U[-6, -1])) and u
    [H, N], from a numpy seed."""
    rng = np.random.default_rng(seed)
    mk = lambda: rng.standard_normal((b, l, h, n)).astype(np.float32)
    r, k, v, do = mk(), mk(), mk(), mk()
    w = np.exp(-np.exp(rng.uniform(-6.0, -1.0, (b, l, h, n)))).astype(
        np.float32)
    u = (rng.standard_normal((h, n)) * 0.5).astype(np.float32)
    return r, k, v, w, u, do


def _flat(t):
    b, l, h, n = t.shape
    return t.permute(0, 2, 1, 3).reshape(b * h, l, n)


def _single_sweep(r, k, v, w, u, do, *, chunk):
    """The backward as one function: a forward sweep for the entry states,
    then one backward sweep over the chunks carrying dS (the form the
    three-pass plain version was split from, kept as the bitwise yardstick
    of the split)."""
    bh, l, n = r.shape
    rows = u.shape[0]
    c = wkv_chunk(l, chunk)
    nc = l // c
    f = lambda t: t.float().reshape(bh, nc, c, n)
    rf, kf, vf, wf, dof = f(r), f(k), f(v), f(w), f(do)
    wc = torch.clamp(wf, WKV_EPS, 1.0)
    logw = torch.log(wc)
    log_d = torch.cumsum(logw, dim=2)
    d = torch.exp(log_d)
    d_m1 = torch.exp(log_d - logw)
    r_sc = rf * d_m1
    k_sc = kf / d
    a_c = d[:, :, -1]
    ur = u.float().repeat(bh // rows, 1)
    s = torch.zeros((bh, n, n), dtype=torch.float32)
    s_in = []
    for g in range(nc):
        s_in.append(s)
        s = a_c[:, g, :, None] * s + torch.einsum(
            "bsn,bsm->bnm", k_sc[:, g] * a_c[:, g, None, :], vf[:, g])
    below = torch.tril(torch.ones((c, c), dtype=torch.bool), diagonal=-1)
    grads = [torch.empty_like(rf) for _ in range(4)]
    du = torch.zeros((bh, n), dtype=torch.float32)
    ds = torch.zeros((bh, n, n), dtype=torch.float32)
    for g in reversed(range(nc)):
        rs, ks, vg, dog, a = r_sc[:, g], k_sc[:, g], vf[:, g], dof[:, g], a_c[:, g]
        att = torch.einsum("btn,bsn->bts", rs, ks).masked_fill(~below, 0.0)
        dov = torch.einsum("btm,bsm->bts", dog, vg)
        datt = dov.masked_fill(~below, 0.0)
        bd = torch.diagonal(dov, dim1=1, dim2=2)
        bonus = (rf[:, g] * ur[:, None] * kf[:, g]).sum(dim=-1)
        x = torch.einsum("bsm,bnm->bsn", vg, ds)
        grads[2][:, g] = (torch.einsum("bts,btm->bsm", att, dog)
                          + bonus[..., None] * dog
                          + torch.einsum("bsn,bnm->bsm", ks * a[:, None], ds))
        drs = (torch.einsum("bts,bsn->btn", datt, ks)
               + torch.einsum("btm,bnm->btn", dog, s_in[g]))
        dks = torch.einsum("bts,btn->bsn", datt, rs) + a[:, None] * x
        da = (s_in[g] * ds).sum(dim=-1) + (ks * x).sum(dim=1)
        ds = a[..., None] * ds + torch.einsum("btn,btm->bnm", rs, dog)
        p, q = drs * rs, dks * ks
        rev = lambda t: torch.flip(torch.cumsum(torch.flip(t, (1,)), 1), (1,))
        dlogw = rev(p) - p - rev(q) + (da * a)[:, None]
        grads[0][:, g] = drs * d_m1[:, g] + ur[:, None] * kf[:, g] * bd[..., None]
        grads[1][:, g] = dks / d[:, g] + ur[:, None] * rf[:, g] * bd[..., None]
        inside = (wf[:, g] >= WKV_EPS) & (wf[:, g] <= 1.0)
        grads[3][:, g] = torch.where(inside, dlogw / wc[:, g], 0.0)
        du += (rf[:, g] * kf[:, g] * bd[..., None]).sum(dim=1)
    du = du.reshape(bh // rows, rows, n).sum(dim=0)
    return (*(gr.reshape(bh, l, n).to(t.dtype)
              for gr, t in zip(grads, (r, k, v, w))), du.to(u.dtype))


# (B, L, H, N, chunk, u rows per head or per row)
SPLIT_CASES = {
    "three-chunks": (2, 96, 2, 16, 32, "head"),
    "n64": (1, 128, 1, 64, 64, "head"),
    "short-L": (3, 24, 2, 8, 64, "head"),
    "per-row-u": (2, 64, 3, 16, 16, "row"),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_plain_backward_is_bitwise_the_single_sweep(case):
    b, l, h, n, chunk, urows = SPLIT_CASES[case]
    r, k, v, w, u, do = (T(x) for x in _inputs(b, l, h, n, seed=1))
    if urows == "row":
        u = T(np.random.default_rng(2).standard_normal((b * h, n)).astype(
            np.float32))
    args = (*(_flat(t) for t in (r, k, v, w)), u, _flat(do))
    got = rwkv6_wkv_bwd_plain(*args, chunk=chunk)
    want = _single_sweep(*args, chunk=chunk)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_chunk_pass_is_independent_of_chunk_order():
    """Each chunk's gradients from its S_in and dS alone: the chunk pass in
    a shuffled order gives bitwise what it gives in order."""
    b, l, h, n, chunk = SHAPE
    r, k, v, w, u, do = (T(x) for x in _inputs(b, l, h, n, seed=3))
    ops = wkv_bwd_operands(*(_flat(t) for t in (r, k, v, w)), u, _flat(do),
                           chunk=chunk)
    s_in, ds = wkv_bwd_entry_states(ops), wkv_bwd_exit_grads(ops)
    nc = ops["nc"]
    assert nc == 3
    in_order = [wkv_bwd_chunk(ops, g, s_in[g], ds[g]) for g in range(nc)]
    order = (1, 2, 0)  # neither forward nor backward
    shuffled = {g: wkv_bwd_chunk(ops, g, s_in[g], ds[g]) for g in order}
    for g in range(nc):
        assert all(torch.equal(x, y) for x, y in zip(in_order[g], shuffled[g]))
    # and the assembled gradients are the plain version's
    full = rwkv6_wkv_bwd_plain(*(_flat(t) for t in (r, k, v, w)), u,
                               _flat(do), chunk=chunk)
    dv = torch.cat([shuffled[g][2] for g in range(nc)], dim=1)
    assert torch.equal(dv, full[2])


def test_plain_gradients_match_jax_vjp_of_the_reference():
    """dr, dk, dv, dw, du of the plain backward (u per head: its gradient
    summed over the batch) against jax.vjp of rwkv6_chunk_scan(...).out,
    float32, within VJP_TOL of each gradient's max|ref|."""
    b, l, h, n, chunk = SHAPE
    r, k, v, w, u, do = _inputs(b, l, h, n, seed=5)
    out, vjp = jax.vjp(lambda *a: jssm.rwkv6_chunk_scan(*a, chunk=chunk).out,
                       *(jnp.asarray(x) for x in (r, k, v, w, u)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    got = wkv.rwkv6_wkv_heads_bwd_plain(*(T(x) for x in (r, k, v, w, u, do)),
                                        chunk=chunk)
    for name, g, x in zip(("dr", "dk", "dv", "dw", "du"), got, want):
        assert g.shape == x.shape, name
        assert bool(torch.isfinite(g).all()), name
        err = float(np.abs(g.numpy() - x).max() / np.abs(x).max())
        assert err < VJP_TOL, (name, err)


def test_k5b_plan_limits():
    """Every (chunk, N) the kernel takes fits a block's shared memory (each
    value split of the states' launch too); at (64, 64) two blocks of each
    launch share an SM; the grids of rwkv6-1.6b's training shape (B 4 x L
    1024 x H 32 x N 64, chunk 64, 132 SMs) and of a row count that the
    states' launch splits (B 1 x H 4)."""
    for c in wkv.SIZES:
        for n in wkv.SIZES:
            plan = wkv.k5b_plan(1, 1, 4 * c, n, c, 132)
            assert 0 < plan["chunks"]["smem"] <= wkv.SMEM_LIMIT
            for split in wkv.SPLITS:
                if n // split >= wkv.MIN_SPLIT_COLUMNS or split == 1:
                    assert 0 < wkv.k5b_smem("chain", c, n, split) \
                        <= wkv.SMEM_LIMIT
    big = wkv.k5b_plan(1, 1, 64, 64, 64, 132)
    assert big["chunks"]["per_sm"] >= 2 and big["chain"]["per_sm"] >= 2
    train = wkv.k5b_plan(4, 32, 1024, 64, 64, 132)
    assert train["split"] == 1
    assert train["chain"]["grid"] == (128, 1, 2)
    assert train["chunks"]["grid"] == (2048,)
    assert train["du"]["grid"] == (8,)
    assert train["scratch_bytes"] == 4 * 128 * 16 * 64 * (2 * 64 + 1)
    few = wkv.k5b_plan(1, 4, 1024, 64, 64, 132)
    assert few["split"] == 4 and few["chain"]["grid"] == (4, 4, 2)
    with pytest.raises(ValueError):
        wkv.k5b_plan(1, 1, 64, 48, 64, 132)
