"""K1 (flash_mqkv) and K2 (ring_flash_step) in the port against the
reference kernels.

The same numpy inputs go through the reference's Pallas kernel in
interpret mode and through the port's entry points, which on CPU tensors
run the kernel's plain PyTorch version.  Cases and tolerances are those of
tests/test_kernels.py.  The CUDA kernel itself is held to the plain version
on the card by tests/test_torch_kernels_cuda.py and chip_smoke.py.  The
tile plans of K1's and K1b's bf16 bodies, which run only on the card, are
checked here on the host, with K1b's bf16 roundings emulated on its plain
formula.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as j_flash
from repro.kernels import flash_attention_segments as j_segments
from repro.kernels.flash_mqkv import flash_mqkv as j_mqkv
from repro.kernels.ring_flash import ring_flash_step as j_ring_step
from repro_torch.kernels import flash_attention, flash_attention_segments
from repro_torch.kernels import flash_mqkv as fm
from repro_torch.kernels import ring_flash as rf
from repro_torch.kernels.ref import flash_mqkv_bwd_plain

TOL = 2e-5


def _mk(seed, b, lq, lk, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, lq, hq, d), (b, lk, hkv, d), (b, lk, hkv, d))]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", [
    (1, 16, 16, 1, 1, 16),
    (2, 64, 64, 4, 2, 32),
    (1, 128, 256, 8, 8, 64),
    (2, 48, 80, 6, 3, 128),   # non-multiple of block -> padding path
])
@pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                           (True, 20)])
def test_shape_sweep_matches_reference(shape, causal, window):
    b, lq, lk, hq, hkv, d = shape
    if causal and lq != lk:
        lk = lq
    q, k, v = _mk(0, b, lq, lk, hq, hkv, d)
    want = j_flash(*_j(q, k, v), causal=causal, window=window, block_q=32,
                   block_k=32, interpret=True)
    got = flash_attention(*_t(q, k, v), causal=causal, window=window,
                          block_q=32, block_k=32)
    _close(got, want)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_dtype_sweep_matches_reference(dtype, tol):
    q, k, v = _mk(1, 2, 64, 64, 4, 2, 64)
    jq, jk, jv = (x.astype(getattr(jnp, dtype)) for x in _j(q, k, v))
    want = j_flash(jq, jk, jv, causal=True, interpret=True)
    tq, tk, tv = (x.to(getattr(torch, dtype)) for x in _t(q, k, v))
    got = flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == getattr(torch, dtype)
    _close(got.float(), np.asarray(want, np.float32), tol)


@pytest.mark.parametrize("group", [1, 2, 4])
def test_gqa_groups_match_reference(group):
    q, k, v = _mk(2, 2, 32, 32, 2 * group, 2, 32)
    want = j_flash(*_j(q, k, v), causal=True, block_q=16, block_k=16,
                   interpret=True)
    got = flash_attention(*_t(q, k, v), causal=True, block_q=16, block_k=16)
    _close(got, want)


def test_discontiguous_positions_match_reference():
    q, k, v = _mk(3, 1, 32, 32, 2, 2, 32)
    q_pos = np.arange(32, dtype=np.int32) + 100
    k_pos = np.concatenate([np.arange(16), np.arange(16) + 110]).astype(np.int32)
    want = j_flash(*_j(q, k, v, q_pos, k_pos), causal=True, block_q=16,
                   block_k=16, interpret=True)
    got = flash_attention(*_t(q, k, v, q_pos, k_pos), causal=True,
                          block_q=16, block_k=16)
    _close(got, want)


def test_state_carry_matches_single_call():
    q, k, v = _mk(4, 1, 32, 64, 2, 2, 32)
    kp = np.arange(64, dtype=np.int32)
    qp = np.arange(32, dtype=np.int32) + 32
    tq, tk, tv, tkp, tqp = _t(q, k, v, kp, qp)
    segs = [(tk[:, :32], tv[:, :32], tkp[:32]), (tk[:, 32:], tv[:, 32:], tkp[32:])]
    got = flash_attention_segments(tq, segs, q_pos=tqp, causal=True,
                                   block_q=16, block_k=16)
    want = j_flash(*_j(q, k, v, qp, kp), causal=True, block_q=16, block_k=16,
                   interpret=True)
    _close(got, want)
    _close(got, flash_attention(tq, tk, tv, tqp, tkp, causal=True))


def test_segment_order_matches_reference():
    q, k, v = _mk(5, 1, 32, 96, 2, 1, 32)
    kp = np.arange(96, dtype=np.int32)
    qp = np.arange(32, dtype=np.int32) + 64
    jq, jk, jv, jkp, jqp = _j(q, k, v, kp, qp)
    tq, tk, tv, tkp, tqp = _t(q, k, v, kp, qp)
    jsegs = [(jk[:, i:i + 32], jv[:, i:i + 32], jkp[i:i + 32]) for i in (0, 32, 64)]
    tsegs = [(tk[:, i:i + 32], tv[:, i:i + 32], tkp[i:i + 32]) for i in (0, 32, 64)]
    want = j_segments(jq, jsegs, q_pos=jqp, causal=True, interpret=True)
    for order in (tsegs, tsegs[::-1]):
        _close(flash_attention_segments(tq, order, q_pos=tqp, causal=True), want)


def test_padding_masked_like_reference():
    """k_pos = -1 marks padding: garbage in padded slots must not leak."""
    q, k, v = _mk(6, 1, 16, 48, 2, 2, 32)
    want = j_flash(*_j(q, k[:, :40], v[:, :40], np.arange(16), np.arange(40)),
                   block_q=16, block_k=16, interpret=True)
    kp = np.where(np.arange(48) < 40, np.arange(48), -1).astype(np.int32)
    k[:, 40:] = 999.0
    v[:, 40:] = 999.0
    got = flash_attention(*_t(q, k, v, np.arange(16, dtype=np.int32), kp),
                          block_q=16, block_k=16)
    _close(got, want)


def test_unnormalized_state_matches_reference():
    """finalize=False returns the FA2-style (O', l, m) mergeable state."""
    b, l, h, d = 1, 32, 2, 32
    q, k, v = _mk(7, b, l, l, h, h, d)
    flat = [x.transpose(0, 2, 1, 3).reshape(b * h, l, d) for x in (q, k, v)]
    pos = np.arange(l, dtype=np.int32)
    want = j_mqkv(*_j(*flat, pos, pos), finalize=False, block_q=16,
                  block_k=16, interpret=True)
    got = fm.flash_mqkv(*_t(*flat, pos, pos), finalize=False)
    for g, w in zip(got, want):
        _close(g, w)


def test_fully_masked_rows_give_zero_state():
    q, k, v = _mk(8, 1, 16, 16, 1, 1, 16)
    flat = _t(*(x[0].transpose(1, 0, 2) for x in (q, k, v)))
    pos = torch.arange(16, dtype=torch.int32)
    o, l, m = fm.flash_mqkv(*flat, pos, pos + 100, causal=True, finalize=False)
    assert torch.all(o == 0) and torch.all(l == 0) and torch.all(torch.isneginf(m))
    o = fm.flash_mqkv(*flat, pos, pos + 100, causal=True)[0]
    assert torch.all(o == 0)


def test_cpu_runs_plain_version_without_launching():
    fm.reset_launch_count()
    q, k, v = _t(*_mk(9, 1, 16, 16, 2, 2, 16))
    flash_attention(q, k, v)
    assert fm.launch_count() == 0


def test_other_devices_raise():
    q = torch.zeros((2, 16, 16), device="meta")
    pos = torch.zeros((16,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fm.flash_mqkv(q, q, q, pos, pos)


# ---------------------------------------------------------------------------
# K2: the fused ring step (cases of tests/test_ring_flash.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_chunks,pad,causal,window", [
    (1, 0, False, None), (2, 5, True, None), (3, 15, True, 24),
    (4, 3, False, 24)])
@pytest.mark.parametrize("dtype,tol", [("float32", TOL), ("bfloat16", 2e-2)])
def test_ring_flash_step_matches_reference(n_chunks, pad, causal, window,
                                           dtype, tol):
    """Chunk by chunk with the state carried, k_pos = -1 padding holding
    garbage: (o, l, m) against the reference's ring_flash_step (interpret
    mode) at its tolerances and bitwise against K1's plain version; the
    forwarded chunk bitwise equal to the input and the completion word
    set."""
    bh, d, bq, bk, lq = 2, 16, 16, 16, 32
    lk = n_chunks * bk
    rng = np.random.default_rng(n_chunks * 31 + pad)
    q, k, v = (rng.standard_normal((bh, n, d)).astype(np.float32)
               for n in (lq, lk, lk))
    qp = np.arange(lq, dtype=np.int32) + lk
    kp = np.where(np.arange(lk) < lk - min(pad, lk - 1), np.arange(lk),
                  -1).astype(np.int32)
    k[:, kp < 0] = 999.0
    v[:, kp < 0] = 999.0
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jstate = tstate = None
    flag = torch.zeros(1, dtype=torch.int32)
    for c in range(n_chunks):
        sl = slice(c * bk, (c + 1) * bk)
        last = c == n_chunks - 1
        kw = dict(causal=causal, window=window, finalize=last)
        (jo, jl, jm), (jkf, jvf) = j_ring_step(
            *(jnp.asarray(x).astype(jdt) for x in (q, k[:, sl], v[:, sl])),
            jnp.asarray(qp), jnp.asarray(kp[sl]), state=jstate, block_q=bq,
            block_k=bk, interpret=True, **kw)
        args = [*(torch.from_numpy(np.ascontiguousarray(x)).to(tdt)
                  for x in (q, k[:, sl], v[:, sl])),
                torch.from_numpy(qp), torch.from_numpy(kp[sl].copy())]
        (o, l, m), (kf, vf) = rf.ring_flash_step(*args, state=tstate,
                                                 flag=flag, epoch=c + 1, **kw)
        for g, w in ((o, jo), (l, jl), (m, jm)):
            _close(g.float(), np.asarray(w, np.float32), tol)
        for g, w in zip((o, l, m), fm.flash_mqkv_plain(
                *args, state=tstate, scale=d ** -0.5, **kw)):
            assert torch.equal(g, w)
        assert torch.equal(kf, args[1]) and torch.equal(vf, args[2])
        np.testing.assert_array_equal(np.asarray(jkf.astype(jnp.float32)),
                                      kf.float().numpy())
        assert int(flag) == c + 1
        jstate, tstate = (jo, jl, jm), (o, l, m)


def test_ring_flash_step_writes_into_given_buffers():
    """The forward buffers may be any preallocated tensors — in the ring
    schedule, the next ring rank's receive buffers."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 16, 16)).astype(
        np.float32)) for _ in range(3))
    pos = torch.arange(16, dtype=torch.int32)
    kd, vd = torch.empty_like(k), torch.empty_like(v)
    rf.reset_launch_count()
    _, (kf, vf) = rf.ring_flash_step(q, k, v, pos, pos, k_dst=kd, v_dst=vd)
    assert kf is kd and vf is vd
    assert torch.equal(kd, k) and torch.equal(vd, v)
    assert rf.launch_count() == 0  # CPU: the plain version


# ---------------------------------------------------------------------------
# the bf16 body's tile plan (csrc/flash_mqkv.cuh runs it only on the card)
# ---------------------------------------------------------------------------

# (BH, Lq, Lk): the flux shapes at degree 1, the ring steps of the SP path
# (BH 6; shards of 272 and 80; gathered Q of 2176 and 640), the grid's
# edge (BH * ceil(Lq / 128) just below, at and above the 132 SMs) and
# single rows
PLAN_SHAPES = [(24, 1280, 1280), (48, 1280, 1280), (24, 4352, 4352),
               (48, 4352, 4352), (6, 272, 272), (6, 2176, 272), (6, 80, 80),
               (6, 640, 80), (6, 2176, 2176), (131, 128, 64), (132, 128, 64),
               (66, 129, 300), (1, 1, 1), (1, 1, 65536)]


@pytest.mark.parametrize("bh,lq,lk", PLAN_SHAPES)
def test_tile_plan_fills_the_card(bh, lq, lk):
    """128-row blocks (two consumer warpgroups) where a grid of them covers
    the 132 SMs, else 64-row blocks; a KV tile has as many keys as the
    block has rows, and at least two tiles are in flight."""
    for d in fm.HEAD_DIMS:
        plan = fm.tile_plan(bh, lq, lk, d)
        want = 64 if bh * -(-lq // 128) < fm.SMS else 128
        assert (plan.bq, plan.bk) == (want, want)
        assert plan.stages >= 2


@pytest.mark.parametrize("d", fm.HEAD_DIMS)
@pytest.mark.parametrize("bh,lq,lk", PLAN_SHAPES)
def test_tile_plan_fits_shared_memory(bh, lq, lk, d):
    """Every plan's tiles fit in the shared memory a block may use on
    Hopper, at every head dim the kernel takes."""
    plan = fm.tile_plan(bh, lq, lk, d)
    assert 0 < fm.smem_bytes(plan, d) <= fm.SMEM_LIMIT


def test_smem_bytes_counts_every_buffer():
    """The formula of Hop::SMEM: alignment slack, Q, K and V per stage,
    mbarriers, k positions and padding flags per stage."""
    plan = fm.TilePlan(bq=128, bk=128, stages=2)
    tiles = 2 * 128 * (128 + 2 * 2 * 128)
    assert fm.smem_bytes(plan, 128) == 1024 + tiles + 8 * 9 + 4 * 2 * 128 + 8
    # two 64-row blocks fit on one SM at D 128: the BQ 64 plan's occupancy
    assert 2 * fm.smem_bytes(fm.TilePlan(64, 64, 2), 128) <= 228 * 1024


# ---------------------------------------------------------------------------
# K1b's bf16 tile plan (csrc/flash_mqkv_bwd.cu runs it only on the card)
# ---------------------------------------------------------------------------

# (BH, group, Lq, Lk, causal): the training shapes (qwen2-1.5b, whisper's
# cross-attention, flux, stablelm, starcoder2's window), GQA edges and
# ragged or single rows
BWD_PLAN_SHAPES = [(48, 6, 1024, 1024, True), (24, 1, 448, 1536, False),
                   (24, 1, 4352, 4352, False), (32, 1, 1024, 1024, True),
                   (36, 9, 4608, 4608, True), (8, 4, 200, 300, True),
                   (12, 12, 130, 333, True), (1, 1, 1, 1, False),
                   (64, 64, 65, 4096, True), (96, 1, 100, 7, False)]


def _dkdv_blocks(plan, bh, group, lk):
    """The dK/dV kernel's blocks as dkdv_hopper_kernel indexes them: grid
    (key-tile columns, KV heads, shares); a block takes key tile x and,
    paired, n - 1 - x, for the q heads of its share of the group."""
    nkt = -(-lk // plan.bk)
    cols = -(-nkt // 2) if plan.pair else nkt
    share = group // plan.splits
    blocks = []
    for z in range(plan.splits):
        for kvh in range(bh // group):
            for x in range(cols):
                tiles = (x,) if not plan.pair or nkt - 1 - x == x else (
                    x, nkt - 1 - x)
                h0 = kvh * group + z * share
                blocks.append((kvh, tiles, range(h0, h0 + share)))
    return blocks


def _visible_q_tiles(plan, key_tile, lq, lk, causal):
    """q tiles of 64 rows that a causal mask leaves visible to a dK/dV key
    tile, with positions q_pos = arange(lk - lq, lk), k_pos = arange(lk)
    (the kernel's maybe_visible on the tiles' position bounds)."""
    k_lo = key_tile * plan.bk
    n = 0
    for qt in range(-(-lq // fm.BWD_TILE)):
        q_hi = lk - lq + min(lq, (qt + 1) * fm.BWD_TILE) - 1
        n += (not causal) or q_hi >= k_lo
    return n


@pytest.mark.parametrize("bh,group,lq,lk,causal", BWD_PLAN_SHAPES)
def test_bwd_tile_plan_fits_shared_memory(bh, group, lq, lk, causal):
    """At every head dim the kernel takes, both kernels' tiles fit in the
    shared memory of a block, and of an SM at the blocks per SM their
    register split assumes (one with two warpgroups, else two)."""
    for d in fm.HEAD_DIMS:
        plan = fm.bwd_tile_plan(bh, group, lq, lk, d, causal)
        kv, q = fm.bwd_smem_bytes(plan, d)
        assert 0 < kv <= fm.SMEM_LIMIT and 0 < q <= fm.SMEM_LIMIT
        assert {1: 2, 2: 1}[plan.kv_wg] * kv <= 228 * 1024
        assert 2 * q <= 228 * 1024  # a dQ block: one warpgroup
        assert plan.kv_wg == (2 if d == 128 else 1)
        assert group % plan.splits == 0


@pytest.mark.parametrize("bh,group,lq,lk,causal", BWD_PLAN_SHAPES)
def test_bwd_tile_plan_covers_every_key_and_row(bh, group, lq, lk, causal):
    """Every (KV head, key tile, q head of its group) belongs to exactly
    one dK/dV block, and the dQ grid covers every row of every head."""
    for d in fm.HEAD_DIMS:
        plan = fm.bwd_tile_plan(bh, group, lq, lk, d, causal)
        seen = [(kvh, t, h) for kvh, tiles, heads in
                _dkdv_blocks(plan, bh, group, lk)
                for t in tiles for h in heads]
        nkt = -(-lk // plan.bk)
        want = [(kvh, t, kvh * group + g) for kvh in range(bh // group)
                for t in range(nkt) for g in range(group)]
        assert sorted(seen) == sorted(want)
        nqb = -(-lq // fm.BWD_TILE)  # dQ blocks of 64 rows a head
        assert nqb * fm.BWD_TILE >= lq > (nqb - 1) * fm.BWD_TILE


def test_bwd_tile_plan_balances_causal_work_at_qwen2():
    """At qwen2-1.5b's training shape (BH 48, 8 KV heads, L 1024, D 128,
    causal) key tile j sees 16 - 2j q tiles: pairing j with 7 - j gives
    every dK/dV block the same 18 steps per q head, and splitting the
    group in 3 fills the SMs in one wave (96 blocks of 36 steps), where
    unpaired, unsplit blocks would range from 2 to 16 steps on 64 SMs."""
    bh, group, l = 48, 6, 1024
    plan = fm.bwd_tile_plan(bh, group, l, l, 128, causal=True)
    assert (plan.kv_wg, plan.splits, plan.pair) == (2, 3, True)
    blocks = _dkdv_blocks(plan, bh, group, l)
    work = [len(heads) * sum(_visible_q_tiles(plan, t, l, l, True)
                             for t in tiles) for _, tiles, heads in blocks]
    assert len(blocks) == 96 <= fm.SMS
    assert min(work) == max(work) == 36
    unpaired = dataclasses.replace(plan, pair=False, splits=1)
    steps = [_visible_q_tiles(unpaired, t, l, l, True) for t in range(8)]
    assert steps == [16 - 2 * j for j in range(8)]


def test_bwd_smem_bytes_counts_every_buffer():
    """The formulas of KvTiles::SMEM and QTiles::SMEM at D 128 (dK/dV:
    two warpgroups) and D 64 (one)."""
    plan = fm.bwd_tile_plan(48, 6, 1024, 1024, 128, True)
    kv = 1024 + 2 * 128 * (2 * 128 + 2 * 2 * 64) + 8 * 6 + 16 * 2 * 64
    q = 1024 + 2 * 128 * (2 * 64 + 2 * 2 * 64) + 8 * 5 + 4 * 2 * 64
    assert fm.bwd_smem_bytes(plan, 128) == (kv, q) == (134_192, 99_880)
    plan = fm.bwd_tile_plan(24, 1, 448, 1536, 64)
    assert fm.bwd_smem_bytes(plan, 64) == (52_272, 50_728)


# small versions of the card's K1B cases (tests/test_torch_kernels_cuda.py):
# (bh, hkv, lq, lk, d, causal, window, padded keys, a fully masked row)
K1B_SMALL = {
    "causal-gqa": (8, 2, 96, 96, 128, True, None, 0, False),
    "window": (4, 4, 130, 130, 64, True, 33, 0, False),
    "cross": (6, 6, 45, 150, 64, False, None, 0, False),
    "pad-dead-row": (4, 2, 40, 72, 32, True, None, 9, True),
    "head-dim-80": (6, 2, 70, 70, 80, True, None, 0, False),
    "d16": (2, 1, 33, 17, 16, False, None, 3, False),
}


def _bwd_bf16_rounded(q, k, v, o, do, m, l, q_pos, k_pos, *, group, scale,
                      causal, window):
    """kernels/ref.py's flash_mqkv_bwd_plain with P and dS rounded to bf16
    before the second products (dV = Pᵀ dO, dK = dSᵀ Q, dQ = dS K), as
    K1b's bf16 body packs them into the A operands of its wgmma."""
    r = lambda t: t.to(torch.bfloat16).float()
    kf = k.repeat_interleave(group, dim=0)
    vf = v.repeat_interleave(group, dim=0)
    delta = (do * o).sum(dim=-1)
    s = torch.einsum("bqd,bkd->bqk", q, kf) * scale
    ok = (k_pos >= 0)[None, :]
    if causal:
        ok = ok & (q_pos[:, None] >= k_pos[None, :])
    if window is not None:
        ok = ok & (k_pos[None, :] > q_pos[:, None] - window)
    live = l > 0.0
    p = torch.exp(s - torch.where(live, m, 0.0)[..., None]) / torch.where(
        live, l, 1.0)[..., None]
    p = torch.where(ok[None] & live[..., None], p, 0.0)
    ds = p * (torch.einsum("bqd,bkd->bqk", do, vf) - delta[..., None])
    p, ds = r(p), r(ds)
    dv = torch.einsum("bqk,bqd->bkd", p, do)
    dq = torch.einsum("bqk,bkd->bqd", ds, kf) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, q) * scale
    bhkv, lk, d = k.shape
    return (dq, dk.reshape(bhkv, group, lk, d).sum(dim=1),
            dv.reshape(bhkv, group, lk, d).sum(dim=1))


@pytest.mark.parametrize("case", list(K1B_SMALL))
def test_bwd_bf16_rounding_stays_within_the_gate(case):
    """Rounding P and dS to bf16 before the second products (the bf16
    body's only roundings besides its bf16 inputs and outputs) keeps every
    gradient within 2e-2 of max|ref| of the f32 plain backward on the same
    bf16-valued inputs: the card's gate leaves room for the design."""
    bh, hkv, lq, lk, d, causal, window, pad, dead = K1B_SMALL[case]
    rng = np.random.default_rng(23)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(torch.bfloat16).float()
    q, k, v, do = mk(bh, lq, d), mk(hkv, lk, d), mk(hkv, lk, d), mk(bh, lq, d)
    q_pos = torch.arange(lk - lq, lk, dtype=torch.int32)
    k_pos = torch.arange(lk, dtype=torch.int32)
    if pad:
        k_pos[-pad:] = -1
    if dead:  # row 0 sees only keys at positions <= 0, and those are padding
        k_pos[:4] = -1
        q_pos[0] = 0
    kw = dict(group=bh // hkv, scale=d ** -0.5, causal=causal, window=window)
    o, l, m = fm.flash_mqkv_plain(q, k, v, q_pos, k_pos, **kw)
    want = flash_mqkv_bwd_plain(q, k, v, o, do, m, l, q_pos, k_pos, **kw)
    got = _bwd_bf16_rounded(q, k, v, o, do, m, l, q_pos, k_pos, **kw)
    errs = []
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        errs.append(float((g - w).abs().max() / w.abs().max()))
    assert 0 < max(errs) <= 2e-2, errs
    if dead:
        assert bool((got[0][l == 0] == 0).all())
