"""The port's CUDA kernels against their plain PyTorch versions, on the
card: K1 (flash_mqkv), its gradient K1b (flash_mqkv_bwd), K2
(ring_flash_step), K3 (remote_put), K4 (landing_copy) and K5 (rwkv6_wkv),
and the SP schedule that runs them.

Every test here is marked ``needs_cuda`` and skips without a GPU.  The
file imports neither jax nor the reference package, so it also runs on a
machine without jax, where tests/conftest.py (which imports jax) has to be
left out:

    PYTHONPATH=src python -m pytest --noconftest -m needs_cuda \
        tests/test_torch_kernels_cuda.py
"""
import importlib

import pytest
import torch

from repro_torch.comm import kernel_backend as kb
from repro_torch.core import SPConfig, sp_attention
from repro_torch.kernels import flash_attention, flash_attention_segments
from repro_torch.kernels import flash_mqkv as fm
from repro_torch.kernels import ring_flash as rf
from repro_torch.kernels.ref import flash_mqkv_bwd_plain, rwkv6_wkv_ref
from repro_torch.launch import make_mesh

# the module (kernels/__init__.py exports its function under the same name)
wkv = importlib.import_module("repro_torch.kernels.rwkv6_wkv")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal,window,group", [(False, None, 1),
                                                 (True, 20, 2)])
def test_cuda_kernel_matches_plain(cuda, dtype, tol, d, causal, window, group):
    gen = torch.Generator(device=cuda).manual_seed(d)
    mk = lambda *s: torch.randn(s, generator=gen, device=cuda).to(dtype)
    q, k, v = mk(4, 75, d), mk(4 // group, 75, d), mk(4 // group, 75, d)
    pos = torch.arange(75, dtype=torch.int32, device=cuda)
    before = fm.launch_count()
    got = fm.flash_mqkv(q, k, v, pos, pos, group=group, causal=causal,
                        window=window, finalize=False)
    assert fm.launch_count() == before + 1
    want = fm.flash_mqkv_plain(q, k, v, pos, pos, group=group, causal=causal,
                               window=window, finalize=False)
    for g, w in zip(got, want):
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) / scale <= tol


@pytest.mark.needs_cuda
def test_cuda_kernel_rejects_what_it_does_not_take(cuda):
    """A head dim above the largest instantiation (those between run
    zero-padded: test_cuda_kernel_pads_other_head_dims) and a dtype other
    than float32 and bfloat16."""
    q = torch.zeros((2, 16, 160), device=cuda)
    pos = torch.arange(16, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        fm.flash_mqkv(q, q, q, pos, pos)
    q = torch.zeros((2, 16, 32), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        fm.flash_mqkv(q, q, q, pos, pos)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [48, 80])
@pytest.mark.parametrize("state", [False, True])
def test_cuda_kernel_pads_other_head_dims(cuda, dtype, tol, d, state):
    """A head dim between the instantiations (stablelm-3b's 80) launches
    once at the next one up, zero-padded, with the true head dim's scale:
    (o, l, m) as the plain version's at d, a carried o' included."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    mk = lambda *s: torch.randn(s, generator=gen, device=cuda).to(dtype)
    q, k, v = mk(6, 70, d), mk(2, 90, d), mk(2, 90, d)
    qp = torch.arange(70, dtype=torch.int32, device=cuda) + 20
    kp = torch.arange(90, dtype=torch.int32, device=cuda)
    kw = dict(group=3, causal=True, window=40, finalize=not state)
    if state:
        kw["state"] = fm.flash_mqkv_plain(q, k, v, qp, kp, group=3,
                                          scale=d ** -0.5, finalize=False)
    before = fm.launch_count()
    got = fm.flash_mqkv(q, k, v, qp, kp, **kw)
    assert fm.launch_count() == before + 1
    want = fm.flash_mqkv_plain(q, k, v, qp, kp, scale=d ** -0.5, **kw)
    assert got[0].shape == (6, 70, d) and got[0].is_contiguous()
    for g, w in zip(got, want):
        scale = max(1.0, float(w.float().abs().max()))
        assert float((g.float() - w.float()).abs().max()) / scale <= tol


@pytest.mark.needs_cuda
@pytest.mark.parametrize("hq,hkv,window", [(12, 2, None), (36, 4, 300),
                                           (32, 2, None)])
def test_cuda_causal_gqa_matches_plain(cuda, hq, hkv, window):
    """The dense LMs' prefill through flash_attention: causal GQA with the
    groups of qwen2-1.5b (6), starcoder2-7b (9, window) and chatglm3-6b
    (16), bf16, against the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(hq)
    mk = lambda h: torch.randn((1, 700, h, 128), generator=gen,
                               device=cuda).to(torch.bfloat16)
    q, k, v = mk(hq), mk(hkv), mk(hkv)
    before = fm.launch_count()
    got = flash_attention(q, k, v, causal=True, window=window)
    assert fm.launch_count() == before + 1
    want = flash_attention(q.cpu(), k.cpu(), v.cpu(), causal=True,
                           window=window)
    assert float((got.cpu().float() - want.float()).abs().max()) <= 2e-2


@pytest.mark.needs_cuda
@pytest.mark.parametrize("window", [48, 1 << 30])
def test_cuda_hymba_attention_matches_plain(cuda, window):
    """hymba-1.5b's prefill through flash_attention: head dim 64, GQA 5
    (25 query over 5 KV heads), causal, under a window shorter than L and
    under the reference's GLOBAL_WINDOW 1 << 30 (its global layers), bf16,
    against the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(window % 97)
    mk = lambda h: torch.randn((2, 300, h, 64), generator=gen,
                               device=cuda).to(torch.bfloat16)
    q, k, v = mk(25), mk(5), mk(5)
    before = fm.launch_count()
    got = flash_attention(q, k, v, causal=True, window=window)
    assert fm.launch_count() == before + 1
    want = flash_attention(q.cpu(), k.cpu(), v.cpu(), causal=True,
                           window=window)
    assert float((got.cpu().float() - want.float()).abs().max()) <= 2e-2


@pytest.mark.needs_cuda
def test_cuda_swift_torus_head_dim_80_matches_cpu(cuda):
    """SP at head dim 80 on mesh (pod 2, model 4) (8 / 4 heads: P_u 4 x
    P_r 2): the ring path pads the chunks it circulates to 128 once, K1 and
    K2 launch, causal masks on discontiguous chunks; the CPU's plain route
    at D 80 is the oracle."""
    gen = torch.Generator().manual_seed(80)
    q, k, v = (torch.randn((2, 64, h, 80), generator=gen) for h in (8, 4, 4))
    cfg = SPConfig(strategy="swift_torus", sp_axes=("pod", "model"),
                   batch_axes=None, comm_backend="pallas",
                   kernel_interpret=False)
    want = sp_attention(q, k, v, cfg=cfg,
                        mesh=make_mesh((2, 4), ("pod", "model"), "cpu"),
                        causal=True)
    before = (fm.launch_count(), rf.launch_count())
    got = sp_attention(q.to(cuda), k.to(cuda), v.to(cuda), cfg=cfg,
                       mesh=make_mesh((2, 4), ("pod", "model"), cuda),
                       causal=True)
    assert fm.launch_count() > before[0] and rf.launch_count() > before[1]
    assert got.shape == want.shape
    assert float((got.cpu() - want).abs().max()) <= 1e-4


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_ops_match_cpu(cuda, dtype, tol):
    """The [B, L, H, D] entry points on the card (padding, GQA, carried
    state over segments) against the same calls on the CPU."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((2, 48, 6, 128), generator=gen).to(dtype)
    k = torch.randn((2, 80, 3, 128), generator=gen).to(dtype)
    v = torch.randn((2, 80, 3, 128), generator=gen).to(dtype)
    kp = torch.arange(80, dtype=torch.int32)
    qp = kp[:48] + 32
    segs = lambda dev: [(k[:, :40].to(dev), v[:, :40].to(dev), kp[:40].to(dev)),
                        (k[:, 40:].to(dev), v[:, 40:].to(dev), kp[40:].to(dev))]
    for fn, args in ((flash_attention, lambda dev: (k.to(dev), v.to(dev),
                                                    qp.to(dev), kp.to(dev))),
                     (flash_attention_segments, lambda dev: (segs(dev),
                                                             qp.to(dev)))):
        want = fn(q, *args("cpu"), causal=True, window=30).float()
        got = fn(q.to(cuda), *args(cuda), causal=True, window=30).float().cpu()
        assert float((got - want).abs().max()) <= tol


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_kernel_takes_offset_views(cuda, dtype, tol):
    """Positions and carried state are read element by element, so
    contiguous views 4 bytes past a 16-byte boundary launch as they run on
    the CPU; so do f32 q/k/v (bf16 q/k/v are loaded by TMA, from 16-byte
    aligned bases)."""
    gen = torch.Generator().manual_seed(3)
    bh, lq, lk, d = 4, 24, 40, 32
    nq, nk = bh * lq * d, bh * lk * d
    off = 1 if dtype == torch.float32 else 0
    qkv = torch.randn((off + nq + 2 * nk,), generator=gen).to(dtype)
    pos = torch.arange(-1, lk, dtype=torch.int32)
    st = torch.rand((1 + nq + 2 * bh * lq,), generator=gen) + 0.5

    def views(dev):
        b, p, s = qkv.to(dev), pos.to(dev), st.to(dev)
        return dict(q=b[off:off + nq].view(bh, lq, d),
                    k=b[off + nq:off + nq + nk].view(bh, lk, d),
                    v=b[off + nq + nk:].view(bh, lk, d),
                    q_pos=p[1 + lk - lq:], k_pos=p[1:],
                    state=(s[1:1 + nq].view(bh, lq, d),
                           s[1 + nq:1 + nq + bh * lq].view(bh, lq),
                           s[1 + nq + bh * lq:].view(bh, lq)))

    card = views(cuda)
    assert card["k_pos"].data_ptr() % 16 and card["state"][1].data_ptr() % 16
    assert (card["q"].data_ptr() % 16 != 0) == (dtype == torch.float32)
    kw = dict(causal=True, window=20, finalize=False)
    before = fm.launch_count()
    got = fm.flash_mqkv(**card, **kw)
    assert fm.launch_count() == before + 1
    want = fm.flash_mqkv(**views("cpu"), **kw)
    for g, w in zip(got, want):
        scale = max(1.0, float(w.abs().max()))
        assert float((g.cpu() - w).abs().max()) / scale <= tol


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("lq,lk,group,state", [(75, 75, 1, False),
                                               (64, 91, 2, True)])
def test_cuda_ring_step_is_k1_bitwise(cuda, dtype, d, lq, lk, group, state):
    """K2's (o, l, m) are K1's bit for bit (one kernel body); its forward
    buffers hold the chunk bit for bit and its completion word the epoch."""
    gen = torch.Generator(device=cuda).manual_seed(d + lq)
    mk = lambda *s: torch.randn(s, generator=gen, device=cuda).to(dtype)
    q, k, v = mk(4, lq, d), mk(4 // group, lk, d), mk(4 // group, lk, d)
    qp = torch.arange(lq, dtype=torch.int32, device=cuda) + lk - lq
    kp = torch.arange(lk, dtype=torch.int32, device=cuda)
    kw = dict(group=group, causal=True, window=40, finalize=not state)
    if state:
        kw["state"] = fm.flash_mqkv(q, k, v, qp, kp, group=group,
                                    finalize=False)
    flag = torch.zeros(1, dtype=torch.int32, device=cuda)
    arrive = torch.zeros_like(flag)
    before = rf.launch_count()
    (o, l, m), (kf, vf) = rf.ring_flash_step(q, k, v, qp, kp, flag=flag,
                                             arrive=arrive, epoch=9, **kw)
    assert rf.launch_count() == before + 1
    ref = fm.flash_mqkv(q, k, v, qp, kp, **kw)
    for g, w in zip((o, l, m), ref):
        assert torch.equal(g, w)
    assert torch.equal(kf, k) and torch.equal(vf, v)
    assert int(flag) == 9 and int(arrive) == 0


# (BH, group, Lq, Lk) reaching each tile plan of the bf16 body: Lq below
# the block's rows, Lk not a multiple of the KV tile (the hardware fills
# the ragged end with zeros) and of at least three tiles (the two-stage
# ring wraps)
HOPPER_CASES = {64: (4, 2, 40, 200), 128: (132, 2, 40, 400)}


@pytest.mark.needs_cuda
@pytest.mark.parametrize("d", fm.HEAD_DIMS)
@pytest.mark.parametrize("bq", sorted(HOPPER_CASES))
@pytest.mark.parametrize("causal,window", [(False, None), (True, 50)])
def test_cuda_hopper_body_edges(cuda, d, bq, causal, window):
    """The bf16 body under both tile plans at its edges: K1 against the
    plain version, K2 bitwise equal to K1 with the chunk forwarded whole
    and the completion word set."""
    bh, group, lq, lk = HOPPER_CASES[bq]
    plan = fm.tile_plan(bh, lq, lk, d)
    assert plan.bq == bq and lq < bq and lk % plan.bk and lk >= 3 * plan.bk
    gen = torch.Generator(device=cuda).manual_seed(bq + d)
    mk = lambda *s: torch.randn(s, generator=gen, device=cuda).to(torch.bfloat16)
    q, k, v = mk(bh, lq, d), mk(bh // group, lk, d), mk(bh // group, lk, d)
    qp = torch.arange(lq, dtype=torch.int32, device=cuda) + lk - lq
    kp = torch.arange(lk, dtype=torch.int32, device=cuda)
    kw = dict(group=group, causal=causal, window=window, finalize=False)
    got = fm.flash_mqkv(q, k, v, qp, kp, **kw)
    want = fm.flash_mqkv_plain(q, k, v, qp, kp, **kw)
    for g, w in zip(got, want):
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) / scale <= 2e-2
    flag = torch.zeros(1, dtype=torch.int32, device=cuda)
    arrive = torch.zeros_like(flag)
    out, (kf, vf) = rf.ring_flash_step(q, k, v, qp, kp, flag=flag,
                                       arrive=arrive, epoch=3, **kw)
    for g, w in zip(out, got):
        assert torch.equal(g, w)
    assert torch.equal(kf, k) and torch.equal(vf, v)
    assert int(flag) == 3 and int(arrive) == 0


@pytest.mark.needs_cuda
@pytest.mark.parametrize("group", [2, 4])
def test_cuda_ring_step_forwards_under_gqa(cuda, group):
    """Under GQA one block per KV head forwards the chunk: every KV head
    lands, and over consecutive launches the completion word takes each
    epoch and the arrive counter is back at 0 after each, so the count of
    forwarding blocks is right."""
    gen = torch.Generator(device=cuda).manual_seed(group)
    mk = lambda *s: torch.randn(s, generator=gen, device=cuda).to(torch.bfloat16)
    bhkv, lq, lk, d = 3, 150, 272, 128
    flag = torch.zeros(1, dtype=torch.int32, device=cuda)
    arrive = torch.zeros_like(flag)
    pos = torch.arange(lk, dtype=torch.int32, device=cuda)
    for epoch in (5, 6, 7):
        q, k, v = mk(bhkv * group, lq, d), mk(bhkv, lk, d), mk(bhkv, lk, d)
        kd, vd = torch.zeros_like(k), torch.zeros_like(v)
        rf.ring_flash_step(q, k, v, pos[:lq], pos, k_dst=kd, v_dst=vd,
                           flag=flag, arrive=arrive, epoch=epoch,
                           group=group)
        torch.cuda.synchronize()
        assert torch.equal(kd, k) and torch.equal(vd, v)
        assert int(flag) == epoch and int(arrive) == 0


@pytest.mark.needs_cuda
def test_cuda_smem_bytes_match_the_plan(cuda):
    """The wrapper's shared-memory formula is the kernel's (Hop::SMEM)."""
    lib = fm._bound_library()
    for d in fm.HEAD_DIMS:
        for bq in (64, 128):
            plan = fm.TilePlan(bq=bq, bk=bq, stages=fm.STAGES)
            assert lib.flash_mqkv_smem_bytes(d, bq) == fm.smem_bytes(plan, d)


SERVE_PUT, SMALL_PUT = (2, 272, 3, 128), (1, 80, 3, 128)
# case: (dtype, ranks, shapes of one rank's tensors, (src, dst) element
# offsets into flat buffers, puts back to back on one set of words)
PUT_CASES = {
    **{f"{dt}-{'x'.join(map(str, shape))}": (
        getattr(torch, dt), 16, [shape] * 2, (0, 0), 1)
       for dt in ("float32", "bfloat16")
       for shape in ((3, 5), (7, 3, 2), (1, 13), (6, 272, 128))},
    # views at 2- and 4-byte alignment, equal mod 16 bytes (bulk body
    # behind a head) or not (word path)
    **{f"{dt}-offsets-{so}-{do}": (getattr(torch, dt), 8, [SERVE_PUT],
                                   (so, do), 1)
       for dt, so, do in (("bfloat16", 1, 0), ("bfloat16", 0, 1),
                          ("bfloat16", 1, 1), ("bfloat16", 1, 3),
                          ("bfloat16", 2, 2), ("float32", 1, 0),
                          ("float32", 1, 1))},
    "mixed-sizes": (torch.bfloat16, 16, [(13,), SERVE_PUT], (0, 0), 1),
    "no-multiple-of-16": (torch.bfloat16, 16, [(5, 4099), (3, 1001), (1,)],
                          (0, 0), 1),
    "max-entries": (torch.bfloat16, 48, [SMALL_PUT] * 2, (0, 0), 1),
    "back-to-back": (torch.bfloat16, 16, [SERVE_PUT] * 2, (0, 0), 3),
}


@pytest.mark.needs_cuda
@pytest.mark.parametrize("name", ["remote_put", "landing_copy"])
@pytest.mark.parametrize("case", list(PUT_CASES))
def test_cuda_put_kernels_deliver_bitwise(cuda, name, case):
    """K3 and K4 deliver every rank's tensors bitwise and release the
    expected epoch in every signal word, leaving every arrive word at 0:
    the reference's uneven shapes, offset views (no byte outside a
    destination view is written), entries of very different sizes and of
    sizes no multiple of 16 bytes in one launch, MAX_ENTRIES entries, and
    puts back to back on one side stream and one set of words with rising
    epochs and no synchronisation between them."""
    dtype, ranks, shapes, (so, do), puts = PUT_CASES[case]
    assert ranks * len(shapes) <= kb.MAX_ENTRIES
    gen = torch.Generator(device=cuda).manual_seed(ranks + len(shapes))
    perm = [(7 * r + 5) % ranks for r in range(ranks)]
    assert sorted(perm) == list(range(ranks))

    def views(off, fill):
        flat = [[fill(s.numel() + 8) for s in map(torch.Size, shapes)]
                for _ in range(ranks)]
        return flat, [[f[off:off + f.numel() - 8].view(s)
                       for f, s in zip(row, shapes)] for row in flat]

    sets = [(views(so, lambda n: torch.randn(n, generator=gen, device=cuda)
                   .to(dtype))[1],
             views(do, lambda n: torch.full((n,), float("nan"), device=cuda)
                   .to(dtype))) for _ in range(puts)]
    signal = torch.zeros(ranks * len(shapes), dtype=torch.int32, device=cuda)
    arrive = torch.zeros_like(signal)
    before = kb.launch_count(name)
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        for n, (src, (_, dst)) in enumerate(sets):
            if name == "remote_put":
                kb.remote_put(src, dst, perm, signal=signal, arrive=arrive,
                              epoch=3 + n)
            else:
                kb.landing_copy(src, dst, signal=signal, arrive=arrive,
                                epoch=3 + n)
    assert kb.launch_count(name) == before + puts
    torch.cuda.synchronize()
    to = perm if name == "remote_put" else list(range(ranks))
    for src, (flat, dst) in sets:
        for r in range(ranks):
            for i, sent in enumerate(src[r]):
                assert torch.equal(dst[to[r]][i], sent)
                f = flat[to[r]][i]
                assert bool(f[:do].isnan().all())
                assert bool(f[do + sent.numel():].isnan().all())
    assert bool((signal == 2 + puts).all()) and bool((arrive == 0).all())


@pytest.mark.needs_cuda
@pytest.mark.parametrize("wire", ["float8_e4m3fn", "float8_e5m2"])
def test_cuda_landing_copy_takes_an_fp8_payload_and_its_scale(cuda, wire):
    """The inter put of the hierarchical Push-O: every rank's fp8 bundle
    and its 0-d float32 scale (a 4-byte entry, through the kernel's
    head-and-tail path) in one K4 launch, bitwise as the plain landing
    copy, every signal word at the put's epoch."""
    from repro_torch.comm import compress

    gen = torch.Generator(device=cuda).manual_seed(11)
    src = []
    for _ in range(16):
        x = torch.randn((4, 2, 272, 3, 128), generator=gen,
                        device=cuda).to(torch.bfloat16)
        src.append(list(compress.quantize(x, wire)))
    dst = [[torch.empty_like(t) for t in r] for r in src]
    ref = [[torch.empty_like(t) for t in r] for r in src]
    signal = torch.zeros(32, dtype=torch.int32, device=cuda)
    arrive = torch.zeros_like(signal)
    before = kb.launch_count("landing_copy")
    kb.landing_copy(src, dst, signal=signal, arrive=arrive, epoch=9)
    kb.landing_copy_plain(src, ref, torch.zeros_like(signal), 9)
    torch.cuda.synchronize()
    assert kb.launch_count("landing_copy") == before + 1
    for row, want in zip(dst, ref):
        for got, w in zip(row, want):
            assert torch.equal(got.reshape(-1).view(torch.uint8),
                               w.reshape(-1).view(torch.uint8))
    assert bool((signal == 9).all()) and bool((arrive == 0).all())


@pytest.mark.needs_cuda
@pytest.mark.parametrize("wire", ["float8_e4m3fn", "float8_e5m2"])
def test_cuda_wire_codec_is_the_cpu_codec(cuda, wire):
    """The fp8 codec on the card gives the CPU's bytes, scale and residual
    bit for bit (the scale divides by a tensor: CUDA would multiply by the
    reciprocal of a Python scalar)."""
    from repro_torch.comm import compress

    gen = torch.Generator().manual_seed(12)
    x = (torch.randn((4, 2, 272, 3, 128), generator=gen) * 3).to(
        torch.bfloat16)
    err = torch.randn(x.shape, generator=gen) * 1e-3
    cpu = compress.ef_encode(x, err, wire)
    card = compress.ef_encode(x.to(cuda), err.to(cuda), wire)
    assert torch.equal(card[0].cpu().view(torch.uint8),
                       cpu[0].view(torch.uint8))
    assert card[1].item() == cpu[1].item()
    assert torch.equal(card[2].cpu(), cpu[2])


@pytest.mark.needs_cuda
@pytest.mark.parametrize("wire", [None, "float8_e4m3fn"])
def test_cuda_hier_swift_torus_matches_cpu(cuda, wire):
    """swift_torus with the hierarchical Push-O on mesh (pod 2, model 4)
    of the card against the same schedule on the CPU: the fp8 codec
    rounds the same on both (float32 division, then the cast)."""
    gen = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn((2, 64, 4, 32), generator=gen) for _ in range(3))
    cfg = SPConfig(strategy="swift_torus", sp_axes=("pod", "model"),
                   comm_backend="pallas", hier_a2a=True, a2a_wire_dtype=wire)
    want = sp_attention(q, k, v, cfg=cfg, causal=True,
                        mesh=make_mesh((2, 4), ("pod", "model"),
                                       device="cpu"))
    kb.reset_launch_count()
    got = sp_attention(q.to(cuda), k.to(cuda), v.to(cuda), cfg=cfg,
                       causal=True,
                       mesh=make_mesh((2, 4), ("pod", "model"), device=cuda))
    torch.cuda.synchronize()
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    # P_u 4 = 2 machines x 2: 3 Pull-Q + 3 Pull-KV, then 1 intra + 1 inter
    assert kb.launch_count("landing_copy") == 8


@pytest.mark.needs_cuda
@pytest.mark.parametrize("axes,sp_axes,shape,interpret,put", [
    (("pod", "model"), ("pod", "model"), (2, 4), False, "landing_copy"),
    (("model",), ("model",), (8,), False, "remote_put")])
def test_cuda_swift_torus_matches_cpu(cuda, axes, sp_axes, shape, interpret,
                                      put):
    """swift_torus on 8 virtual ranks of the card (K1, K2 and one put
    kernel per torus put) against the same schedule's plain versions on
    the CPU, float32."""
    gen = torch.Generator().manual_seed(5)
    q = torch.randn((2, 64, 8, 32), generator=gen)
    k = torch.randn((2, 64, 4, 32), generator=gen)
    v = torch.randn((2, 64, 4, 32), generator=gen)
    cfg = SPConfig(strategy="swift_torus", sp_axes=sp_axes,
                   comm_backend="pallas", kernel_interpret=interpret)
    want = sp_attention(q, k, v, cfg=cfg, causal=True,
                        mesh=make_mesh(shape, axes, device="cpu"))
    fm.reset_launch_count()
    rf.reset_launch_count()
    kb.reset_launch_count()
    got = sp_attention(q.to(cuda), k.to(cuda), v.to(cuda), cfg=cfg,
                       causal=True, mesh=make_mesh(shape, axes, device=cuda))
    torch.cuda.synchronize()
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    # P_u 4 x P_r 2: 7 ring circulations of 1 K2 + 1 K1 per rank, 9 puts
    assert fm.launch_count() == rf.launch_count() == 8 * 7
    assert kb.launch_count(put) == 9


@pytest.mark.needs_cuda
def test_cuda_swift_torus_over_batch_slices_matches_cpu(cuda):
    """A data axis of 2 on the card: each batch slice runs swift_torus on
    its own 4 ranks of (pod 2, model 2), and every put is still ONE launch
    covering both slices."""
    gen = torch.Generator().manual_seed(6)
    q = torch.randn((2, 64, 8, 32), generator=gen)
    k = torch.randn((2, 64, 4, 32), generator=gen)
    v = torch.randn((2, 64, 4, 32), generator=gen)
    cfg = SPConfig(strategy="swift_torus", sp_axes=("pod", "model"),
                   batch_axes=("data",), comm_backend="pallas",
                   kernel_interpret=False)
    shape, axes = (2, 2, 2), ("pod", "data", "model")
    want = sp_attention(q, k, v, cfg=cfg, causal=True,
                        mesh=make_mesh(shape, axes, device="cpu"))
    fm.reset_launch_count()
    kb.reset_launch_count()
    got = sp_attention(q.to(cuda), k.to(cuda), v.to(cuda), cfg=cfg,
                       causal=True, mesh=make_mesh(shape, axes, device=cuda))
    torch.cuda.synchronize()
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    # P_u 4 x P_r 1 per slice: 7 circulations of one K1 per rank, 8 ranks;
    # 9 torus puts over (pod, model), each one K4 launch for both slices
    assert fm.launch_count() == 8 * 7
    assert kb.launch_count("landing_copy") == 9


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_displaced_attention_matches_cpu(cuda, dtype, tol):
    """The displaced pipeline's attention on the card: two K1 launches
    (the patch's fresh rows, then the other rows' stale ones) carrying one
    softmax state, against the same call's plain version on the CPU."""
    from repro_torch.core import displaced_attention
    gen = torch.Generator().manual_seed(7)
    q, kf, vf = (torch.randn((2, 48, 4, 64), generator=gen).to(dtype)
                 for _ in range(3))
    ks, vs = (torch.randn((2, 144, 4, 64), generator=gen).to(dtype)
              for _ in range(2))
    want = displaced_attention(q, kf, vf, ks, vs).float()
    fm.reset_launch_count()
    got = displaced_attention(*(t.to(cuda) for t in (q, kf, vf, ks, vs)))
    torch.cuda.synchronize()
    assert fm.launch_count() == 2
    scale = max(1.0, float(want.abs().max()))
    assert float((got.float().cpu() - want).abs().max()) / scale <= tol


@pytest.mark.needs_cuda
@pytest.mark.parametrize("strategy", ["ring", "usp", "swift_torus"])
def test_cuda_xla_backend_matches_cpu(cuda, strategy):
    """comm_backend "xla" on the card: plain attention per chunk and plain
    copies for the puts, on the side stream; no kernel of the port runs."""
    gen = torch.Generator().manual_seed(6)
    q = torch.randn((2, 64, 8, 32), generator=gen)
    k = torch.randn((2, 64, 4, 32), generator=gen)
    v = torch.randn((2, 64, 4, 32), generator=gen)
    cfg = SPConfig(strategy=strategy, sp_axes=("pod", "model"),
                   comm_backend="xla")
    shape, axes = (2, 4), ("pod", "model")
    want = sp_attention(q, k, v, cfg=cfg, causal=True,
                        mesh=make_mesh(shape, axes, device="cpu"))
    fm.reset_launch_count()
    rf.reset_launch_count()
    kb.reset_launch_count()
    got = sp_attention(q.to(cuda), k.to(cuda), v.to(cuda), cfg=cfg,
                       causal=True, mesh=make_mesh(shape, axes, device=cuda))
    torch.cuda.synchronize()
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    assert fm.launch_count() == rf.launch_count() == 0
    assert kb.launch_count("remote_put") == kb.launch_count("landing_copy") == 0


def _wkv_inputs(gen, shape, dtypes):
    """r, k, v, w, u on the card; w = sigmoid(N(0, 1)) / 2 + 1/2, the
    reference test's decays, in [0.5, 1] (far from the underflow of F3)."""
    mk = lambda: torch.randn(shape, generator=gen)
    r, k, v = mk(), mk(), mk()
    w = torch.sigmoid(mk()) * 0.5 + 0.5
    u = torch.randn((shape[0], shape[-1]), generator=gen) * 0.1
    return [t.to(dt).cuda() for t, dt in zip((r, k, v, w, u), dtypes)]


F32, BF16 = torch.float32, torch.bfloat16
# (r, k, v, w, u) dtypes: all float32, all bfloat16, and the model's mix
WKV_DTYPES = {"f32": (F32,) * 5, "bf16": (BF16,) * 5,
              "model": (BF16, BF16, BF16, F32, BF16)}


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtypes", list(WKV_DTYPES))
@pytest.mark.parametrize("l,n,chunk", [(32, 8, 8), (64, 16, 16), (128, 64, 64),
                                       (64, 32, 64), (256, 64, 64),
                                       (96, 8, 32), (16, 64, 64)])
def test_cuda_wkv_matches_plain(cuda, dtypes, l, n, chunk):
    """K5 against its plain version on the same card tensors: the reference
    test's (L, N, chunk) sweep, plus several chunks at N 64 and N 8 and a
    sequence shorter than the chunk.  Both sides compute in float32 from
    the same inputs, so they differ by summation order only."""
    gen = torch.Generator().manual_seed(l * n + chunk)
    r, k, v, w, u = _wkv_inputs(gen, (3, l, n), WKV_DTYPES[dtypes])
    before = wkv.launch_count()
    got = wkv.rwkv6_wkv(r, k, v, w, u, chunk=chunk)
    assert wkv.launch_count() == before + 1
    want = rwkv6_wkv_ref(r, k, v, w, u, chunk=chunk)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (3, l, n)
    assert float((got - want).abs().max()) / max(
        1.0, float(want.abs().max())) <= 2e-4


@pytest.mark.needs_cuda
def test_cuda_wkv_heads_reads_strides(cuda):
    """The model's [B, L, H, N] entry point on the rwkv6 head shape (H 32,
    N 64), from views whose batch, time and head strides are not those of a
    contiguous tensor, against the plain version."""
    gen = torch.Generator().manual_seed(7)
    b, l, h, n = 2, 128, 32, 64
    base = _wkv_inputs(gen, (b * h, l, n), WKV_DTYPES["model"])
    # [B, H, L, N] storage seen as [B, L, H, N]
    r, k, v, w = (t.view(b, h, l, n).permute(0, 2, 1, 3) for t in base[:4])
    u = base[4][:h]
    got = wkv.rwkv6_wkv_heads(r, k, v, w, u)
    want = wkv.rwkv6_wkv_heads_plain(r, k, v, w, u)
    torch.cuda.synchronize()
    assert got.shape == (b, l, h, n) and got.is_contiguous()
    assert float((got - want).abs().max()) / max(
        1.0, float(want.abs().max())) <= 2e-4


@pytest.mark.needs_cuda
@pytest.mark.parametrize("bh", [32, 128])
@pytest.mark.parametrize("split", wkv.SPLITS)
def test_cuda_wkv_value_splits(cuda, monkeypatch, bh, split):
    """Each split of a row's 64 value columns over blocks that the wrapper
    can choose, at the rwkv6 head shape (H 32, N 64) in the model's dtypes,
    at 32 rows (B 1, where it picks 4 on an H100) and 128 (B 4, where it
    picks 1), against the plain version."""
    monkeypatch.setattr(wkv, "value_split", lambda bh_, n_, sms_: split)
    gen = torch.Generator().manual_seed(bh + split)
    b, l, h, n = bh // 32, 256, 32, 64
    r, k, v, w, u = _wkv_inputs(gen, (b, l, h, n), WKV_DTYPES["model"])
    u = u[0].expand(h, n).contiguous()
    before = wkv.launch_count()
    got = wkv.rwkv6_wkv_heads(r, k, v, w, u)
    assert wkv.launch_count() == before + 1
    want = wkv.rwkv6_wkv_heads_plain(r, k, v, w, u)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) / max(
        1.0, float(want.abs().max())) <= 2e-4


@pytest.mark.needs_cuda
def test_cuda_wkv_model_shape_b1_l1024(cuda):
    """The B 1 x L 1024 rwkv6-1.6b prefill call (32 rows, 16 chunks of 64)
    in the model's dtypes against the plain version."""
    gen = torch.Generator().manual_seed(1024)
    b, l, h, n = 1, 1024, 32, 64
    r, k, v, w, _ = _wkv_inputs(gen, (b, l, h, n), WKV_DTYPES["model"])
    u = (torch.randn((h, n), generator=gen) * 0.5).to(BF16).cuda()
    got = wkv.rwkv6_wkv_heads(r, k, v, w, u)
    want = wkv.rwkv6_wkv_heads_plain(r, k, v, w, u)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) / max(
        1.0, float(want.abs().max())) <= 2e-4


@pytest.mark.needs_cuda
def test_cuda_wkv_rejects_misaligned_views(cuda):
    """The kernel loads r, k, v, w with TMA: a base address off 16 bytes,
    or a stride that is no multiple of 16 bytes, raises ValueError (the
    kernel does not copy)."""
    b, l, h, n = 1, 64, 2, 16
    ok = lambda: torch.zeros((b, l, h, n), device=cuda, dtype=BF16)
    u = torch.zeros((h, n), device=cuda, dtype=BF16)
    shifted = torch.zeros(b * l * h * n + 1, device=cuda,
                          dtype=BF16)[1:].view(b, l, h, n)
    wide = torch.zeros((b, l, h, n + 1), device=cuda, dtype=BF16)[..., :n]
    for bad in (shifted, wide):
        with pytest.raises(ValueError, match="16-byte"):
            wkv.rwkv6_wkv_heads(ok(), ok(), bad, ok(), u)
    wkv.rwkv6_wkv_heads(ok(), ok(), ok(), ok().float() + 0.5, u)
    torch.cuda.synchronize()


@pytest.mark.needs_cuda
def test_cuda_wkv_rejects_what_it_does_not_take(cuda):
    z = lambda *s, dt=F32: torch.zeros(s, device=cuda, dtype=dt)
    with pytest.raises(ValueError, match="head sizes"):
        wkv.rwkv6_wkv(*(z(2, 64, 48) for _ in range(4)), z(2, 48))
    with pytest.raises(ValueError, match="chunks"):
        wkv.rwkv6_wkv(*(z(2, 24, 16) for _ in range(4)), z(2, 16))
    with pytest.raises(ValueError, match="multiple"):
        wkv.rwkv6_wkv(*(z(2, 96, 16) for _ in range(4)), z(2, 16))
    with pytest.raises(TypeError):
        wkv.rwkv6_wkv(*(z(2, 64, 16, dt=torch.float16) for _ in range(4)),
                      z(2, 16))


# K1b (flash_mqkv_bwd): (bh, hkv, lq, lk, d, causal, window, padded keys,
# a fully masked row)
K1B_CASES = {
    "causal-gqa": (8, 2, 96, 96, 128, True, None, 0, False),
    "window": (4, 4, 130, 130, 64, True, 33, 0, False),
    "cross": (6, 6, 45, 150, 64, False, None, 0, False),
    "pad-dead-row": (4, 2, 40, 72, 32, True, None, 9, True),
    "head-dim-80": (6, 2, 70, 70, 80, True, None, 0, False),
    "d16": (2, 1, 33, 17, 16, False, None, 3, False),
    # ragged against the bf16 body's 64-row tiles at every head dim, with
    # paired key tiles and the GQA group split over blocks
    "ragged-d128": (12, 2, 200, 333, 128, True, None, 5, False),
    "ragged-d64": (12, 4, 65, 129, 64, True, 40, 0, False),
    "ragged-d32": (8, 8, 127, 191, 32, True, None, 0, False),
    "ragged-d16": (6, 3, 63, 257, 16, False, 100, 0, False),
    # hymba's GQA group of 5 under a window, the group split over 5 blocks
    "gqa5-window": (10, 2, 130, 130, 64, True, 70, 0, False),
}


def _k1b_inputs(cuda, dtype, case, seed=0):
    bh, hkv, lq, lk, d, causal, window, pad, dead = case
    gen = torch.Generator(device=cuda).manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=gen, device=cuda).to(dtype)
    q, k, v = mk(bh, lq, d), mk(hkv, lk, d), mk(hkv, lk, d)
    q_pos = torch.arange(lk - lq, lk, dtype=torch.int32, device=cuda)
    k_pos = torch.arange(lk, dtype=torch.int32, device=cuda)
    if pad:
        k_pos[-pad:] = -1
    if dead:  # row 0 sees only keys at positions <= 0, and those are padding
        k_pos[:4] = -1
        q_pos[0] = 0
    kw = dict(group=bh // hkv, scale=d ** -0.5, causal=causal, window=window)
    o, l, m = fm.flash_mqkv(q, k, v, q_pos, k_pos, **kw)
    do = mk(bh, lq, d)
    return (q, k, v, o, do, m, l, q_pos, k_pos), kw


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", list(K1B_CASES))
def test_cuda_k1b_matches_plain(cuda, dtype, tol, case):
    args, kw = _k1b_inputs(cuda, dtype, K1B_CASES[case])
    before = fm.bwd_launch_count()
    got = fm.flash_mqkv_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert fm.bwd_launch_count() == before + 1
    want = flash_mqkv_bwd_plain(*args, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert bool(torch.isfinite(g).all())
        scale = max(1e-6, float(w.float().abs().max()))
        assert float((g.float() - w.float()).abs().max()) / scale <= tol
    if K1B_CASES[case][-1]:  # the fully masked rows get zero gradients
        dead = args[6] == 0
        assert bool((got[0][dead] == 0).all())


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_k1b_is_deterministic(cuda, dtype):
    """No atomics: two runs give bitwise-equal gradients."""
    args, kw = _k1b_inputs(cuda, dtype, K1B_CASES["causal-gqa"])
    a = fm.flash_mqkv_bwd(*args, **kw)
    b = fm.flash_mqkv_bwd(*args, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("case", ["causal-gqa", "window", "ragged-d128",
                                  "gqa5-window"])
def test_cuda_k1b_bf16_is_deterministic(cuda, case):
    """The bf16 body (D 128 and D 64; paired and split) writes every
    output element from one block and sums in a fixed order: bitwise on
    repeat."""
    args, kw = _k1b_inputs(cuda, torch.bfloat16, K1B_CASES[case])
    a = fm.flash_mqkv_bwd(*args, **kw)
    b = fm.flash_mqkv_bwd(*args, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.needs_cuda
def test_cuda_k1b_bf16_mask_off_breaks_the_gate(cuda):
    """Negative control of the bf16 body: without the causal mask it is
    far over the bf16 gate (2e-2) from the plain backward with it."""
    args, kw = _k1b_inputs(cuda, torch.bfloat16, K1B_CASES["causal-gqa"])
    got = fm.flash_mqkv_bwd(*args, **dict(kw, causal=False))
    want = flash_mqkv_bwd_plain(*args, **kw)
    err = max(float((g.float() - w.float()).abs().max() / w.float().abs().max())
              for g, w in zip(got, want))
    assert err > 2e-2


@pytest.mark.needs_cuda
def test_cuda_k1b_smem_bytes_match_the_plan(cuda):
    """bwd_smem_bytes equals the dynamic shared memory the bf16 kernels
    launch with (flash_mqkv_bwd_smem_bytes), at every head dim."""
    lib = fm._bound_bwd_library()
    for d in fm.HEAD_DIMS:
        plan = fm.bwd_tile_plan(48, 6, 1024, 1024, d, True)
        got = (lib.flash_mqkv_bwd_smem_bytes(0, d),
               lib.flash_mqkv_bwd_smem_bytes(1, d))
        assert got == fm.bwd_smem_bytes(plan, d)


@pytest.mark.needs_cuda
def test_cuda_k1b_mask_off_breaks_the_gate(cuda):
    """Negative control: the kernel without the causal mask is far from
    the plain backward with it."""
    args, kw = _k1b_inputs(cuda, torch.float32, K1B_CASES["causal-gqa"])
    got = fm.flash_mqkv_bwd(*args, **dict(kw, causal=False))
    want = flash_mqkv_bwd_plain(*args, **kw)
    err = float((got[0] - want[0]).abs().max() / want[0].abs().max())
    assert err > 1e-2


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_flash_attention_gradient_matches_cpu(cuda, dtype, tol):
    """ops.flash_attention under autograd: K1 forward and K1b backward on
    the card against the plain path's gradients on the CPU."""
    gen = torch.Generator().manual_seed(3)
    mk = lambda *s: torch.randn(s, generator=gen)
    q, k, v, do = mk(2, 100, 6, 80), mk(2, 100, 2, 80), mk(2, 100, 2, 80), \
        mk(2, 100, 6, 80)
    grads = {}
    for dev in ("cpu", cuda):
        ins = [t.to(dev, dtype).detach().requires_grad_() for t in (q, k, v)]
        out = flash_attention(*ins, causal=True, window=40)
        out.backward(do.to(dev, dtype))
        grads[str(dev)] = [t.grad.float().cpu() for t in ins]
    for g, w in zip(grads[str(cuda)], grads["cpu"]):
        assert float((g - w).abs().max() / w.abs().max()) <= tol


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("where", ["future", "outside-window"])
def test_cuda_k1b_writes_zeros_for_a_fully_hidden_chunk(cuda, where, dtype):
    """K1b against a KV chunk the mask hides from every row, with the
    rows' (m, l) finite from their visible keys, as a ring step of the SP
    backward meets it: dq, dk and dv exactly zero (no empty_like garbage)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    mk = lambda *s: torch.randn(s, generator=gen, device=cuda).to(dtype)
    i32 = lambda a, b: torch.arange(a, b, dtype=torch.int32, device=cuda)
    q, o, do = mk(8, 96, 64), mk(8, 96, 64), mk(8, 96, 64)
    k, v = mk(2, 80, 64), mk(2, 80, 64)
    q_pos = i32(96, 192)
    _, l, m = fm.flash_mqkv_plain(q.float(), k.float(), v.float(), q_pos,
                                  i32(0, 80), group=4, causal=True,
                                  finalize=False)
    k_pos, window = ((i32(200, 280), None) if where == "future"
                     else (i32(0, 80), 1))
    for t in fm.flash_mqkv_bwd(q, k, v, o, do, m, l, q_pos, k_pos, group=4,
                               causal=True, window=window):
        assert bool((t == 0).all())


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("strategy", ["swift_torus", "usp", "ring"])
def test_cuda_sp_attention_gradient_matches_cpu(cuda, strategy, dtype, tol):
    """The SP schedule's gradient (core/sp_grad.py) on mesh (pod 2, model
    2) through the kernels (K1/K2 forward, K1b per KV chunk, K4 for every
    transfer), in float32 and in bf16 (K1b's bf16 body on past, diagonal
    and hidden chunks with the rows' statistics over all their keys),
    against the same on the CPU (the plain versions) in the same dtype:
    ``tol`` of each gradient's max|grad|; K1b launched ranks x P_r times."""
    from repro_torch.core.strategy import resolve_layout

    gen = torch.Generator().manual_seed(6)
    mk = lambda *s: torch.randn(s, generator=gen)
    q, k, v, do = mk(2, 256, 12, 64), mk(2, 256, 2, 64), mk(2, 256, 2, 64), \
        mk(2, 256, 12, 64)
    cfg = SPConfig(strategy=strategy, sp_axes=("pod", "model"),
                   batch_axes=None, comm_backend="pallas",
                   kernel_interpret=False)
    grads = {}
    for dev in ("cpu", cuda):
        mesh = make_mesh((2, 2), ("pod", "model"), dev)
        ins = [t.to(dev, dtype).detach().requires_grad_() for t in (q, k, v)]
        out = sp_attention(*ins, cfg=cfg, mesh=mesh, causal=True)
        before = fm.bwd_launch_count()
        out.backward(do.to(dev, dtype))
        grads[str(dev)] = ([t.grad.float().cpu() for t in ins],
                           fm.bwd_launch_count() - before)
    layout = resolve_layout(cfg, mesh, 12, 2)
    assert grads[str(cuda)][1] == layout.size * layout.p_ring
    for g, w in zip(grads[str(cuda)][0], grads["cpu"][0]):
        assert bool(torch.isfinite(g).all())
        assert float((g - w).abs().max() / w.abs().max()) <= tol


# K5b (rwkv6_wkv_bwd, the gradient of K5): (B, L, H, N, chunk) — rwkv6-1.6b's
# training shape, a sequence shorter than the chunk, smaller heads and chunks
K5B_CASES = {
    "rwkv6-train": (4, 1024, 32, 64, 64),
    "short-L": (2, 32, 32, 64, 64),
    "n16-c16": (2, 96, 4, 16, 16),
    "n8-c8": (3, 40, 2, 8, 8),
    "value-split": (1, 1024, 4, 64, 64),
}
K5B_DTYPES = {"f32": ((F32,) * 5, 1e-4), "model": (WKV_DTYPES["model"], 2e-2)}


def _k5b_inputs(gen, case, dtypes):
    """[B, L, H, N] inputs with decays from RWKV6's range (exp(-exp(w0)),
    w0 ~ U[-6, -1]: ~[0.69, 0.998], ROADMAP F3), u [H, N] and a float32
    dO, on the card."""
    b, l, h, n, _ = case
    mk = lambda: torch.randn((b, l, h, n), generator=gen)
    r, k, v = mk(), mk(), mk()
    w = torch.exp(-torch.exp(torch.rand((b, l, h, n), generator=gen) * 5 - 6))
    u = torch.randn((h, n), generator=gen) * 0.5
    ins = [t.to(dt).cuda() for t, dt in zip((r, k, v, w, u), dtypes)]
    return ins, mk().cuda()


def _k5b_err(got, want) -> float:
    return max(float((g.float() - x.float()).abs().max()
                     / x.float().abs().max()) for g, x in zip(got, want))


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtypes", list(K5B_DTYPES))
@pytest.mark.parametrize("case", list(K5B_CASES))
def test_cuda_k5b_matches_plain(cuda, dtypes, case):
    """K5b against its plain version on the same card tensors, within 1e-4
    (float32) or 2e-2 (the model's bf16 r/k/v/u, f32 w) of each
    gradient's max|ref|; the gradients in their inputs' dtypes; a repeat
    bitwise equal (du is summed over the batch in row order, no atomics)."""
    kinds, tol = K5B_DTYPES[dtypes]
    chunk = K5B_CASES[case][-1]
    (r, k, v, w, u), do = _k5b_inputs(torch.Generator().manual_seed(5),
                                      K5B_CASES[case], kinds)
    before = wkv.bwd_launch_count()
    got = wkv.rwkv6_wkv_heads_bwd(r, k, v, w, u, do, chunk=chunk)
    again = wkv.rwkv6_wkv_heads_bwd(r, k, v, w, u, do, chunk=chunk)
    assert wkv.bwd_launch_count() == before + 2
    want = wkv.rwkv6_wkv_heads_bwd_plain(r, k, v, w, u, do, chunk=chunk)
    torch.cuda.synchronize()
    assert [g.dtype for g in got] == [t.dtype for t in (r, k, v, w, u)]
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert _k5b_err(got, want) <= tol
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.needs_cuda
def test_cuda_k5b_without_the_carried_state_gradient_breaks_the_gate(cuda):
    """Negative control: dS dropped between chunks is far from the plain
    backward at the training shape."""
    case = K5B_CASES["rwkv6-train"]
    (r, k, v, w, u), do = _k5b_inputs(torch.Generator().manual_seed(6), case,
                                      (F32,) * 5)
    got = wkv.rwkv6_wkv_heads_bwd(r, k, v, w, u, do, carry=False)
    want = wkv.rwkv6_wkv_heads_bwd_plain(r, k, v, w, u, do)
    assert _k5b_err(got, want) > 1e-2


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtypes", list(K5B_DTYPES))
def test_cuda_k5b_per_row_bonus(cuda, dtypes):
    """u with one row per (batch, head) row (u_rows = BH): each row's du
    stays its own, within the tolerance of the plain version."""
    kinds, tol = K5B_DTYPES[dtypes]
    b, l, h, n, chunk = 2, 256, 4, 64, 64
    (r, k, v, w, _), do = _k5b_inputs(torch.Generator().manual_seed(8),
                                      (b, l, h, n, chunk), kinds)
    u = (torch.randn((b * h, n), generator=torch.Generator().manual_seed(9))
         * 0.5).to(kinds[4]).cuda()
    got = wkv.rwkv6_wkv_heads_bwd(r, k, v, w, u, do, chunk=chunk)
    want = wkv.rwkv6_wkv_heads_bwd_plain(r, k, v, w, u, do, chunk=chunk)
    assert got[4].shape == (b * h, n)
    assert _k5b_err(got, want) <= tol


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtypes", list(K5B_DTYPES))
def test_cuda_k5b_reads_strided_views(cuda, dtypes):
    """r, k, v, w as views of one wider [B, L, H, 5N] tensor, as the
    model's projections may be: the kernel reads them through their
    strides, as the plain version reads the same views."""
    kinds, tol = K5B_DTYPES[dtypes]
    b, l, h, n, chunk = 2, 192, 4, 32, 64
    gen = torch.Generator().manual_seed(10)
    wide = torch.randn((b, l, h, 5 * n), generator=gen)
    decay = torch.exp(-torch.exp(torch.rand((b, l, h, 5 * n), generator=gen)
                                 * 5 - 6))
    wide = wide.to(kinds[0]).cuda()  # r, k, v share a dtype in both sets
    r, k, v = (wide[..., i * n:(i + 1) * n] for i in (0, 2, 4))
    w = decay.to(kinds[3]).cuda()[..., n:2 * n]
    u = (torch.randn((h, n), generator=gen) * 0.5).to(kinds[4]).cuda()
    do = torch.randn((b, l, h, n), generator=gen).cuda()
    assert not r.is_contiguous() and not w.is_contiguous()
    got = wkv.rwkv6_wkv_heads_bwd(r, k, v, w, u, do, chunk=chunk)
    want = wkv.rwkv6_wkv_heads_bwd_plain(r, k, v, w, u, do, chunk=chunk)
    assert _k5b_err(got, want) <= tol


@pytest.mark.needs_cuda
@pytest.mark.parametrize("chunk", wkv.SIZES)
@pytest.mark.parametrize("n", wkv.SIZES)
def test_cuda_k5b_smem_bytes_match_the_plan(cuda, chunk, n):
    """k5b_plan's shared memory is what the library launches with."""
    lib = wkv._bound_bwd_library()
    for split in wkv.SPLITS:
        if split > 1 and n // split < wkv.MIN_SPLIT_COLUMNS:
            assert lib.rwkv6_wkv_bwd_smem(0, chunk, n, split) == 0
            continue
        assert lib.rwkv6_wkv_bwd_smem(0, chunk, n, split) == \
            wkv.k5b_smem("chain", chunk, n, split)
    assert lib.rwkv6_wkv_bwd_smem(1, chunk, n, 1) == \
        wkv.k5b_smem("chunk", chunk, n)


@pytest.mark.needs_cuda
def test_cuda_wkv_function_gradient_matches_cpu(cuda):
    """rwkv6_wkv_heads under autograd on the card (K5 forward, K5b
    backward, one launch each) against the plain path's gradients on the
    CPU, float32."""
    case = (2, 128, 4, 64, 64)
    ins, do = _k5b_inputs(torch.Generator().manual_seed(7), case, (F32,) * 5)
    grads = {}
    for dev in ("cpu", cuda):
        leaves = [t.to(dev).detach().requires_grad_() for t in ins]
        k5, k5b = wkv.launch_count(), wkv.bwd_launch_count()
        out = wkv.rwkv6_wkv_heads(*leaves)
        out.backward(do.to(dev))
        if dev == cuda:
            assert (wkv.launch_count(), wkv.bwd_launch_count()) == (k5 + 1,
                                                                    k5b + 1)
        grads[str(dev)] = [t.grad.cpu() for t in leaves]
    for g, x in zip(grads[str(cuda)], grads["cpu"]):
        assert float((g - x).abs().max() / x.abs().max()) <= 1e-4


# ---------------------------------------------------------------------------
# the process mesh's stream side (csrc/one_sided.cu) and a put across
# processes (launch/procs.py)
# ---------------------------------------------------------------------------

@pytest.mark.needs_cuda
def test_cuda_stream_wait_holds_the_stream_until_the_write(cuda):
    """signal_wait_on_stream holds its stream until a
    signal_write_on_stream on another stream brings the word to the
    epoch; GEQ: a later epoch releases it too.  Nothing here touches the
    default stream while the wait holds: it would wait behind it."""
    import ctypes
    import time

    lib = kb._bound_library()
    words = torch.zeros(2, dtype=torch.int32, device=cuda)
    x = torch.randn(1 << 20, device=cuda)
    out = torch.zeros_like(x)
    waiting, writing = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    ptr = words.data_ptr()

    def write(value):
        return lib.signal_write_on_stream(
            ptr, value, ctypes.c_void_p(writing.cuda_stream))

    try:
        with torch.cuda.stream(waiting):
            assert lib.signal_wait_on_stream(
                ptr, 5, ctypes.c_void_p(waiting.cuda_stream)) == 0
            out.copy_(x)
        time.sleep(0.2)
        held = not waiting.query()
        assert write(7) == 0
        until = time.monotonic() + 10
        while not waiting.query() and time.monotonic() < until:
            time.sleep(0.01)
        released = waiting.query()
    finally:
        # never leave a stream waiting: release it on the writing stream
        write(100)
        torch.cuda.synchronize()
    assert held and released
    assert torch.equal(out, x)
    assert int(words[0]) == 100 and int(words[1]) == 0


@pytest.mark.needs_cuda
def test_cuda_put_across_processes(cuda):
    """Two worker processes on the card: each one's K3 launch writes its
    tensor into the peer's receive buffer (mapped over CUDA IPC) and
    signal word; each receives its predecessor's."""
    from repro_torch.launch import procs

    res = procs.launch(procs.shift_put_job, 2, device="cuda",
                       slab_bytes=16 << 20, deadline=120)
    for r, got in enumerate(res):
        assert torch.equal(got["got"], torch.full((4096,), float(1 - r)))
        assert got["counts"]["remote_put"] == 1


@pytest.mark.needs_cuda
def test_cuda_sp_attention_across_processes_is_bitwise_the_virtual_mesh(cuda):
    """swift_torus on (pod 2, model 2) across 4 processes, bf16, with 8
    query heads over 2 KV heads so that the plan is P_u 2 x P_r 2 (K1, K2
    and K4 into the peers' slabs): every shard bitwise the virtual
    mesh's."""
    from repro_torch.launch import procs

    mesh = ((2, 2), ("pod", "model"))
    sp = dict(strategy="swift_torus", sp_axes=mesh[1], batch_axes=None,
              comm_backend="pallas", kernel_interpret=False)
    case = dict(mesh=mesh, sp=sp, shape=(2, 512, 8, 2, 128), seed=3,
                dtype="bfloat16")
    res = procs.launch(procs.sp_attention_job, 4, [case], device="cuda",
                       slab_bytes=64 << 20, deadline=120)
    q, k, v = procs._sp_inputs(case, cuda)
    want = sp_attention(q, k, v, cfg=SPConfig(**sp),
                        mesh=make_mesh(*mesh, device=cuda)).cpu()
    for r, worker in enumerate(res):
        lo, hi = worker[0]["rows"]
        assert torch.equal(worker[0]["shards"][0], want[:, lo:hi]), r
        assert worker[0]["counts"]["ring_flash_step"] > 0
        assert worker[0]["counts"]["landing_copy"] > 0
