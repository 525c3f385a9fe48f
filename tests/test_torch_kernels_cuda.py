"""K1's CUDA kernel against its plain PyTorch version, on the card.

Every test here is marked ``needs_cuda`` and skips without a GPU.  The
file imports neither jax nor the reference package, so it also runs on a
machine without jax, where tests/conftest.py (which imports jax) has to be
left out:

    PYTHONPATH=src python -m pytest --noconftest -m needs_cuda \
        tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import flash_attention, flash_attention_segments
from repro_torch.kernels import flash_mqkv as fm


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
    q = torch.zeros((2, 16, 48), device=cuda)
    pos = torch.arange(16, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        fm.flash_mqkv(q, q, q, pos, pos)
    q = torch.zeros((2, 16, 32), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        fm.flash_mqkv(q, q, q, pos, pos)


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
    the CPU; so do f32 q/k/v (bf16 q/k/v are loaded as 16-byte vectors)."""
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
