"""K1 (flash_mqkv) in the port against the reference kernel.

The same numpy inputs go through the reference's Pallas kernel in
interpret mode and through the port's entry points, which on CPU tensors
run the kernel's plain PyTorch version.  Cases and tolerances are those of
tests/test_kernels.py.  The CUDA kernel itself is held to the plain version
on the card by tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as j_flash
from repro.kernels import flash_attention_segments as j_segments
from repro.kernels.flash_mqkv import flash_mqkv as j_mqkv
from repro_torch.kernels import flash_attention, flash_attention_segments
from repro_torch.kernels import flash_mqkv as fm

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
