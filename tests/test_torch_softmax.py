"""The port's online-softmax algebra (core/softmax.py) against the
reference on the same numpy inputs, over tests/test_softmax.py's cases and
at its tolerances."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import softmax as js
from repro_torch.core import softmax as ts


def _partial_np(seed, b=1, lq=4, hq=2, d=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, lq, hq, d)).astype(np.float32),
            np.log1p(np.exp(rng.standard_normal((b, hq, lq)))).astype(np.float32),
            (rng.standard_normal((b, hq, lq)) * 3.0).astype(np.float32))


def _jp(a):
    return js.Partial(*(jnp.asarray(x) for x in a))


def _tp(a):
    return ts.Partial(*(torch.from_numpy(x) for x in a))


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("seeds", [(0, 1, 2), (3, 4, 5), (6, 7, 8)])
def test_merge_associative_matches_reference(seeds):
    a, b, c = (_partial_np(s) for s in seeds)
    want = js.finalize(js.merge(js.merge(_jp(a), _jp(b)), _jp(c)))
    left = ts.finalize(ts.merge(ts.merge(_tp(a), _tp(b)), _tp(c)))
    right = ts.finalize(ts.merge(_tp(a), ts.merge(_tp(b), _tp(c))))
    _close(left, want)
    _close(right, want)


@pytest.mark.parametrize("seeds", [(10, 11), (12, 13)])
def test_merge_commutative_matches_reference(seeds):
    a, b = (_partial_np(s) for s in seeds)
    want = js.finalize(js.merge(_jp(a), _jp(b)))
    _close(ts.finalize(ts.merge(_tp(a), _tp(b))), want)
    _close(ts.finalize(ts.merge(_tp(b), _tp(a))), want)


@pytest.mark.parametrize("seed", [20, 21])
def test_merge_identity_matches_reference(seed):
    a = _partial_np(seed)
    e = ts.empty_partial(*a[0].shape)
    want = js.finalize(_jp(a))
    _close(ts.finalize(ts.merge(_tp(a), e)), want, rtol=1e-6, atol=0)
    _close(ts.finalize(ts.merge(e, _tp(a))), want, rtol=1e-6, atol=0)


def _qkv(seed, b, l, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, l, hq, d), (b, l, hkv, d), (b, l, hkv, d))]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("window", [None, 10])
@pytest.mark.parametrize("n_chunks", [1, 2, 4])
def test_chunked_equals_reference_full(causal, window, n_chunks):
    b, l, hq, hkv, d = 2, 32, 4, 2, 16
    q, k, v = _qkv(0, b, l, hq, hkv, d)
    want = js.reference_attention(
        *(jnp.asarray(x) for x in (q, k, v)),
        mask=js.MaskSpec(causal=causal, window=window))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    cs = l // n_chunks
    chunks = [(tk[:, i * cs:(i + 1) * cs], tv[:, i * cs:(i + 1) * cs], i * cs)
              for i in range(n_chunks)]
    got = ts.finalize(ts.attend_chunked(tq, chunks, causal=causal,
                                        window=window))
    _close(got, want)
    _close(ts.reference_attention(tq, tk, tv, mask=ts.MaskSpec(
        causal=causal, window=window)), want)


def test_chunk_order_invariance():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 1, 24, 2, 2, 8))
    chunks = [(k[:, i:i + 8], v[:, i:i + 8], i) for i in range(0, 24, 8)]
    a = ts.finalize(ts.attend_chunked(q, chunks, causal=True))
    b = ts.finalize(ts.attend_chunked(q, chunks[::-1], causal=True))
    _close(a, b)


def test_fully_masked_rows_match_reference():
    """Rows with zero valid keys: o = 0, l = 0, m = -inf in both."""
    ones = np.ones((1, 4, 1, 8), np.float32)
    mask_kw = dict(causal=True, q_offset=0, k_offset=100)
    want = js.attend_partial(*(jnp.asarray(ones),) * 3,
                             mask=js.MaskSpec(**mask_kw))
    got = ts.attend_partial(*(torch.from_numpy(ones),) * 3,
                            mask=ts.MaskSpec(**mask_kw))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    out = ts.finalize(got)
    assert torch.isfinite(out).all() and torch.all(out == 0)


def test_blockwise_and_valid_k_match_reference():
    q, k, v = _qkv(2, 1, 40, 2, 1, 8)
    valid = np.arange(40) % 7 != 3
    jm = js.MaskSpec(causal=True, q_offset=5, valid_k=jnp.asarray(valid))
    tm = ts.MaskSpec(causal=True, q_offset=5, valid_k=torch.from_numpy(valid))
    want = js.attend_partial_blockwise(*(jnp.asarray(x) for x in (q, k, v)),
                                       mask=jm, kv_block=16)
    got = ts.attend_partial_blockwise(*(torch.from_numpy(x) for x in (q, k, v)),
                                      mask=tm, kv_block=16)
    for g, w in zip(got, want):
        _close(g, w)
