"""Online-softmax partial attention and merge algebra (paper Appendix C).

SwiftFusion's Ring and Torus attention both compute attention of one query
chunk against *multiple* KV chunks that arrive at different times.  Each
partial computation produces a triplet ``A_i = (O'_i, l_i, m_i)`` where

    m_i = rowmax(Q K_i^T * scale)
    l_i = rowsum(exp(Q K_i^T * scale - m_i))
    O'_i = exp(Q K_i^T * scale - m_i) @ V_i        (FlashAttention-2 style:
                                                    *unnormalised* by l_i)

and two triplets merge associatively (Appendix C, eq. 2-3):

    m = max(m_i, m_j)
    l = l_i e^{m_i - m} + l_j e^{m_j - m}
    O' = O'_i e^{m_i - m} + O'_j e^{m_j - m}

with one division ``O = O'/l`` at the very end (``finalize``).

All functions are plain torch and GQA-aware; they are the oracle against
which the CUDA kernel (kernels/flash_mqkv.py) is validated, and the
(O', l, m) state the kernel carries follows this algebra.

Shapes (B = batch, Lq/Lk = seq, Hq/Hkv = heads, D = head dim):
    q: [B, Lq, Hq, D]    k, v: [B, Lk, Hkv, D]
    o: [B, Lq, Hq, D]    l, m: [B, Hq, Lq]
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

NEG_INF = float("-inf")


class Partial(NamedTuple):
    """FA2-style intermediate result A' = (O' = O*l, l, m)."""

    o: torch.Tensor  # [B, Lq, Hq, D], unnormalised
    l: torch.Tensor  # [B, Hq, Lq]
    m: torch.Tensor  # [B, Hq, Lq]


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    """Attention masking for one (q-chunk, kv-chunk) pair.

    Positions are *global* sequence positions, so chunked/distributed
    schedules apply exactly the same mask the single-device computation
    would, even when a gathered chunk is discontinuous in the global
    sequence (paper §4.3: received chunks "can be discontinuous").

    Either give scalar offsets (``q_offset``/``k_offset``, chunk is then
    contiguous from there) or explicit per-element position tensors
    (``q_pos``/``k_pos``), which take precedence.

    ``causal``: standard autoregressive mask (q attends to k ≤ q).
    ``window``: sliding-window size; q attends to k in
                (q_pos - window, q_pos].  ``None`` = unlimited.
    ``valid_k``: optional [Lk] bool — False masks a key out entirely.
    """

    causal: bool = False
    window: int | None = None
    q_offset: int = 0
    k_offset: int = 0
    q_pos: torch.Tensor | None = None
    k_pos: torch.Tensor | None = None
    valid_k: torch.Tensor | None = None

    def bias(self, lq: int, lk: int, device=None,
             dtype=torch.float32) -> torch.Tensor | None:
        if not self.causal and self.window is None and self.valid_k is None:
            return None
        q_pos = (self.q_pos if self.q_pos is not None
                 else torch.arange(lq, device=device) + self.q_offset)
        k_pos = (self.k_pos if self.k_pos is not None
                 else torch.arange(lk, device=device) + self.k_offset)
        ok = torch.ones((lq, lk), dtype=torch.bool, device=device)
        if self.causal:
            ok &= q_pos[:, None] >= k_pos[None, :]
        if self.window is not None:
            ok &= k_pos[None, :] > (q_pos[:, None] - self.window)
        if self.valid_k is not None:
            ok &= self.valid_k[None, :]
        zero = torch.zeros((), dtype=dtype, device=device)
        return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def empty_partial(batch: int, lq: int, hq: int, d: int,
                  dtype=torch.float32, device=None) -> Partial:
    """Identity element of the merge monoid."""
    return Partial(
        o=torch.zeros((batch, lq, hq, d), dtype=dtype, device=device),
        l=torch.zeros((batch, hq, lq), dtype=dtype, device=device),
        m=torch.full((batch, hq, lq), NEG_INF, dtype=dtype, device=device),
    )


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, L, Hkv, D] -> [B, L, Hkv * n_rep, D] (GQA broadcast)."""
    if n_rep == 1:
        return x
    return x.repeat_interleave(n_rep, dim=2)


def _where_neginf(x: torch.Tensor, value: float,
                  other: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isneginf(x), torch.full_like(other, value), other)


def attend_partial(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float | None = None,
    mask: MaskSpec | None = None,
) -> Partial:
    """Unnormalised attention of q against one KV chunk (Appendix C eq. 1)."""
    b, lq, hq, d = q.shape
    _, lk, hkv, _ = k.shape
    assert hq % hkv == 0, f"GQA requires Hkv | Hq, got {hq=} {hkv=}"
    k = _repeat_kv(k, hq // hkv)
    v = _repeat_kv(v, hq // hkv)
    if scale is None:
        scale = d ** -0.5
    s = torch.einsum("blhd,bkhd->bhlk", q, k) * scale
    s = s.float()
    if mask is not None:
        bias = mask.bias(lq, lk, device=q.device)
        if bias is not None:
            s = s + bias[None, None]
    m = s.amax(dim=-1)  # [B, Hq, Lq]
    # Fully-masked rows have m == -inf; exp(-inf - -inf) would be NaN.
    safe_m = _where_neginf(m, 0.0, m)
    p = torch.exp(s - safe_m[..., None])  # [B, Hq, Lq, Lk]
    p = _where_neginf(s, 0.0, p)
    l = p.sum(dim=-1)  # [B, Hq, Lq]
    o = torch.einsum("bhlk,bkhd->blhd", p.to(v.dtype), v)
    return Partial(o=o.float(), l=l, m=m)


def attend_partial_blockwise(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float | None = None,
    mask: MaskSpec | None = None,
    kv_block: int = 1024,
) -> Partial:
    """attend_partial with the KV dim processed in blocks + online merge —
    caps the materialized score matrix at [B, H, Lq, kv_block].  Eager
    execution runs the blocks in order, so no schedule barrier is needed
    to keep every block's score matrix from being live at once."""
    b, lq, hq, d = q.shape
    lk = k.shape[1]
    if lk <= kv_block:
        return attend_partial(q, k, v, scale=scale, mask=mask)
    acc = empty_partial(b, lq, hq, d, device=q.device)
    for i in range(0, lk, kv_block):
        j = min(i + kv_block, lk)
        if mask is not None:
            kp = (mask.k_pos[i:j] if mask.k_pos is not None
                  else torch.arange(i, j, device=q.device) + mask.k_offset)
            vk = mask.valid_k[i:j] if mask.valid_k is not None else None
            m = dataclasses.replace(mask, k_pos=kp, k_offset=0, valid_k=vk)
        else:
            m = None
        acc = merge(acc, attend_partial(q, k[:, i:j], v[:, i:j],
                                        scale=scale, mask=m))
    return acc


def merge(a: Partial, b: Partial) -> Partial:
    """Associative, commutative merge of two partials (Appendix C eq. 2-3)."""
    m = torch.maximum(a.m, b.m)

    def scale_of(mi):
        both = torch.isneginf(mi) & torch.isneginf(m)
        return torch.exp(torch.where(both, torch.zeros_like(mi), mi - m))

    ea = scale_of(a.m)
    eb = scale_of(b.m)
    l = a.l * ea + b.l * eb
    # broadcast [B,Hq,Lq] -> [B,Lq,Hq,1] for the output tensor layout
    t = lambda e: e.transpose(1, 2)[..., None]
    o = a.o * t(ea) + b.o * t(eb)
    return Partial(o=o, l=l, m=m)


def finalize(p: Partial, dtype=None) -> torch.Tensor:
    """O = O' / l with one division at the end (Appendix C 'optimizing FP ops')."""
    l = p.l.transpose(1, 2)[..., None]  # [B, Lq, Hq, 1]
    o = p.o / torch.where(l == 0.0, torch.ones_like(l), l)
    return o.to(dtype or p.o.dtype)


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float | None = None,
    mask: MaskSpec | None = None,
) -> torch.Tensor:
    """Plain single-device softmax attention — the ground-truth oracle."""
    return finalize(attend_partial(q, k, v, scale=scale, mask=mask),
                    dtype=q.dtype)


def attend_chunked(
    q: torch.Tensor,
    kv_chunks: list[tuple[torch.Tensor, torch.Tensor, int]],
    *,
    scale: float | None = None,
    causal: bool = False,
    window: int | None = None,
    q_offset: int = 0,
) -> Partial:
    """Attention of q against a list of (k, v, k_offset) chunks, merged.

    Mirrors what Ring/Torus attention computes step-by-step; used by tests
    to check chunk-order invariance.
    """
    b, lq, hq, d = q.shape
    acc = empty_partial(b, lq, hq, d, device=q.device)
    for k, v, k_off in kv_chunks:
        mask = MaskSpec(causal=causal, window=window, q_offset=q_offset,
                        k_offset=k_off)
        acc = merge(acc, attend_partial(q, k, v, scale=scale, mask=mask))
    return acc
