"""[B, L, H, D]-layout entry points around the flash_mqkv kernel (K1).

``flash_attention``          — drop-in attention with GQA, padding to block
                               multiples and position tensors.
``flash_attention_segments`` — the Algorithm-2 use case: one Q against a
                               *list* of discontiguous KV chunks, carrying
                               the online-softmax state across kernel calls
                               and finalizing once (Appendix C).

Lowering is chosen by the tensors' device inside ``flash_mqkv`` (plain
version on the CPU, the CUDA kernel on the GPU); eager PyTorch has no
trace cache to key, so the kernel's launch counter
(``flash_mqkv.launch_count``) is the observable that shows which path ran.
``block_q`` / ``block_k`` are the padding granularity: q positions pad
with 0 and k positions with -1, exactly as the reference pads for its
block-tiled Pallas kernel.
"""
from __future__ import annotations

import torch

from .flash_mqkv import DEFAULT_BLOCK_K, DEFAULT_BLOCK_Q, flash_mqkv


def _pad_to(x: torch.Tensor, axis: int, mult: int, value=0) -> torch.Tensor:
    size = x.shape[axis]
    pad = (-size) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    fill = torch.full(shape, value, dtype=x.dtype, device=x.device)
    return torch.cat([x, fill], dim=axis)


def _flatten_heads(x: torch.Tensor) -> torch.Tensor:
    b, l, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, l, d).contiguous()


def _unflatten_heads(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    bh, l, d = x.shape
    return x.reshape(b, h, l, d).permute(0, 2, 1, 3)


def _positions(pos: torch.Tensor | None, n: int,
               device: torch.device) -> torch.Tensor:
    if pos is None:
        return torch.arange(n, dtype=torch.int32, device=device)
    return pos.to(device=device, dtype=torch.int32)


def flash_attention(
    q: torch.Tensor,  # [B, Lq, Hq, D]
    k: torch.Tensor,  # [B, Lk, Hkv, D]
    v: torch.Tensor,
    q_pos: torch.Tensor | None = None,  # [Lq]
    k_pos: torch.Tensor | None = None,  # [Lk]
    *,
    causal: bool = False,
    window: int | None = None,
    scale: float | None = None,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
) -> torch.Tensor:
    """Drop-in flash attention; returns [B, Lq, Hq, D] in q's dtype."""
    b, lq, hq, d = q.shape
    _, lk, hkv, _ = k.shape
    group = hq // hkv
    bq = min(block_q, max(8, lq))
    bk = min(block_k, max(8, lk))
    qf = _pad_to(_flatten_heads(q), 1, bq)
    kf = _pad_to(_flatten_heads(k), 1, bk)
    vf = _pad_to(_flatten_heads(v), 1, bk)
    qpp = _pad_to(_positions(q_pos, lq, q.device), 0, bq, value=0)
    kpp = _pad_to(_positions(k_pos, lk, q.device), 0, bk, value=-1)
    o, _, _ = flash_mqkv(qf, kf, vf, qpp, kpp, group=group, scale=scale,
                         causal=causal, window=window, state=None,
                         finalize=True)
    return _unflatten_heads(o[:, :lq], b, hq)


def flash_attention_segments(
    q: torch.Tensor,  # [B, Lq, Hq, D]
    segments: list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    q_pos: torch.Tensor | None = None,
    *,
    causal: bool = False,
    window: int | None = None,
    scale: float | None = None,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
) -> torch.Tensor:
    """Attention of one Q against multiple discontiguous KV chunks — the
    RINGATTN inner loop of Algorithm 1 with the Algorithm-2 fused merge:
    the (O', l, m) state is carried across kernel calls, one division at
    the very end.  Each segment is ``(k, v, k_pos)``."""
    b, lq, hq, d = q.shape
    bq = min(block_q, max(8, lq))
    qf = _pad_to(_flatten_heads(q), 1, bq)
    qpp = _pad_to(_positions(q_pos, lq, q.device), 0, bq, value=0)

    state = None
    for i, (k, v, k_pos) in enumerate(segments):
        _, lk, hkv, _ = k.shape
        group = hq // hkv
        bk = min(block_k, max(8, lk))
        kf = _pad_to(_flatten_heads(k), 1, bk)
        vf = _pad_to(_flatten_heads(v), 1, bk)
        kpp = _pad_to(_positions(k_pos, lk, q.device), 0, bk, value=-1)
        last = i == len(segments) - 1
        out = flash_mqkv(qf, kf, vf, qpp, kpp, group=group, scale=scale,
                         causal=causal, window=window, state=state,
                         finalize=last)
        if last:
            o = out[0]
        else:
            state = out
    return _unflatten_heads(o[:, :lq].to(q.dtype), b, hq)
