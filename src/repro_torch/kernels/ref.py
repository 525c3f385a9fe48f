"""Plain PyTorch oracle for the flash_mqkv kernel (paper Algorithm 2
semantics) — the plain version of K1.

Same contract as kernels.ops.flash_attention: position-tensor masking
(k_pos = -1 marks padding), optional carried-in online-softmax state, and
optional finalization.  It materialises the whole [BH, Lq, Lk] score
matrix; the CUDA kernel computes the same function tile by tile.
"""
from __future__ import annotations

import torch

NEG_INF = float("-inf")


def flash_attention_ref(
    q: torch.Tensor,  # [BH, Lq, D]
    k: torch.Tensor,  # [BH, Lk, D]
    v: torch.Tensor,  # [BH, Lk, D]
    q_pos: torch.Tensor,  # [Lq] int32 global positions
    k_pos: torch.Tensor,  # [Lk] int32; -1 = padding (masked out)
    *,
    scale: float | None = None,
    causal: bool = False,
    window: int | None = None,
    state: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
    finalize: bool = True,
):
    """Returns o [BH, Lq, D] if finalize else (o', l, m) FA2-style state."""
    bh, lq, d = q.shape
    if scale is None:
        scale = d ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    ok = (k_pos >= 0)[None, :]
    if causal:
        ok = ok & (q_pos[:, None] >= k_pos[None, :])
    if window is not None:
        ok = ok & (k_pos[None, :] > q_pos[:, None] - window)
    s = s.masked_fill(~ok[None], NEG_INF)

    m_cur = s.amax(dim=-1)  # [BH, Lq]
    if state is not None:
        o_in, l_in, m_in = state
        m_new = torch.maximum(m_in, m_cur)
    else:
        o_in = torch.zeros((bh, lq, d), dtype=torch.float32, device=q.device)
        l_in = torch.zeros((bh, lq), dtype=torch.float32, device=q.device)
        m_in = torch.full((bh, lq), NEG_INF, dtype=torch.float32,
                          device=q.device)
        m_new = m_cur
    safe_m = m_new.masked_fill(torch.isneginf(m_new), 0.0)
    p = torch.exp(s - safe_m[..., None])
    p = p.masked_fill(torch.isneginf(s), 0.0)
    corr = torch.exp(m_in - safe_m).masked_fill(torch.isneginf(m_in), 0.0)
    l = l_in * corr + p.sum(dim=-1)
    o = o_in * corr[..., None] + torch.einsum("bqk,bkd->bqd", p, v.float())
    if not finalize:
        return o, l, m_new
    # l == 0 only for rows with no visible key: their o is 0, kept as 0
    return (o / torch.where(l == 0.0, torch.ones_like(l), l)[..., None]
            ).to(q.dtype)
