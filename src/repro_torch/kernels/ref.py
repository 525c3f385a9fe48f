"""Plain PyTorch versions of the port's compute kernels.

``flash_attention_ref`` is the plain version of K1 (flash_mqkv, paper
Algorithm 2 semantics), with the contract of kernels.ops.flash_attention:
position-tensor masking (k_pos = -1 marks padding), optional carried-in
online-softmax state, and optional finalization.  It materialises the
whole [BH, Lq, Lk] score matrix; the CUDA kernel computes the same
function tile by tile.

``flash_mqkv_bwd_plain`` is the plain version of K1b, K1's gradient: the
explicit FlashAttention-2 backward formula on the forward's saved
(o, l, m), which the CUDA kernel computes tile by tile.

``rwkv6_wkv_ref`` is the plain version of K5 (the RWKV6 WKV scan): the
chunked matmul form of the reference's Pallas kernel, chunk by chunk with
the [N, N] state carried in float32.
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


def flash_mqkv_bwd_plain(
    q: torch.Tensor,  # [BH, Lq, D]
    k: torch.Tensor,  # [BHkv, Lk, D]
    v: torch.Tensor,
    o: torch.Tensor,  # [BH, Lq, D] the finalized forward output
    do: torch.Tensor,  # [BH, Lq, D] the gradient of o
    m: torch.Tensor,  # [BH, Lq] f32 row maxima of the scaled scores
    l: torch.Tensor,  # [BH, Lq] f32 row sums of exp(s - m)
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    *,
    group: int = 1,
    scale: float | None = None,
    causal: bool = False,
    window: int | None = None,
):
    """(dq, dk, dv) of the finalized, stateless flash_mqkv, from the
    forward's saved (o, l, m):

        Δ  = rowsum(dO ∘ o)
        P  = exp(S·scale − m) / l   (0 where masked and on rows with l == 0)
        dV = Pᵀ dO,   dS = P ∘ (dO Vᵀ − Δ)
        dQ = dS K·scale,   dK = dSᵀ Q·scale

    with dK and dV summed over the ``group`` q heads that read a KV head.
    A row with no visible key (l == 0, m = −inf) gives zero gradients.
    Float32 arithmetic; the results take q's, k's and v's dtypes."""
    bh, lq, d = q.shape
    bhkv, lk, _ = k.shape
    if scale is None:
        scale = d ** -0.5
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(group, dim=0)
    vf = v.float().repeat_interleave(group, dim=0)
    delta = (dof * o.float()).sum(dim=-1)  # [BH, Lq]
    s = torch.einsum("bqd,bkd->bqk", qf, kf) * scale
    ok = (k_pos >= 0)[None, :]
    if causal:
        ok = ok & (q_pos[:, None] >= k_pos[None, :])
    if window is not None:
        ok = ok & (k_pos[None, :] > q_pos[:, None] - window)
    live = l > 0.0
    safe_m = torch.where(live, m, torch.zeros_like(m))
    safe_l = torch.where(live, l, torch.ones_like(l))
    p = torch.exp(s - safe_m[..., None]) / safe_l[..., None]
    p = torch.where(ok[None] & live[..., None], p, torch.zeros_like(p))
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    ds = p * (torch.einsum("bqd,bkd->bqk", dof, vf) - delta[..., None])
    dq = torch.einsum("bqk,bkd->bqd", ds, kf) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, qf) * scale
    dk = dk.reshape(bhkv, group, lk, d).sum(dim=1)
    dv = dv.reshape(bhkv, group, lk, d).sum(dim=1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# decays are clipped to [WKV_EPS, 1], as in the reference kernel
WKV_EPS = 1e-6
WKV_CHUNK = 64


def wkv_chunk(l: int, chunk: int) -> int:
    """The chunk the scan runs at: ``min(chunk, l)``, which must divide l."""
    if l < 1 or chunk < 1:
        raise ValueError(f"WKV scan needs L >= 1 and chunk >= 1, got L {l}, "
                         f"chunk {chunk}")
    c = min(chunk, l)
    if l % c:
        raise ValueError(f"sequence length {l} is not a multiple of the WKV "
                         f"chunk {c}")
    return c


def rwkv6_wkv_ref(
    r: torch.Tensor,  # [BH, L, N]
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,  # decay in (0, 1]
    u: torch.Tensor,  # [BH, N] per-head bonus
    *,
    chunk: int = WKV_CHUNK,
) -> torch.Tensor:
    """o [BH, L, N] (float32) of the recurrence

        S_t = diag(w_t) S_{t-1} + k_t^T v_t
        o_t = r_t (S_{t-1} + diag(u) k_t^T v_t),   S_0 = 0,

    in the reference kernel's chunk form: within a chunk of c steps,
    o = ((r·D₋)(k/D)^T ⊙ tril₋₁) v + diag(r·u·k) v + (r·D₋) S_in with D the
    inclusive cumulative decay and D₋ the exclusive one, then
    S = a_c ⊙ S_in + ((k/D) ⊙ a_c)^T v with a_c = D at the chunk's end.
    Every input may be float32 or bfloat16; the arithmetic is float32."""
    bh, l, n = r.shape
    c = wkv_chunk(l, chunk)
    nc = l // c
    f = lambda t: t.float().reshape(bh, nc, c, n)
    rf, kf, vf = f(r), f(k), f(v)
    logw = torch.log(torch.clamp(f(w), WKV_EPS, 1.0))
    log_d = torch.cumsum(logw, dim=2)
    d = torch.exp(log_d)  # [bh, nc, c, n]
    d_m1 = torch.exp(log_d - logw)
    r_sc = rf * d_m1
    k_sc = kf / d
    att = torch.einsum("bgtn,bgsn->bgts", r_sc, k_sc)
    att = torch.tril(att, diagonal=-1)
    diag = (rf * u.float()[:, None, None, :] * kf).sum(dim=-1, keepdim=True)
    o = torch.einsum("bgts,bgsn->bgtn", att, vf) + diag * vf
    a_c = d[:, :, -1]  # [bh, nc, n]
    k_tail = k_sc * a_c[:, :, None, :]
    s = torch.zeros((bh, n, n), dtype=torch.float32, device=r.device)
    outs = []
    for g in range(nc):
        outs.append(o[:, g] + torch.einsum("btn,bnm->btm", r_sc[:, g], s))
        s = a_c[:, g, :, None] * s + torch.einsum("bsn,bsm->bnm",
                                                  k_tail[:, g], vf[:, g])
    return torch.stack(outs, dim=1).reshape(bh, l, n)
