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

``rwkv6_wkv_bwd_plain`` is the plain version of K5b, K5's gradient: the
explicit backward of that chunk form, the chunks' entry states from a
forward sweep, the state's gradient carried back chunk by chunk.
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


def wkv_bwd_operands(r, k, v, w, u, do, *, chunk: int = WKV_CHUNK) -> dict:
    """What every pass of the WKV backward reads: the inputs in float32
    chunk form [BH, nc, c, N], the clipped decays, log w, D, D₋, r_sc =
    r·D₋, k_sc = k/D, a = D at each chunk's end [BH, nc, N], and u per row
    [BH, N] (row bh reads u[bh % U])."""
    bh, l, n = r.shape
    rows = u.shape[0]
    if bh % rows:
        raise ValueError(f"u has {rows} rows, which do not divide BH {bh}")
    c = wkv_chunk(l, chunk)
    nc = l // c
    f = lambda t: t.float().reshape(bh, nc, c, n)
    rf, kf, vf, wf, dof = f(r), f(k), f(v), f(w), f(do)
    wc = torch.clamp(wf, WKV_EPS, 1.0)
    logw = torch.log(wc)
    log_d = torch.cumsum(logw, dim=2)
    d = torch.exp(log_d)
    d_m1 = torch.exp(log_d - logw)
    return {"rf": rf, "kf": kf, "vf": vf, "wf": wf, "dof": dof, "wc": wc,
            "d": d, "d_m1": d_m1, "r_sc": rf * d_m1, "k_sc": kf / d,
            "a_c": d[:, :, -1], "ur": u.float().repeat(bh // rows, 1),
            "c": c, "nc": nc}


def wkv_bwd_entry_states(ops: dict) -> list:
    """Pass 1: every chunk's entry state S_in[g] [BH, N, N], as the forward
    carries it (S_{g+1} = a_g ⊙ S_g + (k_sc ⊙ a)_gᵀ v_g from S_0 = 0)."""
    k_sc, a_c, vf = ops["k_sc"], ops["a_c"], ops["vf"]
    bh, _, _, n = k_sc.shape
    s = torch.zeros((bh, n, n), dtype=torch.float32, device=k_sc.device)
    s_in = []
    for g in range(ops["nc"]):
        s_in.append(s)
        s = a_c[:, g, :, None] * s + torch.einsum(
            "bsn,bsm->bnm", k_sc[:, g] * a_c[:, g, None, :], vf[:, g])
    return s_in


def wkv_bwd_exit_grads(ops: dict) -> list:
    """Pass 2: the gradient dS[g] [BH, N, N] of every chunk's exit state,
    carried back from 0 after the last chunk (dS_{g−1} = a_g ⊙ dS_g +
    r_sc,gᵀ dO_g)."""
    r_sc, a_c, dof = ops["r_sc"], ops["a_c"], ops["dof"]
    bh, nc, _, n = r_sc.shape
    ds = torch.zeros((bh, n, n), dtype=torch.float32, device=r_sc.device)
    out = [None] * nc
    for g in reversed(range(nc)):
        out[g] = ds
        ds = a_c[:, g][..., None] * ds + torch.einsum("btn,btm->bnm",
                                                      r_sc[:, g], dof[:, g])
    return out


def wkv_bwd_chunk(ops: dict, g: int, s_in: torch.Tensor, ds: torch.Tensor):
    """Pass 3: chunk g's gradients given its entry state ``s_in`` and the
    gradient ``ds`` of its exit state: (dr, dk, dv, dw) [BH, c, N] float32
    and du's partial Σ_t r ⊙ k (dO_t·v_t) [BH, N].  A chunk reads nothing
    of the others."""
    c = ops["c"]
    below = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                  device=s_in.device), diagonal=-1)
    rs, ks = ops["r_sc"][:, g], ops["k_sc"][:, g]
    vg, dog, a = ops["vf"][:, g], ops["dof"][:, g], ops["a_c"][:, g]
    rf, kf, wf, ur = ops["rf"][:, g], ops["kf"][:, g], ops["wf"][:, g], ops["ur"]
    att = torch.einsum("btn,bsn->bts", rs, ks).masked_fill(~below, 0.0)
    dov = torch.einsum("btm,bsm->bts", dog, vg)
    datt = dov.masked_fill(~below, 0.0)
    bd = torch.diagonal(dov, dim1=1, dim2=2)  # [bh, c]: dO_t · v_t
    bonus = (rf * ur[:, None] * kf).sum(dim=-1)
    x = torch.einsum("bsm,bnm->bsn", vg, ds)  # v dSᵀ
    dv = (torch.einsum("bts,btm->bsm", att, dog) + bonus[..., None] * dog
          + torch.einsum("bsn,bnm->bsm", ks * a[:, None], ds))
    drs = (torch.einsum("bts,bsn->btn", datt, ks)
           + torch.einsum("btm,bnm->btn", dog, s_in))
    dks = torch.einsum("bts,btn->bsn", datt, rs) + a[:, None] * x
    da = (s_in * ds).sum(dim=-1) + (ks * x).sum(dim=1)
    p, q = drs * rs, dks * ks
    rev = lambda t: torch.flip(torch.cumsum(torch.flip(t, (1,)), 1), (1,))
    dlogw = rev(p) - p - rev(q) + (da * a)[:, None]
    dr = drs * ops["d_m1"][:, g] + ur[:, None] * kf * bd[..., None]
    dk = dks / ops["d"][:, g] + ur[:, None] * rf * bd[..., None]
    inside = (wf >= WKV_EPS) & (wf <= 1.0)
    dw = torch.where(inside, dlogw / ops["wc"][:, g], 0.0)
    du = (rf * kf * bd[..., None]).sum(dim=1)
    return dr, dk, dv, dw, du


def rwkv6_wkv_bwd_plain(
    r: torch.Tensor,  # [BH, L, N]
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,  # decay in (0, 1]
    u: torch.Tensor,  # [U, N]: row bh reads u[bh % U]
    do: torch.Tensor,  # [BH, L, N] the gradient of o
    *,
    chunk: int = WKV_CHUNK,
):
    """(dr, dk, dv, dw, du) of ``rwkv6_wkv_ref`` (with row bh reading u[bh
    % U], U dividing BH) given the gradient ``do`` of its output, in the
    three passes K5b runs: the entry states (``wkv_bwd_entry_states``), the
    exit-state gradients (``wkv_bwd_exit_grads``), then each chunk's
    gradients given both (``wkv_bwd_chunk``).  Per chunk, with r_sc = r·D₋,
    k_sc = k/D, a = D at the chunk's end, A = tril(r_sc k_scᵀ, −1), S_in
    the chunk's entry state and dS the gradient of its exit state (0 after
    the last chunk):

        dv    = Aᵀ dO + diag(r·u·k) dO + (k_sc ⊙ a) dS
        dr_sc = tril(dO vᵀ, −1) k_sc + dO S_inᵀ
        dk_sc = tril(dO vᵀ, −1)ᵀ r_sc + a ⊙ (v dSᵀ)
        da    = rowsum(S_in ⊙ dS) + colsum(k_sc ⊙ v dSᵀ)
        dS   ← r_scᵀ dO + diag(a) dS          (to the previous chunk)

    then r = r_sc / D₋ and k = k_sc · D, the bonus terms (dO_t·v_t) u k and
    (dO_t·v_t) u r, and the log-decay terms summed back in the chunk:
    d log w_s = Σ_{t>s} dr_sc·r_sc − Σ_{t≥s} dk_sc·k_sc + da·a.  du sums
    r ⊙ k (dO_t·v_t) over the chunks (last first) and over the rows that
    read it, in row order.  The clip's rule is torch.clamp's: dw = d log w
    / w where 1e-6 ≤ w ≤ 1, both ends included (at w == 1 exactly jnp.clip
    would pass half), and 0 outside.  Float32 arithmetic; the results take
    the inputs' dtypes."""
    bh, l, n = r.shape
    ops = wkv_bwd_operands(r, k, v, w, u, do, chunk=chunk)
    s_in, ds = wkv_bwd_entry_states(ops), wkv_bwd_exit_grads(ops)
    grads = [torch.empty_like(ops["rf"]) for _ in range(4)]
    du = torch.zeros((bh, n), dtype=torch.float32, device=r.device)
    for g in reversed(range(ops["nc"])):
        *parts, du_g = wkv_bwd_chunk(ops, g, s_in[g], ds[g])
        for gr, part in zip(grads, parts):
            gr[:, g] = part
        du += du_g
    rows = u.shape[0]
    du = du.reshape(bh // rows, rows, n).sum(dim=0)
    return (*(gr.reshape(bh, l, n).to(t.dtype)
              for gr, t in zip(grads, (r, k, v, w))), du.to(u.dtype))
