"""Linear-recurrence (SSM) substrate of the port: the RWKV6 half of the
reference's ``models/ssm.py`` (chunked scan, decode step, and the
distributed prefix scan over SP ranks).

For a linear recurrence ``S_t = a_t ⊙ S_{t-1} + b_t`` the sequence is
sharded over the SP ranks with a **two-pass distributed prefix scan**
(DESIGN.md §5):

  pass 1 (local)   : chunked scan with S_in = 0 → outputs₀ and the rank's
                     totals (A_dev = ∏ decays, B_dev = final state)
  exchange         : exclusive prefix scan of (A_dev, B_dev) across SP
                     ranks — log₂P Hillis-Steele rounds of shifts by d
                     over the flat SP rank (comm/stream.py:ring_shift on a
                     mesh of virtual ranks)
  pass 2 (local)   : outputs = outputs₀ + influence(S_in)

The composition ((a₂,b₂)∘(a₁,b₁) = (a₂a₁, a₂b₁+b₂)) is associative, so the
cross-rank pass is exact.  The SSD half (the hymba branch) is not ported
yet (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..comm import ring_shift
from ..comm.channel import RankList
from ..core.collectives import GroupLayout
from ..kernels.ref import WKV_EPS as EPS
from ..kernels.ref import wkv_chunk


class ScanResult(NamedTuple):
    out: torch.Tensor  # outputs with S_in = 0
    a_dev: torch.Tensor  # total decay across the local sequence
    s_out: torch.Tensor  # final state with S_in = 0
    infl: torch.Tensor  # per-token influence of S_in on the output


# ---------------------------------------------------------------------------
# RWKV6 chunk scan (per-channel decay, state [Nk, Nv] per head)
# ---------------------------------------------------------------------------

def rwkv6_chunk_scan(
    r: torch.Tensor,  # [B, L, H, N]
    k: torch.Tensor,  # [B, L, H, N]
    v: torch.Tensor,  # [B, L, H, N]
    w: torch.Tensor,  # [B, L, H, N] decay in (0, 1]
    u: torch.Tensor,  # [H, N] bonus for the current token
    chunk: int = 64,
) -> ScanResult:
    b, l, h, n = r.shape
    c = wkv_chunk(l, chunk)
    nc = l // c
    rs = lambda x: x.reshape(b, nc, c, h, n)
    w_ = torch.clamp(rs(w).float(), EPS, 1.0)
    logw = torch.log(w_)
    # D[t] = prod_{s<=t} w_s within chunk (inclusive), in log space
    log_d = torch.cumsum(logw, dim=2)
    d = torch.exp(log_d)  # [b, nc, c, h, n]
    d_m1 = torch.exp(log_d - logw)  # D[t-1] (exclusive)
    a_chunk = d[:, :, -1]  # [b, nc, h, n] total chunk decay

    rf, kf, vf = rs(r).float(), rs(k).float(), rs(v).float()
    # pairwise intra-chunk term: A[t,s] = (r_t ⊙ D_{t-1}) · (k_s / D_s), s < t
    r_sc = rf * d_m1
    k_sc = kf / d
    att = torch.einsum("bgthn,bgshn->bghts", r_sc, k_sc)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                     diagonal=-1)
    att = torch.where(tri, att, torch.zeros((), device=r.device))
    # bonus diagonal: r_t · (u ⊙ k_t)
    diag = torch.einsum("bgthn,hn,bgthn->bgth", rf, u.float(), kf)
    out = torch.einsum("bghts,bgshn->bgthn", att, vf)
    out = out + diag[..., None] * vf

    # cross-chunk: sequential scan over chunks carrying S [b, h, n, n]
    # state contribution of chunk g: sum_s (a_chunk/D_s ⊙ k_s) ⊗ v_s
    k_tail = a_chunk[:, :, None] * k_sc  # k_s * (a_c / D_s)
    b_chunk = torch.einsum("bgshn,bgshm->bghnm", k_tail, vf)
    s = torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
    o_corr = []
    for g in range(nc):
        o_corr.append(torch.einsum("bthn,bhnm->bthm", r_sc[:, g], s))
        s = a_chunk[:, g, ..., None] * s + b_chunk[:, g]
    out = out + torch.stack(o_corr, dim=1)

    a_dev = torch.exp(logw.sum(dim=(1, 2)))  # [b, h, n]
    # influence of S_in on token t: r_t ⊙ (prefix decay up to t-1)
    lw = logw.reshape(b, l, h, n)
    prefix = torch.exp(torch.cumsum(lw, dim=1) - lw)
    infl = r.float() * prefix  # [b, l, h, n]
    return ScanResult(out=out.reshape(b, l, h, n), a_dev=a_dev, s_out=s,
                      infl=infl)


def rwkv6_shard_summary(
    r: torch.Tensor,  # [B, L, H, N]
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,  # decay in (0, 1]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fields of ``rwkv6_chunk_scan`` besides ``out``, for a rank whose
    outputs come from the WKV kernel (which returns no state):
    ``(a_dev, s_out, infl)``.  The final state is taken directly,
    s_out = Σ_s exp(log D_end − log D_s) k_s ⊗ v_s, whose decay factors
    are ≤ 1, so it cannot overflow."""
    logw = torch.log(torch.clamp(w.float(), EPS, 1.0))
    log_d = torch.cumsum(logw, dim=1)  # [b, l, h, n] inclusive
    a_dev = torch.exp(log_d[:, -1])  # [b, h, n]
    tail = torch.exp(log_d[:, -1:] - log_d)  # decay from s (excl.) to the end
    s_out = torch.einsum("blhn,blhm->bhnm", k.float() * tail, v.float())
    infl = r.float() * torch.exp(log_d - logw)
    return a_dev, s_out, infl


def rwkv6_apply_influence(out: torch.Tensor, infl: torch.Tensor,
                          s_in: torch.Tensor) -> torch.Tensor:
    return out + torch.einsum("blhn,bhnm->blhm", infl, s_in)


def rwkv6_decode_step(r, k, v, w, u, s):  # all [B, H, N]; s [B, H, N, N]
    w = torch.clamp(w.float(), EPS, 1.0)
    rf, kf, vf = (t.float() for t in (r, k, v))
    kv = kf[..., :, None] * vf[..., None, :]  # [B, H, N, N]
    o = torch.einsum("bhn,bhnm->bhm", rf, s + u.float()[..., None] * kv)
    s = w[..., None] * s + kv
    return o, s


# ---------------------------------------------------------------------------
# distributed exclusive prefix scan over SP ranks (log-depth shifts)
# ---------------------------------------------------------------------------

def shift_ranks(xs: tuple[RankList, ...], axes: tuple[str, ...], size: int,
                d: int) -> tuple[RankList, ...]:
    """Rank p receives rank p - d's tensors, for every rank list in ``xs``;
    ranks below d receive None.  One put of a distance-d rotation over the
    flat SP rank (``ring_shift`` on a 1 x size ring), whose wrapped-around
    deliveries are dropped: a shift without wraparound."""
    layout = GroupLayout(tuple(axes), 1, size, ulysses_outer=True)
    recv = ring_shift(layout, *xs, shift=d).wait()
    recv = (recv,) if len(xs) == 1 else recv
    return tuple([None] * d + list(r[d:]) for r in recv)


def _exclusive_scan(a_dev: RankList, b_dev: RankList, axes, size: int
                    ) -> RankList:
    """Exclusive prefix 'composition' scan of per-rank (A, B) recurrence
    summaries across the flattened SP axes.  Identity = (1, 0).

    Hillis-Steele inclusive scan (log₂ size rounds of shifts by d), then a
    shift by one rank; ranks below d keep their value in a round, as they
    compose with the identity."""
    a = [t.float() for t in a_dev]
    b = [t.float() for t in b_dev]
    d = 1
    while d < size:
        a_r, b_r = shift_ranks((a, b), axes, size, d)
        a, b = ([a[p] if p < d else a[p] * a_r[p] for p in range(size)],
                [b[p] if p < d else a[p][..., None] * b_r[p] + b[p]
                 for p in range(size)])
        d *= 2
    # shift inclusive -> exclusive: take b of rank - 1; rank 0 = identity
    (b_prev,) = shift_ranks((b,), axes, size, 1)
    return [torch.zeros_like(b[0])] + b_prev[1:]


def distributed_state_in(a_dev: RankList, s_out: RankList, axes,
                         size: int) -> RankList:
    """S_in for each SP rank given per-rank (total decay, zero-init state)."""
    if size == 1:
        return [torch.zeros_like(s_out[0])]
    return _exclusive_scan(a_dev, s_out, axes, size)
