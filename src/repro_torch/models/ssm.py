"""Linear-recurrence (SSM) substrate of the port, the counterpart of the
reference's ``models/ssm.py``: the RWKV6 and SSD chunked scans and decode
steps, and the distributed prefix scan over SP ranks.

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
cross-rank pass is exact.  Its shifts are puts with a gradient
(comm/grad.py): in training the backward puts each received summary's
cotangent back to its sender, as JAX transposes the reference's
``lax.ppermute``.

Two chunk scans, as in the reference:
  * rwkv6 (Finch): per-channel decay, state [N_k, N_v] per head (its
    outputs come from the WKV kernel K5 in the model; ``rwkv6_chunk_scan``
    is the reference's plain form);
  * ssd (mamba2-style scalar decay per head), the hymba branch, in float32
    and plain torch, as the reference computes it (no Pallas kernel).

Batch axes of the mesh split the batch into slices that each run the
scan over their own SP ranks: the rank lists then hold every rank of the
batch and SP axes, slice-major (``collectives.SlicedLayout``), and one
put moves the summaries of every slice.  On a process mesh the lists hold
this process's entries (None for the others) and the layout carries their
owner map (``owners``): each shift is a put into the peers' slabs, and a
scan is one step of the heap's fence.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..comm import ring_shift
from ..comm.channel import RankList, first, owned_ranks, rank_map
from ..comm.kernel_backend import process_step
from ..core.collectives import GroupLayout, SlicedLayout
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
# SSD chunk scan (mamba2-style scalar-per-head decay) for hymba
# ---------------------------------------------------------------------------

def ssd_chunk_scan(
    x: torch.Tensor,  # [B, L, H, P] (P = channels per head)
    dt: torch.Tensor,  # [B, L, H] positive step sizes
    bm: torch.Tensor,  # [B, L, H, N] input projection
    cm: torch.Tensor,  # [B, L, H, N] output projection
    a: torch.Tensor,  # [H] negative per-head decay rate
    chunk: int = 64,
) -> ScanResult:
    """The SSD recurrence S_t = exp(dt_t a) S_{t-1} + (dt_t x_t) ⊗ B_t,
    o_t = S_t C_t, in the reference's chunk form, in float32."""
    b, l, h, p_ = x.shape
    n = bm.shape[-1]
    c = min(chunk, l)
    if l % c:
        raise ValueError(f"sequence length {l} is not a multiple of the "
                         f"SSD chunk {c}")
    nc = l // c
    dtf, af = dt.float(), a.float()
    loggam = dtf.reshape(b, nc, c, h) * af  # log decay per token, <= 0
    t_ = torch.cumsum(loggam, dim=2)  # within-chunk cumulative
    xs_ = (x.float() * dtf[..., None]).reshape(b, nc, c, h, p_)
    bc = bm.float().reshape(b, nc, c, h, n)
    cc = cm.float().reshape(b, nc, c, h, n)

    # intra-chunk: L[t,s] = exp(T_t - T_s), s <= t.  Above the diagonal
    # the exponent is positive and overflows to inf once a chunk's summed
    # log-decay passes ~88: it is masked to -inf before the exp, so the
    # gradient there is 0, not 0 * inf = NaN as the reference's `where`
    # after the exp gives (ROADMAP F6: repaired here, not mirrored)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    seg = (t_[:, :, :, None] - t_[:, :, None, :]).masked_fill(
        ~tri[:, :, None], float("-inf"))
    lmat = torch.exp(seg).permute(0, 1, 4, 2, 3)
    cb = torch.einsum("bgthn,bgshn->bghts", cc, bc)
    out = torch.einsum("bghts,bgshp->bgthp", cb * lmat, xs_)

    # cross-chunk state carry: S [b, h, p, n]
    gam_c = torch.exp(t_[:, :, -1])  # [b, nc, h]
    # chunk state contribution: sum_s exp(T_c - T_s) ⊙ (xs_s ⊗ B_s)
    tail = torch.exp(t_[:, :, -1][:, :, None] - t_)  # [b, nc, c, h]
    b_chunk = torch.einsum("bgshp,bgshn->bghpn", tail[..., None] * xs_, bc)
    c_infl = torch.exp(t_)  # decay from chunk start to t (inclusive)
    s = torch.zeros((b, h, p_, n), dtype=torch.float32, device=x.device)
    o_corr = []
    for g in range(nc):
        o_corr.append(torch.einsum("bthn,bhpn->bthp",
                                   c_infl[:, g, ..., None] * cc[:, g], s))
        s = gam_c[:, g, :, None, None] * s + b_chunk[:, g]
    out = out + torch.stack(o_corr, dim=1)

    a_dev = torch.exp(loggam.sum(dim=(1, 2)))  # [b, h]
    # influence: Γ_t (from the shard's start) ⊙ C_t · S_in
    full_t = torch.cumsum(dtf * af, dim=1)
    infl = torch.exp(full_t)[..., None] * cm.float()  # [b, l, h, n]
    return ScanResult(out=out.reshape(b, l, h, p_), a_dev=a_dev, s_out=s,
                      infl=infl)


def ssd_apply_influence(out: torch.Tensor, infl: torch.Tensor,
                        s_in: torch.Tensor) -> torch.Tensor:
    return out + torch.einsum("blhn,bhpn->blhp", infl, s_in)


def ssd_decode_step(x, dt, bm, cm, a, s):
    """One SSD step: x [B, H, P], dt [B, H], bm / cm [B, H, N], s [B, H,
    P, N] float32 -> (o [B, H, P], s), in float32 (JAX promotes the
    reference's mixed operands the same way)."""
    g = torch.exp(dt.float() * a.float())  # [B, H]
    upd = torch.einsum("bhp,bhn->bhpn", x.float() * dt.float()[..., None],
                       bm.float())
    s = g[..., None, None] * s + upd
    o = torch.einsum("bhpn,bhn->bhp", s, cm.float())
    return o, s


# ---------------------------------------------------------------------------
# distributed exclusive prefix scan over SP ranks (log-depth shifts)
# ---------------------------------------------------------------------------

def _layout(axes: tuple[str, ...], size: int, slices: int, owners=None):
    layout = GroupLayout(tuple(axes), 1, size, ulysses_outer=True)
    if owners is not None or slices > 1:
        return SlicedLayout(layout, slices, owners=owners)
    return layout


def shift_ranks(xs: tuple[RankList, ...], axes: tuple[str, ...], size: int,
                d: int, slices: int = 1, owners=None) -> tuple[RankList, ...]:
    """Rank p of every batch slice receives rank p - d's tensors (of its
    slice), for every rank list in ``xs``; ranks below d receive None.  One
    put of a distance-d rotation over the flat SP rank (``ring_shift`` on a
    1 x size ring, tiled over the slices), whose wrapped-around deliveries
    are dropped: a shift without wraparound.  On a process mesh the lists
    hold this process's entries (None elsewhere) and ``owners`` is their
    owner map (``mesh.owner_map(batch axes + SP axes)``)."""
    recv = ring_shift(_layout(axes, size, slices, owners), *xs,
                      shift=d).wait()
    recv = (recv,) if len(xs) == 1 else recv
    return tuple([None if p % size < d else t for p, t in enumerate(r)]
                 for r in recv)


def _bc(a: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``a`` with trailing unit dims up to ``like``'s rank (the reference's
    ``bc``): rwkv6's decay [b, h, n] against its state [b, h, n, n], the
    SSD's [b, h] against [b, h, p, n]."""
    return a.reshape(a.shape + (1,) * (like.dim() - a.dim()))


def _exclusive_scan(a_dev: RankList, b_dev: RankList, axes, size: int,
                    slices: int = 1, owners=None) -> RankList:
    """Exclusive prefix 'composition' scan of per-rank (A, B) recurrence
    summaries across the flattened SP axes, in each batch slice.  Identity
    = (1, 0).

    Hillis-Steele inclusive scan (log₂ size rounds of shifts by d), then a
    shift by one rank; ranks below d keep their value in a round, as they
    compose with the identity.  Entries another process holds (None) stay
    None."""
    a = rank_map(torch.Tensor.float, a_dev)
    b = rank_map(torch.Tensor.float, b_dev)
    held = owned_ranks(a)

    def step(x, keep, new):
        out = [None] * len(x)
        for p in held:
            out[p] = x[p] if p % size < keep else new(p)
        return out

    d = 1
    while d < size:
        a_r, b_r = shift_ranks((a, b), axes, size, d, slices, owners)
        a, b = (step(a, d, lambda p: a[p] * a_r[p]),
                step(b, d, lambda p: _bc(a[p], b[p]) * b_r[p] + b[p]))
        d *= 2
    # shift inclusive -> exclusive: take b of rank - 1; rank 0 = identity
    (b_prev,) = shift_ranks((b,), axes, size, 1, slices, owners)
    return [None if b[p] is None else
            torch.zeros_like(b[p]) if b_prev[p] is None else b_prev[p]
            for p in range(len(b))]


def distributed_state_in(a_dev: RankList, s_out: RankList, axes,
                         size: int, slices: int = 1,
                         owners=None) -> RankList:
    """S_in for each SP rank (of each batch slice) given per-rank (total
    decay, zero-init state).  On a process mesh (``owners``: the lists'
    owner map) the scan's puts are one step of the heap's fence."""
    if size == 1:
        return rank_map(torch.zeros_like, s_out)
    with process_step(first(s_out).device):
        return _exclusive_scan(a_dev, s_out, axes, size, slices, owners)
