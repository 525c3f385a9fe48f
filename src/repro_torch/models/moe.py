"""Mixture-of-Experts layer with expert-parallel dispatch (counterpart of
``src/repro/models/moe.py``).

Experts are split over the 'model' mesh axis (expert parallelism, EP):
EP rank m holds experts [m · E_pad/ep, (m + 1) · E_pad/ep) of the
parameters' ``E_pad = padded_n_experts(cfg, ep)`` (pad experts are never
routed to).  On a mesh of virtual ranks (launch/mesh.py) a rank's experts
are views of the one weight tensor; experts on other cards, and their
exchange between processes, wait for the multi-card transport (ROADMAP
Queue 1 item 8).

Prefill (tokens sharded over the batch and SP axes): each rank routes its
tokens (softmax top-k), sorts them into per-peer send buffers under a
capacity, and exchanges them with their experts' owners through the
all-to-all over 'model' — the Ulysses all-to-all of
``core.collectives.monolithic_all_to_all`` with the 'model' axis as the
group (the mesh's last axis, so a group is consecutive ranks), so with
``comm_backend="pallas"`` each of its stages is one launch of the put
kernel K3 (``kernel_interpret=False``: the route has one axis) or K4.  The owner runs its experts
over capacity-bounded buffers and the outputs travel back by the same
exchange.  The reference's three ``lax.all_to_all`` are three exchanges
here (tokens, expert ids, outputs).  In training the exchange has a
gradient, as the reference's all-to-all has its transpose: each put of
the tokens and of the outputs runs under ``comm/grad.py:Put``, whose
backward puts the cotangents back along the inverse route through the
same kernel (K3 or K4), so each token's gradient returns to its rank.

Decode (tokens replicated over 'model'): each EP rank computes its
experts' contribution to every token and the contributions are summed
over the ranks in rank order (the reference's ``psum``).  With
``ctx.ep_token_gather`` and expert hidden dims split over a data axis
(``sharding.rules_for(cfg, "serve")``, arctic), each (EP rank, hidden
slice) computes a partial on the gathered tokens instead, and the
partials are summed over both.

JAX's out-of-range scatters (``mode="drop"``) and gathers (``mode="fill"``)
have no counterpart in ``index_put_`` (an out-of-range index is a device
assert on CUDA): a dropped entry writes to one spare row past the buffer,
which is cut off, and a filled one reads a clamped row and is masked to
zero.  ``y.at[src].add`` over the k slots of a token is a sum over k in
slot order, not atomics, so a captured step is bitwise its eager twin.
Every buffer size is a Python int of the config and the shapes: nothing
reads a device value, so a decode tick can be captured.  The expert
products are ``torch.bmm`` (the reference computes them outside any
Pallas kernel).
"""
from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F

from .blocks import ParallelContext, ParamBuilder, Params, gelu
from .sharding import rules_for
from ..core.collectives import (GroupLayout, SlicedLayout,
                                monolithic_all_to_all)

EP_AXIS = "model"


def init_moe(b: ParamBuilder, cfg, prefix: str = "moe",
             n_pad_experts: int = 0) -> None:
    m = cfg.moe
    d, ff = cfg.d_model, m.moe_d_ff
    e = m.n_experts + n_pad_experts
    b.add(f"{prefix}/router/w", (d, m.n_experts))
    b.add(f"{prefix}/wi_gate", (e, d, ff))
    b.add(f"{prefix}/wi_up", (e, d, ff))
    b.add(f"{prefix}/wo", (e, ff, d),
          scale=ff ** -0.5 / (2 * cfg.n_layers) ** 0.5)


def padded_n_experts(cfg, ep_degree: int) -> int:
    """Experts padded up so the expert dim divides the EP axis (e.g. qwen2's
    60 experts on a 16-way axis -> 64, last 4 never routed to)."""
    e = cfg.moe.n_experts
    return int(math.ceil(e / ep_degree) * ep_degree)


def ep_degree(mesh) -> int:
    """Size of the EP axis ('model') of ``mesh``; 1 without one."""
    if mesh is None or EP_AXIS not in mesh.axis_names:
        return 1
    return mesh.shape[EP_AXIS]


def _positions_within_group(ids: torch.Tensor, n_groups: int) -> torch.Tensor:
    """Stable rank of each element within its id-group (sort-based)."""
    t = ids.shape[0]
    sorted_ids, perm = torch.sort(ids.long(), stable=True)
    groups = torch.arange(n_groups, device=ids.device)
    starts = torch.searchsorted(sorted_ids, groups, right=False)
    pos_sorted = torch.arange(t, device=ids.device) - starts[sorted_ids]
    return torch.empty_like(pos_sorted).scatter_(0, perm, pos_sorted)


def _expert_ffn(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wo: torch.Tensor, act: str) -> torch.Tensor:
    """Batched expert FFN: x [E, C, d] with per-expert weights [E, d, ff]."""
    if act in ("swiglu", "geglu"):
        gate = torch.bmm(x, wg.to(x.dtype))
        gate = F.silu(gate) if act == "swiglu" else gelu(gate)
        h = gate * torch.bmm(x, wu.to(x.dtype))
    else:
        h = gelu(torch.bmm(x, wu.to(x.dtype)))
    return torch.bmm(h, wo.to(x.dtype))


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest values per row, ties to the lower
    index (a stable descending sort keeps equal values in index order)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _aux(probs: torch.Tensor, ids: torch.Tensor, n_real: int) -> torch.Tensor:
    """GShard load-balance loss E · Σ_e f_e · p_e of one rank's tokens."""
    experts = torch.arange(n_real, device=ids.device)
    f = (ids[..., None] == experts).float().sum(dim=1).mean(dim=0)
    p = probs.mean(dim=0)
    return n_real * torch.sum(f * p)


def _router(x2d: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """Returns (probs [T, E], topk ids [T, k], normalised weights [T, k])."""
    logits = torch.matmul(x2d.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    w, ids = _top_k(probs, top_k)
    w = w / w.sum(dim=-1, keepdim=True)
    return probs, ids, w.to(x2d.dtype)


def _route(x2d: torch.Tensor, router_w: torch.Tensor, top_k: int,
           n_real: int):
    """Returns (topk ids [T,k], weights [T,k], aux load-balance loss)."""
    probs, ids, w = _router(x2d, router_w, top_k)
    return ids, w, _aux(probs, ids, n_real)


def _scatter_rows(rows: torch.Tensor, n: int, src: torch.Tensor,
                  fill) -> torch.Tensor:
    """A buffer of ``n`` rows (``fill`` elsewhere) with ``src[i]`` at row
    ``rows[i]``; ``rows[i] == n`` drops entry i (the spare row past the
    buffer)."""
    buf = torch.full((n + 1,) + tuple(src.shape[1:]), fill, dtype=src.dtype,
                     device=src.device)
    return buf.index_copy_(0, rows, src)[:n]


def _gather_rows(buf: torch.Tensor, rows: torch.Tensor,
                 keep: torch.Tensor) -> torch.Tensor:
    """``buf[rows]`` where ``keep``, zero elsewhere (a filled gather)."""
    got = buf[rows.clamp(max=buf.shape[0] - 1)]
    return torch.where(keep[:, None], got, torch.zeros((), dtype=got.dtype,
                                                       device=got.device))


def _combine(gathered: torch.Tensor, w: torch.Tensor, t: int,
             k: int) -> torch.Tensor:
    """Σ over a token's k slots of gathered · w, in slot order."""
    z = (gathered * w.reshape(-1)[:, None]).reshape(t, k, -1)
    y = z[:, 0]
    for j in range(1, k):
        y = y + z[:, j]
    return y


def _local_experts(x: torch.Tensor, ids: torch.Tensor, w: torch.Tensor,
                   wg, wu, wo, lo: int, cfg) -> torch.Tensor:
    """The contribution of experts [lo, lo + E_local) to every token of
    x [T, d] (routed to ``ids`` with weights ``w``), with room for every
    slot (no drop): the replicated decode body of one EP rank."""
    t_l, d = x.shape
    k = cfg.moe.top_k
    e_local = wg.shape[0]
    cap = t_l * k  # worst case, tiny in decode
    local = ids.reshape(-1) - lo
    keep = (local >= 0) & (local < e_local)
    group = torch.where(keep, local, torch.full_like(local, e_local))
    pos = _positions_within_group(group, e_local + 1)
    rows = torch.where(keep, group * cap + pos,
                       torch.full_like(pos, e_local * cap))
    xk = x.repeat_interleave(k, dim=0)
    buf = _scatter_rows(rows, e_local * cap, xk, 0.0)
    out = _expert_ffn(buf.view(e_local, cap, d), wg, wu, wo, cfg.act)
    gathered = _gather_rows(out.reshape(e_local * cap, d), rows, keep)
    return _combine(gathered, w, t_l, k)


# ---------------------------------------------------------------------------
# prefill: the expert-parallel all-to-all dispatch
# ---------------------------------------------------------------------------

def _dispatch(x: torch.Tensor, ids: torch.Tensor, cfg, ep: int,
              e_local: int):
    """One rank's send buffers: the tokens routed to each peer's experts,
    up to ``cap_send`` per peer.  Returns (send_x [ep · cap_send, d],
    send_eid [ep · cap_send] (the expert on the peer, -1 = empty), rows,
    in_cap, cap_send)."""
    t_l, d = x.shape
    m = cfg.moe
    flat_ids = ids.reshape(-1)  # [T*k]
    peer = flat_ids // e_local  # owner of each slot's expert
    cap_send = int(math.ceil(t_l * m.top_k / ep * m.capacity_factor))
    pos = _positions_within_group(peer, ep)  # slot within peer buffer
    in_cap = pos < cap_send
    rows = torch.where(in_cap, peer * cap_send + pos,
                       torch.full_like(pos, ep * cap_send))
    send_x = _scatter_rows(rows, ep * cap_send,
                           x.repeat_interleave(m.top_k, dim=0), 0.0)
    send_eid = _scatter_rows(rows, ep * cap_send,
                             (flat_ids % e_local).to(torch.int32), -1)
    return send_x, send_eid, rows, in_cap, cap_send


def _run_experts(rx: torch.Tensor, reid: torch.Tensor, wg, wu, wo, cfg,
                 ep: int, cap_send: int) -> torch.Tensor:
    """The owner's side: received tokens rx [ep · cap_send, d] with their
    local expert ids (-1 = empty) through its experts, up to ``cap_e``
    per expert; the outputs in the received order (0 where dropped)."""
    d = rx.shape[-1]
    e_local = wg.shape[0]
    valid = reid >= 0
    cap_e = int(math.ceil(ep * cap_send / e_local * cfg.moe.capacity_factor))
    eid = torch.where(valid, reid.long(), torch.full_like(reid, e_local,
                                                          dtype=torch.long))
    epos = _positions_within_group(eid, e_local + 1)
    keep = valid & (epos < cap_e)
    rows = torch.where(keep, eid * cap_e + epos,
                       torch.full_like(epos, e_local * cap_e))
    buf = _scatter_rows(rows, e_local * cap_e, rx, 0.0)
    out = _expert_ffn(buf.view(e_local, cap_e, d), wg, wu, wo, cfg.act)
    return _gather_rows(out.reshape(e_local * cap_e, d), rows, keep)


def _rank_shards(x: torch.Tensor, ctx: ParallelContext):
    """Every mesh point's token shard (flat rank major-first over the
    mesh's axes): x split over the batch axes on B and the SP axes on L,
    replicated over the other axes.  Returns (shards, the (slice, SP
    rank) of each point, slices, SP degree)."""
    mesh = ctx.mesh
    if mesh is None:
        return [x], [(0, 0)], 1, 1
    ba = ctx.sp.effective_batch_axes(mesh) or ()
    sp_axes = ctx.sp.sp_axes
    slices, size = mesh.axes_size(ba), mesh.axes_size(sp_axes)
    b_, l_ = x.shape[:2]
    if b_ % slices or l_ % size:
        raise ValueError(f"[{b_}, {l_}] tokens do not split evenly over "
                         f"{slices} batch slices x SP degree {size} (as "
                         "shard_map requires)")
    parts = [torch.chunk(xs, size, dim=1) for xs in torch.chunk(x, slices)]
    where = []
    for point in itertools.product(*(range(n) for n in mesh.axis_sizes)):
        c = dict(zip(mesh.axis_names, point))
        where.append((_flat(c, ba, mesh), _flat(c, sp_axes, mesh)))
    return [parts[s][r] for s, r in where], where, slices, size


def _flat(coords: dict, axes, mesh) -> int:
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + coords[a]
    return i


def _ep_layout(mesh, ep: int):
    """The EP groups as Ulysses groups of P_u = ep over a rank list of every
    mesh point: with 'model' the mesh's last axis, a group is ep
    consecutive ranks, one group per point of the other axes."""
    if mesh.axis_names[-1] != EP_AXIS:
        raise ValueError(f"the EP axis {EP_AXIS!r} must be the mesh's last "
                         f"axis, not one of {mesh.axis_names}")
    group = GroupLayout((EP_AXIS,), ep, 1, ulysses_outer=True)
    slices = mesh.size // ep
    return SlicedLayout(group, slices) if slices > 1 else group


def _moe_prefill(x, p, cfg, ctx: ParallelContext, ep: int, e_local: int):
    m = cfg.moe
    d = x.shape[-1]
    shards, where, slices, size = _rank_shards(x, ctx)
    layout = _ep_layout(ctx.mesh, ep) if ep > 1 else None
    kw = dict(split_axis=0, backend=ctx.sp.comm_backend,
              interpret=ctx.sp.kernel_interpret)

    def exchange(bufs):
        if layout is None:
            return [b.unsqueeze(0) for b in bufs]
        return monolithic_all_to_all(bufs, layout, **kw)

    routed, sends, eids = [], [], []
    for t in shards:
        t2 = t.reshape(-1, d)
        ids, w, aux = _route(t2, p["router"]["w"], m.top_k, m.n_experts)
        send_x, send_eid, rows, in_cap, cap_send = _dispatch(
            t2, ids, cfg, ep, e_local)
        routed.append((t2.shape[0], w, aux, rows, in_cap))
        sends.append(send_x)
        eids.append(send_eid)
    recv_x, recv_eid = exchange(sends), exchange(eids)
    outs = []
    for rank, (rx, reid) in enumerate(zip(recv_x, recv_eid)):
        lo = rank % ep * e_local
        sl = slice(lo, lo + e_local)
        outs.append(_run_experts(rx.reshape(-1, d), reid.reshape(-1),
                                 p["wi_gate"][sl], p["wi_up"][sl],
                                 p["wo"][sl], cfg, ep, cap_send))
    back = exchange(outs)
    ys, auxes = {}, []
    for rank, (t, bk) in enumerate(zip(shards, back)):
        t_l, w, aux, rows, in_cap = routed[rank]
        auxes.append(aux)
        if where[rank] in ys:  # a replica of a shard already placed
            continue
        gathered = _gather_rows(bk.reshape(-1, d), rows, in_cap)
        ys[where[rank]] = _combine(gathered, w, t_l, m.top_k).reshape(t.shape)
    y = torch.cat([torch.cat([ys[s, r] for r in range(size)], dim=1)
                   for s in range(slices)], dim=0)
    # the reference's pmean over the EP axis, then over the others: every
    # mesh point weighs the same
    return y, torch.stack(auxes).mean()


# ---------------------------------------------------------------------------
# decode: replicated tokens
# ---------------------------------------------------------------------------

def _moe_decode(x, p, cfg, ctx: ParallelContext, ep: int, e_local: int):
    """Every EP rank's experts on every token, summed over the ranks in
    rank order.  A token's result does not depend on which batch slice
    routes it, so all tokens go through each rank at once; the aux loss
    is the reference's: one per batch slice, averaged."""
    m = cfg.moe
    d = x.shape[-1]
    x2d = x.reshape(-1, d)
    probs, ids, w = _router(x2d, p["router"]["w"], m.top_k)
    y = None
    for rank in range(ep):
        sl = slice(rank * e_local, (rank + 1) * e_local)
        part = _local_experts(x2d, ids, w, p["wi_gate"][sl], p["wi_up"][sl],
                              p["wo"][sl], rank * e_local, cfg)
        y = part if y is None else y + part
    mesh = ctx.mesh
    slices = (mesh.axes_size(ctx.sp.effective_batch_axes(mesh) or ())
              if mesh is not None else 1)
    aux = torch.stack([_aux(pr, i, m.n_experts) for pr, i in zip(
        torch.chunk(probs, slices), torch.chunk(ids, slices))]).mean()
    return y.reshape(x.shape), aux


def _token_gather_decode(x, p, cfg, ctx: ParallelContext, ep: int,
                         e_local: int, ff_axes: tuple[str, ...]):
    """Decode-mode EP with the expert hidden dims split over ``ff_axes``
    (the reference's ``_moe_token_gather_decode``): the tokens are
    gathered (here: all of them), each (EP rank, hidden slice) computes
    its partial output, and the partials are summed over both, EP rank
    major — weights never move."""
    m = cfg.moe
    d = x.shape[-1]
    mesh = ctx.mesh
    n_ff = mesh.axes_size(ff_axes)
    if m.moe_d_ff % n_ff:
        raise ValueError(f"moe_d_ff {m.moe_d_ff} does not split over "
                         f"{ff_axes} ({n_ff})")
    fs = m.moe_d_ff // n_ff
    x_all = x.reshape(-1, d)
    ids, w, aux = _route(x_all, p["router"]["w"], m.top_k, m.n_experts)
    y = None
    for rank in range(ep):
        sl = slice(rank * e_local, (rank + 1) * e_local)
        for f in range(n_ff):
            ff = slice(f * fs, (f + 1) * fs)
            part = _local_experts(
                x_all, ids, w, p["wi_gate"][sl][:, :, ff],
                p["wi_up"][sl][:, :, ff], p["wo"][sl][:, ff],
                rank * e_local, cfg)
            y = part if y is None else y + part
    return y.reshape(x.shape), aux


def moe_block(
    x: torch.Tensor,  # [B, L, d]
    p: Params,  # {'router': {'w'}, 'wi_gate', 'wi_up', 'wo'} (padded E)
    cfg,
    ctx: ParallelContext,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B, L, d], aux loss scalar).  A process mesh is
    refused: its exchange is not a put with owner maps yet."""
    mesh = ctx.mesh
    if mesh is not None and mesh.is_process_mesh:
        raise NotImplementedError(
            "the MoE exchange over a process mesh is a later slice (ROADMAP "
            "Queue 1 item 11)")
    ep = ep_degree(mesh)
    e_pad = p["wi_gate"].shape[0]
    if e_pad % ep:
        raise ValueError(f"{e_pad} experts do not split over the EP axis of "
                         f"size {ep}: initialise with "
                         "padded_n_experts(cfg, ep)")
    e_local = e_pad // ep
    if not ctx.decode:
        return _moe_prefill(x, p, cfg, ctx, ep, e_local)
    # token-gather decode applies when expert hidden dims are FSDP-sharded
    # and there is a data axis to gather tokens over
    ff_axes = ()
    if mesh is not None:
        ff_axes = tuple(a for a in rules_for(cfg, "serve").get(
            "expert_mlp", ()) if a in mesh.axis_names and mesh.shape[a] > 1)
    if ctx.ep_token_gather and ff_axes and ctx.sp.batch_axes is not None:
        return _token_gather_decode(x, p, cfg, ctx, ep, e_local, ff_axes)
    return _moe_decode(x, p, cfg, ctx, ep, e_local)
