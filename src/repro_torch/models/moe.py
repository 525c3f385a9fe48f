"""Mixture-of-Experts layer with expert-parallel dispatch (counterpart of
``src/repro/models/moe.py``).

Experts are split over the 'model' mesh axis (expert parallelism, EP):
EP rank m holds experts [m · E_pad/ep, (m + 1) · E_pad/ep) of the
parameters' ``E_pad = padded_n_experts(cfg, ep)`` (pad experts are never
routed to).  On a mesh of virtual ranks (launch/mesh.py) a rank's experts
are views of the one weight tensor.  On a process mesh (launch/procs.py)
each process holds only its EP ranks' experts (``held_experts``, as the
reference's ``P(("model",), ...)`` places them), the exchanges are puts
with owner maps into the peers' slabs, and the aux and the decode sums
gather by puts; experts on other cards wait for the multi-card transport
(ROADMAP Queue 1 item 8).

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
here (tokens, expert ids, outputs); on a process mesh each is one step of
the heap's fence, the rank lists holding the owned mesh points' shards
(None for the others), and the aux of every mesh point is gathered by
puts (one more step) and averaged in point order on every process.  In
training the exchange has a
gradient, as the reference's all-to-all has its transpose: each put of
the tokens and of the outputs runs under ``comm/grad.py:Put``, whose
backward puts the cotangents back along the inverse route through the
same kernel (K3 or K4), so each token's gradient returns to its rank.

Decode (tokens replicated over 'model'): each EP rank computes its
experts' contribution to every token and the contributions are summed
over the ranks in rank order (the reference's ``psum``; on a process mesh
the held ranks' contributions are gathered over 'model' by puts first).
With
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

from .blocks import (ParallelContext, ParamBuilder, Params, gelu,
                     inference_on_processes)
from .sharding import rules_for
from ..comm.kernel_backend import process_step
from ..comm.stream import sp_all_gather
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


def _held_ep_ranks(mesh) -> tuple[int, ...]:
    """The EP ranks whose experts this process holds: its block's 'model'
    coordinates, its entries of a rank list over 'model' (every one on a
    mesh of virtual ranks)."""
    if mesh is None or EP_AXIS not in mesh.axis_names:
        return (0,)
    return mesh.owner_map((EP_AXIS,)).owned


EXPERT_WEIGHTS = ("wi_gate", "wi_up", "wo")


def held_layer(p: Params, cfg, mesh) -> Params:
    """This process's copy of one MoE layer's ``p`` on a process ``mesh``:
    the routed experts cut to its EP ranks' (EP rank m's are [m ·
    e_local, (m + 1) · e_local), e_local = ``padded_n_experts(cfg, ep) /
    ep``), as clones, so that the whole tensors can be freed; the router
    stays whole, as does each expert's hidden dim (the token-gather decode
    reads a slice of it as a view).  On a mesh of virtual ranks, or none,
    ``p`` itself: its ranks' experts are views of the whole."""
    if mesh is None or not mesh.is_process_mesh:
        return p
    ep = ep_degree(mesh)
    e_pad = padded_n_experts(cfg, ep)
    held = _held_ep_ranks(mesh)
    lo, hi = held[0] * e_pad // ep, (held[-1] + 1) * e_pad // ep
    out = dict(p)
    for name in EXPERT_WEIGHTS:
        if p[name].shape[0] < e_pad:
            raise ValueError(
                f"{p[name].shape[0]} experts do not split over the EP axis "
                f"of size {ep}: initialise with padded_n_experts(cfg, ep)")
        out[name] = p[name][lo:hi].clone()
    return out


def held_experts(params: Params, cfg, mesh) -> Params:
    """This process's copy of an LM's ``params`` on a process ``mesh``:
    every MoE layer cut by ``held_layer`` (the shared experts stay whole);
    ``params`` itself elsewhere.  ``init_lm(..., mesh=)`` cuts each layer
    as it is built instead, so that the whole is never held at once."""
    if (cfg.family != "moe" or mesh is None
            or not mesh.is_process_mesh):
        return params
    return dict(params, layers=[
        dict(lp, moe=held_layer(lp["moe"], cfg, mesh))
        for lp in params["layers"]])


def expert_bytes(params: Params) -> int:
    """Bytes of the routed experts ``params`` holds (every MoE layer's)."""
    return sum(lp["moe"][name].numel() * lp["moe"][name].element_size()
               for lp in params["layers"] if "moe" in lp
               for name in EXPERT_WEIGHTS)


def _rank_experts(p: Params, mesh, rank: int, e_local: int):
    """EP rank ``rank``'s (wi_gate, wi_up, wo), views of ``p``'s: on a
    process mesh ``p`` holds its EP ranks' only (``held_layer``)."""
    first = _held_ep_ranks(mesh)[0]
    sl = slice((rank - first) * e_local, (rank - first + 1) * e_local)
    return tuple(p[name][sl] for name in EXPERT_WEIGHTS)


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
    replicated over the other axes.  On a process mesh x is this
    process's part (its batch slice, its run of SP ranks' shards) and the
    list holds its owned points' shards, None for the others.  Returns
    (shards, the (slice, SP rank) of each point, slices, SP degree)."""
    mesh = ctx.mesh
    if mesh is None:
        return [x], [(0, 0)], 1, 1
    ba = ctx.sp.effective_batch_axes(mesh) or ()
    sp_axes = ctx.sp.sp_axes
    slices, size = mesh.axes_size(ba), mesh.axes_size(sp_axes)
    where = []
    for point in itertools.product(*(range(n) for n in mesh.axis_sizes)):
        c = dict(zip(mesh.axis_names, point))
        where.append((_flat(c, ba, mesh), _flat(c, sp_axes, mesh)))
    if mesh.is_process_mesh:
        held = mesh.sp_owned(sp_axes)
        if x.shape[1] % len(held):
            raise ValueError(f"a shard of {x.shape[1]} rows does not split "
                             f"evenly over this process's {len(held)} SP "
                             "ranks")
        parts = torch.chunk(x, len(held), dim=1)
        return [parts[where[i][1] - held.start] if i in mesh.owned else None
                for i in range(mesh.size)], where, slices, size
    b_, l_ = x.shape[:2]
    if b_ % slices or l_ % size:
        raise ValueError(f"[{b_}, {l_}] tokens do not split evenly over "
                         f"{slices} batch slices x SP degree {size} (as "
                         "shard_map requires)")
    parts = [torch.chunk(xs, size, dim=1) for xs in torch.chunk(x, slices)]
    return [parts[s][r] for s, r in where], where, slices, size


def _flat(coords: dict, axes, mesh) -> int:
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + coords[a]
    return i


def _ep_layout(mesh, ep: int):
    """The EP groups as Ulysses groups of P_u = ep over a rank list of every
    mesh point: with 'model' the mesh's last axis, a group is ep
    consecutive ranks, one group per point of the other axes.  On a
    process mesh it carries the list's owner map (entry i is flat rank
    i)."""
    if mesh.axis_names[-1] != EP_AXIS:
        raise ValueError(f"the EP axis {EP_AXIS!r} must be the mesh's last "
                         f"axis, not one of {mesh.axis_names}")
    group = GroupLayout((EP_AXIS,), ep, 1, ulysses_outer=True)
    slices = mesh.size // ep
    if mesh.is_process_mesh:
        return SlicedLayout(group, slices,
                            owners=mesh.owner_map(mesh.axis_names))
    return SlicedLayout(group, slices) if slices > 1 else group


def _gather(xs: list[torch.Tensor], mesh, axes, ctx: ParallelContext
            ) -> list[torch.Tensor]:
    """Each of ``xs`` (this process's entries over ``axes``, stacked on
    dim 0) gathered over ``axes`` by puts (comm/stream.py
    ``sp_all_gather``): the whole list, in entry order.  The caller holds
    the step fence."""
    return sp_all_gather(xs, mesh, tuple(axes), None, dim=0,
                         backend=ctx.sp.comm_backend,
                         interpret=ctx.sp.kernel_interpret)


def _moe_prefill(x, p, cfg, ctx: ParallelContext, ep: int, e_local: int):
    m = cfg.moe
    d = x.shape[-1]
    mesh = ctx.mesh
    procs = mesh is not None and mesh.is_process_mesh
    shards, where, slices, size = _rank_shards(x, ctx)
    layout = _ep_layout(mesh, ep) if ep > 1 else None
    kw = dict(split_axis=0, backend=ctx.sp.comm_backend,
              interpret=ctx.sp.kernel_interpret)

    def exchange(bufs):
        if layout is None:
            return [None if b is None else b.unsqueeze(0) for b in bufs]
        with process_step(x.device):
            return monolithic_all_to_all(bufs, layout, **kw)

    n = len(shards)
    routed, sends, eids = [None] * n, [None] * n, [None] * n
    for rank, t in enumerate(shards):
        if t is None:  # another process's point
            continue
        t2 = t.reshape(-1, d)
        ids, w, aux = _route(t2, p["router"]["w"], m.top_k, m.n_experts)
        sends[rank], eids[rank], rows, in_cap, cap_send = _dispatch(
            t2, ids, cfg, ep, e_local)
        routed[rank] = (t2.shape[0], w, aux, rows, in_cap)
    recv_x = exchange(sends)
    recv_eid = exchange(eids)
    outs = [None] * n
    for rank, (rx, reid) in enumerate(zip(recv_x, recv_eid)):
        if rx is None:
            continue
        outs[rank] = _run_experts(rx.reshape(-1, d), reid.reshape(-1),
                                  *_rank_experts(p, mesh, rank % ep, e_local),
                                  cfg, ep, cap_send)
    back = exchange(outs)
    ys, auxes = {}, []
    for rank, (t, bk) in enumerate(zip(shards, back)):
        if t is None:
            continue
        t_l, w, aux, rows, in_cap = routed[rank]
        auxes.append(aux)
        if where[rank] in ys:  # a replica of a shard already placed
            continue
        gathered = _gather_rows(bk.reshape(-1, d), rows, in_cap)
        ys[where[rank]] = _combine(gathered, w, t_l, m.top_k).reshape(t.shape)
    held_slices = sorted({s for s, _ in ys})
    held_ranks = sorted({r for _, r in ys})
    y = torch.cat([torch.cat([ys[s, r] for r in held_ranks], dim=1)
                   for s in held_slices], dim=0)
    # the reference's pmean over the EP axis, then over the others: every
    # mesh point weighs the same; a process mesh gathers every point's
    auxes = torch.stack(auxes)
    if procs:
        with process_step(x.device):
            (auxes,) = _gather([auxes], mesh, mesh.axis_names, ctx)
    return y, auxes.mean()


# ---------------------------------------------------------------------------
# decode: replicated tokens
# ---------------------------------------------------------------------------

def _sum_in_order(parts) -> torch.Tensor:
    y = parts[0]
    for part in parts[1:]:
        y = y + part
    return y


def _moe_decode(x, p, cfg, ctx: ParallelContext, ep: int, e_local: int):
    """Every EP rank's experts on every token, summed over the ranks in
    rank order.  A token's result does not depend on which batch slice
    routes it, so all tokens go through each rank at once; the aux loss
    is the reference's: one per batch slice, averaged.  On a process mesh
    x is this process's batch slice: its EP ranks' contributions and its
    slice's aux are gathered by puts (over 'model', over the batch axes),
    one step of the fence."""
    m = cfg.moe
    d = x.shape[-1]
    x2d = x.reshape(-1, d)
    probs, ids, w = _router(x2d, p["router"]["w"], m.top_k)
    mesh = ctx.mesh
    held = _held_ep_ranks(mesh)
    parts = [_local_experts(x2d, ids, w,
                            *_rank_experts(p, mesh, rank, e_local),
                            rank * e_local, cfg) for rank in held]
    ba = (ctx.sp.effective_batch_axes(mesh) or ()) if mesh is not None else ()
    slices = mesh.axes_size(ba) if mesh is not None else 1
    if mesh is not None and mesh.is_process_mesh:
        auxes = _aux(probs, ids, m.n_experts)[None]
        with process_step(x.device):
            if len(held) < ep:
                (parts,) = _gather([torch.stack(parts)], mesh, (EP_AXIS,), ctx)
            if slices > 1:
                (auxes,) = _gather([auxes], mesh, ba, ctx)
    else:
        auxes = torch.stack([_aux(pr, i, m.n_experts) for pr, i in zip(
            torch.chunk(probs, slices), torch.chunk(ids, slices))])
    return _sum_in_order(list(parts)).reshape(x.shape), auxes.mean()


def _token_gather_decode(x, p, cfg, ctx: ParallelContext, ep: int,
                         e_local: int, ff_axes: tuple[str, ...]):
    """Decode-mode EP with the expert hidden dims split over ``ff_axes``
    (the reference's ``_moe_token_gather_decode``): the tokens are
    gathered (here: all of them), each (EP rank, hidden slice) computes
    its partial output, and the partials are summed over both, EP rank
    major — weights never move.  On a process mesh x is this process's
    batch slice: the tokens are gathered over the batch axes by puts, the
    process computes its mesh points' partials (the hidden slice a view of
    its held experts), gathers every point's (one more step of the fence)
    and keeps its slice's rows."""
    m = cfg.moe
    d = x.shape[-1]
    mesh = ctx.mesh
    procs = mesh.is_process_mesh
    n_ff = mesh.axes_size(ff_axes)
    if m.moe_d_ff % n_ff:
        raise ValueError(f"moe_d_ff {m.moe_d_ff} does not split over "
                         f"{ff_axes} ({n_ff})")
    fs = m.moe_d_ff // n_ff
    x_all = x.reshape(-1, d)
    ba = tuple(ctx.sp.effective_batch_axes(mesh) or ())
    if procs and mesh.axes_size(ba) > 1:
        with process_step(x.device):
            (x_all,) = _gather([x_all], mesh, ba, ctx)
    ids, w, aux = _route(x_all, p["router"]["w"], m.top_k, m.n_experts)
    # a partial per (EP rank, hidden slice): the entries of a list over
    # those axes, in mesh order
    axes = tuple(a for a in mesh.axis_names if a == EP_AXIS or a in ff_axes)
    owners = mesh.owner_map(axes)
    pairs = []
    for i in range(owners.size):
        c = dict(zip(mesh.axis_names, mesh.coords(owners.rank(i))))
        pairs.append((c[EP_AXIS], _flat(c, ff_axes, mesh)))
    parts = {}
    for i in owners.owned:
        rank, f = pairs[i]
        ff = slice(f * fs, (f + 1) * fs)
        wg, wu, wo = _rank_experts(p, mesh, rank, e_local)
        parts[i] = _local_experts(x_all, ids, w, wg[:, :, ff], wu[:, :, ff],
                                  wo[:, ff], rank * e_local, cfg)
    if len(parts) < owners.size:
        with process_step(x.device):
            (got,) = _gather([torch.stack([parts[i] for i in owners.owned])],
                             mesh, axes, ctx)
        parts = dict(enumerate(got))
    y = _sum_in_order([parts[i] for i in sorted(parts, key=pairs.__getitem__)])
    if procs:
        s, n = mesh.slice_of(ba)
        y = y.narrow(0, s * y.shape[0] // n, y.shape[0] // n)
    return y.reshape(x.shape), aux


def check_held_experts(p: Params, cfg, mesh) -> int:
    """``e_local``, the experts of one EP rank, for a MoE layer's ``p``:
    on a process mesh ``p`` must hold this process's EP ranks' experts and
    no others (``held_layer``), elsewhere a multiple of the EP axis."""
    ep = ep_degree(mesh)
    e_pad = p["wi_gate"].shape[0]
    if mesh is not None and mesh.is_process_mesh:
        e_local = padded_n_experts(cfg, ep) // ep
        held = len(_held_ep_ranks(mesh))
        if e_pad != e_local * held:
            raise ValueError(
                f"{e_pad} experts on a process that holds {held} of {ep} EP "
                f"ranks of {e_local} experts each: cut the params to this "
                "process's with held_experts(params, cfg, mesh), or one "
                "layer's with held_layer")
        return e_local
    if e_pad % ep:
        raise ValueError(f"{e_pad} experts do not split over the EP axis of "
                         f"size {ep}: initialise with "
                         "padded_n_experts(cfg, ep)")
    return e_pad // ep


def moe_block(
    x: torch.Tensor,  # [B, L, d]
    p: Params,  # {'router': {'w'}, 'wi_gate', 'wi_up', 'wo'} (padded E)
    cfg,
    ctx: ParallelContext,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B, L, d], aux loss scalar, the mean over every mesh
    point).  On a process mesh x is this process's part (its batch slice
    and, in prefill, its sequence shard), ``p`` holds its EP ranks'
    experts (``held_layer``) and y is its part; the call must not want
    a gradient there (ROADMAP Queue 1 item 12)."""
    mesh = ctx.mesh
    inference_on_processes(ctx)
    ep = ep_degree(mesh)
    e_local = check_held_experts(p, cfg, mesh)
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
