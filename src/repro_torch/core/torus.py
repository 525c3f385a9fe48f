"""Torus Attention (paper §4.3, Algorithm 1): chunked, overlappable
all-to-all fused with attention compute — counterpart of
``src/repro/core/torus.py``.

The monolithic Ulysses all-to-all is decomposed into P_u - 1 point-to-point
stages.  The diagonal chunk (head-slice u of rank u's own shard) is
*stationary* — §4.3's key observation — so compute starts immediately, and
each stage-k transfer (a distance-k hop on the torus) is interleaved with
attention on already-resident chunks:

    stage 0        : RingAttn(Q_{t,t}, K_{t,t}, V_{t,t})          (no comm)
    Pull-Q  k=1..N-1: recv Q chunk from u-k; RingAttn(vs local diag KV)
    Pull-KV k=1..N-1: recv KV chunk from u-k; RingAttn(all Q vs recv'd KV)
    Push-O         : inverse staged all-to-all of O (diagonal stays put)

Q is scheduled before KV as in the paper ("KV doubles the volume and is
harder to hide"), and every hop is issued one stage before its chunk is
consumed, so it runs on the side stream beside the previous stage's
attention.  Every per-stage compute is a full RINGATTN over the
intra-machine Ring group, as in Algorithm 1.  All ranks run in lockstep
(every argument that differs by rank is a rank list); the Push-O stages
are as in the reference (DESIGN.md §2: the diagonal Q's non-local-KV
compute is folded into the Pull-KV stages).  On a process mesh the loops
run over the ranks this process owns.
"""
from __future__ import annotations

import torch

from ..comm import Stream, torus_hop
from ..comm.channel import RankList, first
from .collectives import GroupLayout, owned_ranks, rank_map
from .ring import ring_attention
from .softmax import Partial, empty_partial, finalize, merge
from .ulysses import group_positions, scatter_o

HEAD_AXIS = 2


def _rank_of(layout: GroupLayout, u: int, r: int) -> int:
    if layout.ulysses_outer:
        return u * layout.p_ring + r
    return r * layout.p_ulysses + u


def _merge_slice(acc: Partial, upd: Partial, start: int, ls: int) -> Partial:
    """Merge ``upd`` (covering q slice [start, start+ls)) into ``acc``, in
    place: the accumulator belongs to one torus_attention call."""
    cur = Partial(o=acc.o[:, start:start + ls], l=acc.l[:, :, start:start + ls],
                  m=acc.m[:, :, start:start + ls])
    new = merge(cur, upd)
    acc.o[:, start:start + ls] = new.o
    acc.l[:, :, start:start + ls] = new.l
    acc.m[:, :, start:start + ls] = new.m
    return acc


def torus_attention(
    q: RankList,  # [B, Ls, Hq, D] natural (seq-sharded) layout, per rank
    k: RankList,  # [B, Ls, Hkv, D]
    v: RankList,
    layout: GroupLayout,
    *,
    scale: float | None = None,
    causal: bool = False,
    window: int | None = None,
    fused_pull_q: bool = False,
    kv_block: int | None = None,
    backend: str = "xla",
    interpret: bool = True,
    wire_dtype: str | None = None,
    return_stats: bool = False,
) -> RankList | tuple[RankList, list[tuple[torch.Tensor, torch.Tensor]]]:
    """Full SwiftFusion attention with the Torus schedule; returns O in the
    original [B, Ls, Hq, D] sharding, per rank.  With ``return_stats``
    also each rank's final row statistics (m, l), [B, Hq / P_u, P_u * Ls]
    in the gathered, head-sharded layout (the sequence in source-u order):
    what the backward (core/sp_grad.py) needs.

    ``wire_dtype`` compresses the inter-machine leg of the Push-O when the
    layout is hierarchical (``layout.u_groups > 1``); the Pull legs stay
    exact (Q and KV feed compute directly).

    Every Pull hop is issued one stage ahead (double buffering, as in
    ring.py): hop j+1 goes onto the side stream before the ring attention
    of stage j is enqueued, so it runs beside that attention.  (The side
    stream waits for what the compute stream issued before the put, so
    that the receive buffers, allocated on the compute stream, are free.)

    ``backend="pallas"`` lowers every transfer through the put kernels
    (comm/kernel_backend.py) and runs each per-stage RINGATTN through the
    fused K2/K1 path.

    ``fused_pull_q`` is the reference's beyond-paper option: keep the
    staged (distance-k) Q hops but run ONE ring circulation of the diagonal
    KV over the assembled gathered Q instead of one per Pull-Q stage."""
    p_u, p_r = layout.p_ulysses, layout.p_ring
    ranks = owned_ranks(q)
    b, ls, hq, d = first(q).shape
    lk = first(k).shape[1]  # the K/V shard's own length (cross-attention)
    h = hq // p_u
    dev = first(q).device
    coords = [layout.coords(p) for p in range(len(q))]
    ar = torch.arange(ls, device=dev)
    ark = torch.arange(lk, device=dev)
    ring_kw = dict(scale=scale, causal=causal, window=window,
                   kv_block=kv_block, backend=backend, interpret=interpret)

    def chunks(x):  # chunk j -> peer j
        return torch.chunk(x, p_u, dim=HEAD_AXIS)

    def mine(xs, idx):  # [xs[p][idx[p]]] over the held ranks
        return [None if x is None else x[i] for x, i in zip(xs, idx)]

    qc, kc, vc = rank_map(chunks, q), rank_map(chunks, k), rank_map(chunks, v)
    us = [u for u, _ in coords]
    k_diag, v_diag = mine(kc, us), mine(vc, us)

    def chunk_pos(p: int, src_u: int) -> torch.Tensor:
        return _rank_of(layout, src_u, coords[p][1]) * ls + ar

    def diag_kpos_fn(p: int, owner_r: int) -> torch.Tensor:
        # position of rank p's diagonal KV chunk as it circulates the ring
        return _rank_of(layout, coords[p][0], owner_r) * lk + ark

    def send(chunks, kstage):
        return mine(chunks, [(u + kstage) % p_u for u in us])

    stream = Stream("torus", backend=backend, interpret=interpret)

    def pull_hops():
        """Issue the Pull hops in program order, one per ``next``."""
        for kstage in range(1, p_u):
            yield torus_hop(layout, kstage, send(qc, kstage), stream=stream,
                            overlaps="diag-KV attend")
        for kstage in range(1, p_u):
            yield torus_hop(layout, kstage, send(kc, kstage), send(vc, kstage),
                            stream=stream, overlaps="gathered-Q attend")

    hops = pull_hops()

    # gathered-q accumulator per rank, source-u order
    acc = [None] * len(q)
    for p in ranks:
        acc[p] = empty_partial(b, p_u * ls, h, d, device=dev)
    fut = next(hops, None)

    def positions(fn):  # fn(p) over the held ranks
        return [None if x is None else fn(p) for p, x in enumerate(q)]

    if not fused_pull_q:
        # ---- stage 0: stationary diagonal chunks, compute starts, no comm
        parts = ring_attention(
            mine(qc, us), k_diag, v_diag,
            layout, q_pos=positions(lambda p: chunk_pos(p, us[p])),
            k_pos_fn=diag_kpos_fn, **ring_kw)
        for p in ranks:
            _merge_slice(acc[p], parts[p], us[p] * ls, ls)

    # ---- Pull-Q stages: Q chunks arrive one hop-distance k at a time
    # q_recv[p][j]: Q chunk from peer j
    q_recv = [[None] * p_u for _ in range(len(q))]
    for kstage in range(1, p_u):
        recv = fut.wait()
        fut = next(hops, None)
        srcs = [(u - kstage) % p_u for u in us]
        if not fused_pull_q:
            parts = ring_attention(
                recv, k_diag, v_diag, layout,
                q_pos=positions(lambda p: chunk_pos(p, srcs[p])),
                k_pos_fn=diag_kpos_fn, **ring_kw)
            for p in ranks:
                _merge_slice(acc[p], parts[p], srcs[p] * ls, ls)
        for p in ranks:
            q_recv[p][srcs[p]] = recv[p]

    # assemble the gathered Q (source-u order) for the Pull-KV stages
    for p in ranks:
        q_recv[p][us[p]] = qc[p][us[p]]
    q_gather = [None if x is None else torch.cat(q_recv[p], dim=1)
                for p, x in enumerate(q)]
    q_pos_all = positions(
        lambda p: group_positions(layout, ls, coords[p][1], dev))

    if fused_pull_q:
        # single ring circulation of the diagonal KV over ALL gathered Q
        parts = ring_attention(q_gather, k_diag, v_diag, layout,
                               q_pos=q_pos_all, k_pos_fn=diag_kpos_fn,
                               **ring_kw)
        acc = rank_map(merge, acc, parts)

    # ---- Pull-KV stages: KV chunks arrive; all Q attends each new chunk
    for kstage in range(1, p_u):
        k_recv, v_recv = fut.wait()
        fut = next(hops, None)
        srcs = [(u - kstage) % p_u for u in us]

        def kpos_fn(p: int, owner_r: int, srcs=srcs) -> torch.Tensor:
            return _rank_of(layout, srcs[p], owner_r) * lk + ark

        parts = ring_attention(q_gather, k_recv, v_recv, layout,
                               q_pos=q_pos_all, k_pos_fn=kpos_fn, **ring_kw)
        acc = rank_map(merge, acc, parts)

    # ---- Push-O: staged inverse all-to-all; diagonal O never moves
    dtype = first(q).dtype
    o = rank_map(lambda a: finalize(a, dtype=dtype), acc)  # [B, P_u*Ls, h, D]
    out = scatter_o(o, layout, backend=backend, interpret=interpret,
                    wire_dtype=wire_dtype)
    if return_stats:
        return out, rank_map(lambda a: (a.m, a.l), acc)
    return out
