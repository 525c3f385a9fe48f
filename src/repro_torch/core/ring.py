"""Ring Attention over a logical ring group (paper §2.2, Algorithm 1
RINGATTN) — counterpart of ``src/repro/core/ring.py``.

Per-rank view: the KV shard (possibly a Ulysses-gathered concatenation of
several chunks) rotates around the Ring group in P_r steps while each rank
keeps its local Q and accumulates the online-softmax partial ``(O', l, m)``.
All ranks of the group run in lockstep: step s of every rank is issued
before any rank consumes step s's receive buffer.  Every argument that
differs by rank is a rank list; the loops run over the ranks this process
owns (all of them on a mesh of virtual ranks).

The KV transfer for step s+1 is issued *before* the attention of step s
(double buffering) through a one-sided channel: the put runs on a side
stream, and the wait makes the compute stream wait for it.

Masking is exact under arbitrary chunk layouts: the caller supplies a
*position function* mapping (rank, ring coordinate owning the currently
held KV) to the global positions of its elements, so causal/sliding-window
masks equal the single-device computation wherever a chunk sits.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..comm import Stream, ring_shift
from ..comm.stream import owners_of
from ..comm import trace as _trace
from ..comm.profiler import mark_compute
from ..comm.channel import RankList, dest_table, first
from ..comm.kernel_backend import fused_slots, heap_for
from ..kernels import ops as _ops
from ..kernels.flash_mqkv import flash_mqkv, pad_head_dim
from ..kernels.ring_flash import ring_flash_step
from .collectives import GroupLayout, owned_ranks, rank_map
from .softmax import (MaskSpec, Partial, attend_partial,
                      attend_partial_blockwise, empty_partial, merge)

# (rank p, ring coordinate owning the chunk) -> [Lk] global positions
KPosFn = Callable[[int, int], torch.Tensor]


def ring_attention(
    q: RankList,  # [B, Lq, Hq, D] local query per rank (stays put)
    k: RankList,  # [B, Lk, Hkv, D] local KV shard per rank (rotates)
    v: RankList,
    layout: GroupLayout,
    *,
    q_pos: RankList | None,  # [Lq] global positions of q (None = no masking)
    k_pos_fn: KPosFn | None,
    scale: float | None = None,
    causal: bool = False,
    window: int | None = None,
    accum: list[Partial] | None = None,
    kv_block: int | None = None,
    backend: str = "xla",
    interpret: bool = True,
) -> list[Partial]:
    """Run P_r ring steps; returns each rank's merged partial (not
    finalized).

    ``kv_block`` caps the materialized score matrix per attend (see
    softmax.attend_partial_blockwise).

    ``backend="pallas"`` runs the fused path: each ring step but the last
    is ONE K2 launch per rank that carries the (O', l, m) state *and* puts
    the KV chunk into the next ring rank's receive buffer; the last step is
    K1.  It ignores ``kv_block`` (the kernels block the KV loop
    themselves)."""
    if backend == "pallas":
        return _ring_attention_kernels(
            q, k, v, layout, q_pos=q_pos, k_pos_fn=k_pos_fn, scale=scale,
            causal=causal, window=window, accum=accum, interpret=interpret)

    def _attend(q_, k_, v_, mask):
        if kv_block is not None:
            return attend_partial_blockwise(q_, k_, v_, scale=scale,
                                            mask=mask, kv_block=kv_block)
        return attend_partial(q_, k_, v_, scale=scale, mask=mask)

    p_r = layout.p_ring
    ranks = owned_ranks(q)
    acc = (list(accum) if accum is not None else
           rank_map(lambda x: empty_partial(*x.shape, device=x.device), q))
    masked = causal or window is not None
    my_r = [layout.coords(p)[1] for p in range(len(q))]

    def mask_for(p, owner_r):
        if not masked:
            return None
        return MaskSpec(
            causal=causal,
            window=window,
            q_pos=q_pos[p] if q_pos is not None else None,
            k_pos=k_pos_fn(p, owner_r) if k_pos_fn is not None else None,
        )

    dev = first(q).device
    if p_r == 1:
        # pure-Ulysses plan: no ring rotation, one local attend per rank —
        # still the compute the torus hops are scheduled to hide behind
        with mark_compute("local attend", layout.axes, dev, stream="ring"):
            return [None if q[p] is None else
                    merge(acc[p], _attend(q[p], k[p], v[p],
                                          mask_for(p, my_r[p])))
                    for p in range(len(q))]

    stream = Stream("ring")
    kc, vc = k, v
    for s in range(p_r):
        # issue the next-step transfer first (double buffer), then compute;
        # the last step computes only (2(P-1)/P volume, §2.2)
        nxt = (ring_shift(layout, kc, vc, stream=stream,
                          overlaps="ring attend") if s < p_r - 1 else None)
        with mark_compute("ring attend", layout.axes, dev,
                          stream=stream.name):
            for p in ranks:
                owner = (my_r[p] - s) % p_r  # ring rank whose shard p holds
                acc[p] = merge(acc[p], _attend(q[p], kc[p], vc[p],
                                               mask_for(p, owner)))
        if nxt is not None:
            kc, vc = nxt.wait()
    return acc


# ---------------------------------------------------------------------------
# fused kernel path (the reference's _ring_attention_pallas)
# ---------------------------------------------------------------------------

def _ring_attention_kernels(
    q: RankList,  # [B, Lq, Hq, D]
    k: RankList,  # [B, Lk, Hkv, D]
    v: RankList,
    layout: GroupLayout,
    *,
    q_pos: RankList | None,
    k_pos_fn: KPosFn | None,
    scale: float | None,
    causal: bool,
    window: int | None,
    accum: list[Partial] | None,
    interpret: bool,
) -> list[Partial]:
    """P_r fused ring steps: kernel-carried (O', l, m) + in-kernel puts.

    The KV chunk circulates in *flattened* layout ([B·Hkv, Lk, D], the
    shard's own length: the kernels mask ragged edges themselves), so a K2
    launch writes it straight into the receive buffer of the next ring rank
    at every step.  Each step allocates fresh receive buffers: the chunk a
    rank reads in step s is never the buffer another rank writes in step s.
    """
    p_r = layout.p_ring
    ranks = owned_ranks(q)
    b, lq, hq, d = first(q).shape
    lk, hkv = first(k).shape[1], first(k).shape[2]
    group = hq // hkv
    dev = first(q).device
    my_r = [layout.coords(p)[1] for p in range(len(q))]

    # a head dim the kernels lack (80) circulates zero-padded to the next
    # one (128); the scale stays the true head dim's
    if scale is None:
        scale = d ** -0.5

    def flat(x):
        return pad_head_dim(_ops.flatten_heads(x))

    qf = rank_map(flat, q)
    qpp = [None if q[p] is None else
           (q_pos[p] if q_pos is not None
            else torch.arange(lq, device=dev)).to(torch.int32).contiguous()
           for p in range(len(q))]
    kc = rank_map(flat, k)
    vc = rank_map(flat, v)

    def kpos_for(p, owner):
        return (k_pos_fn(p, owner) if k_pos_fn is not None
                else torch.arange(lk, device=dev)).to(torch.int32).contiguous()

    stream = Stream("ring", backend="pallas", interpret=interpret)
    heap = heap_for(dev)
    state = [None] * len(q)
    fut = None
    for s in range(p_r):
        if fut is not None:
            kc, vc = fut.wait()
        kw = dict(group=group, scale=scale, causal=causal, window=window,
                  finalize=False)
        if s < p_r - 1:
            # fused step: every rank's K2 computes on the chunk it holds
            # and writes it into the receive buffers of its ring successor
            ch = stream.channel(layout.axes, layout.ring_perm(1),
                                f"shift1.s{s}", owners_of(layout))
            stream.next_stage()
            dst = dest_table(ch.perm, len(q))
            epoch = heap.next_epoch()
            slots = fused_slots(kc, vc, dst, epoch, owners_of(layout))

            def launch():  # called right away, by put_fused
                for p in ranks:
                    flag, arrive = slots.flag(p)
                    owner = (my_r[p] - s) % p_r
                    state[p], _ = ring_flash_step(
                        qf[p], kc[p], vc[p], qpp[p], kpos_for(p, owner),
                        k_dst=slots.k[dst[p]], v_dst=slots.v[dst[p]],
                        flag=flag, arrive=arrive, epoch=epoch,
                        state=state[p], **kw)

            with mark_compute("ring attend", layout.axes, dev,
                              stream=stream.name):
                fut = ch.put_fused(*slots.payload, launch=launch,
                                   overlaps="ring attend", words=slots.words,
                                   epoch=epoch)
            _trace.mark_compute("ring attend", stream=stream.name)
        else:
            # last step: compute only (2(P-1)/P volume, §2.2)
            with mark_compute("ring attend", layout.axes, dev,
                              stream=stream.name):
                for p in ranks:
                    owner = (my_r[p] - s) % p_r
                    state[p] = flash_mqkv(qf[p], kc[p], vc[p], qpp[p],
                                          kpos_for(p, owner),
                                          state=state[p], **kw)

    out = [None] * len(q)
    for p in ranks:
        o, l, m = state[p]
        part = Partial(o=o[..., :d].reshape(b, hq, lq, d).transpose(1, 2),
                       l=l.reshape(b, hq, lq), m=m.reshape(b, hq, lq))
        out[p] = part if accum is None else merge(accum[p], part)
    return out
