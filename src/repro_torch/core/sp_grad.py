"""The gradient of the SP attention schedule over a mesh of virtual ranks.

``sp_attention`` (core/strategy.py) applies ``SPAttention`` when q, k or v
want a gradient and the SP degree is above 1; every strategy it dispatches
(swift_torus with ``torus_fused_pull_q`` on and off, swift, usp, ring,
ulysses) goes through it.  The ``replicate_kv`` repeat and the split into
per-rank shards stay outside the Function, so autograd handles them.

Forward: the schedule as it runs without a gradient (the same kernels and
launches, so the same output bit for bit), which also hands out each
rank's final row statistics (m, l) in the gathered, head-sharded layout.
It saves the sequence-sharded q, k, v, the output o and (m, l); the
gathered copies are not kept, the backward gathers again.

Backward, in the Ulysses + ring (USP) form, every step explicit:

1. dO, o, q, k and v go from the sequence-sharded to the head-sharded
   layout through the all-to-all that gathers Q in the forward
   (``ulysses.gather_seq``; the put kernels K3/K4 when ``comm_backend``
   is "pallas").
2. A ring backward of P_r steps: each KV chunk circulates on
   ``layout.ring_perm(1)`` as in the forward, and beside it a float32
   (dK, dV) accumulator of that chunk (twice the bytes of a bf16 chunk,
   so the sum over P_r shares rounds once).  At every step each rank
   calls K1b (``flash_mqkv_bwd``) on its gathered q, o, dO and (m, l)
   against the chunk it holds, at the positions the forward gave the
   chunk's owner.  With the *global* (m, l) of a row, one call per chunk
   gives that chunk's exact share of dQ and the chunk's dK and dV, since
   P = exp(S·scale − m) / l and Δ = rowsum(dO ∘ o) use only global values.
   dq is summed in float32; dk and dv go into the circulating
   accumulator, which a last put returns to its owner.
3. dQ, dK and dV go back to the sequence-sharded layout through the
   inverse all-to-all (``ulysses.scatter_o``), cast once to the inputs'
   dtypes.

The torus and Ulysses + ring compute the same function, so this is the
torus's gradient exactly, but not its schedule: the backward does not
overlap its all-to-alls with compute in stages as the torus forward does,
and each ring step is one K1b launch plus separate puts.  A staged,
overlapped torus backward and a fused backward ring step (K1b that also
forwards the chunk, the backward counterpart of K2) are later kernel work
(ROADMAP Queue 2 item 8).  The backward's exchanges are exact: an fp8 wire
(``a2a_wire_dtype``) compresses the forward only.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..comm import Stream
from ..comm.channel import RankList
from ..comm.profiler import mark_compute
from ..kernels.flash_mqkv import flash_mqkv_bwd
from ..kernels.ops import flatten_heads
from .collectives import GroupLayout
from .ulysses import gather_seq, group_positions, scatter_o


class SPAttention(torch.autograd.Function):
    """SP attention over virtual ranks with its hand-written backward.

    ``apply(schedule, layout, kw, *q, *k, *v)``: ``q``, ``k`` and ``v`` are
    rank lists of sequence shards [B, Ls, H, D] (the same number each);
    ``schedule(q, k, v, return_stats=True)`` runs the strategy's forward
    on them and returns (the output rank list, [(m, l)] per rank); ``kw``
    holds ``scale``, ``causal``, ``window``, ``backend`` and
    ``interpret``.  Returns the output shard of every rank."""

    @staticmethod
    def forward(ctx, schedule: Callable, layout: GroupLayout, kw: dict,
                *qkv: torch.Tensor):
        n = len(qkv) // 3
        q, k, v = (list(qkv[i * n:(i + 1) * n]) for i in range(3))
        out, stats = schedule(q, k, v, return_stats=True)
        ctx.layout, ctx.kw, ctx.n = layout, kw, n
        ctx.save_for_backward(*qkv, *out, *(m for m, _ in stats),
                              *(l for _, l in stats))
        return tuple(out)

    @staticmethod
    def backward(ctx, *do: torch.Tensor):
        n = ctx.n
        saved = ctx.saved_tensors
        q, k, v, o, m, l = (list(saved[i * n:(i + 1) * n]) for i in range(6))
        dq, dk, dv = sp_attention_bwd(q, k, v, o, list(do), m, l, ctx.layout,
                                      **ctx.kw)
        return (None, None, None, *dq, *dk, *dv)


def sp_attention_bwd(
    q: RankList,  # [B, Ls, Hq, D] per rank, sequence-sharded
    k: RankList,  # [B, Ls, Hkv, D]
    v: RankList,
    o: RankList,  # the forward's output, [B, Ls, Hq, D]
    do: RankList,  # its gradient
    m: RankList,  # [B, Hq / P_u, P_u * Ls] float32, gathered layout
    l: RankList,
    layout: GroupLayout,
    *,
    scale: float | None = None,
    causal: bool = False,
    window: int | None = None,
    backend: str = "xla",
    interpret: bool = True,
) -> tuple[RankList, RankList, RankList]:
    """(dq, dk, dv) of every rank, sequence-sharded as q, k and v, from
    the forward's output and row statistics (see the module docstring)."""
    ls, lk, d = q[0].shape[1], k[0].shape[1], q[0].shape[-1]
    if scale is None:
        scale = d ** -0.5
    dev = q[0].device
    comm = dict(backend=backend, interpret=interpret)
    # 1. the sequence-to-heads all-to-alls, then [B*h, P_u*Ls, D] rows
    qg, kg, vg, og, dog = (gather_seq(x, layout, **comm)
                           for x in (q, k, v, o, do))
    b, lg, h, _ = qg[0].shape
    hkv = kg[0].shape[2]
    qf, kf, vf, of, dof = ([flatten_heads(x) for x in xs]
                           for xs in (qg, kg, vg, og, dog))
    mf = [x.reshape(b * h, lg).contiguous() for x in m]
    lf = [x.reshape(b * h, lg).contiguous() for x in l]
    # each of q and K/V at its own shard length (Lq != Lk: cross-attention)
    pos = [(group_positions(layout, ls, r, dev).to(torch.int32),
            group_positions(layout, lk, r, dev).to(torch.int32))
           for r in range(layout.p_ring)]
    # 2. the ring backward
    dqf, dkf, dvf = _ring_backward(
        qf, kf, vf, of, dof, mf, lf, pos, layout, group=h // hkv,
        scale=scale, causal=causal, window=window, **comm)

    # 3. the heads-to-sequence all-to-alls, in the inputs' dtypes
    def back(xs, heads, dtype):
        return scatter_o([x.to(dtype).reshape(b, heads, -1, d).transpose(1, 2)
                          for x in xs], layout, **comm)

    return (back(dqf, h, q[0].dtype), back(dkf, hkv, k[0].dtype),
            back(dvf, hkv, v[0].dtype))


def _ring_backward(qf, kf, vf, of, dof, m, l, pos, layout, *, group, scale,
                   causal, window, backend, interpret):
    """P_r ring steps of K1b.  Every rank keeps its q, o, dO, (m, l) and a
    float32 dQ; the KV chunk [B*Hkv, Lg, D] circulates as in the forward
    (its hop for step s + 1 issued before step s's K1b calls), and after
    each step the chunk's float32 (dK, dV) accumulator follows it, so that
    after the last step's put every accumulator is back at its owner.
    ``pos[r]`` is the gathered sequence's (q, K/V) positions at ring
    coordinate r: rank p's q rows and the chunk that ring rank r owns."""
    p_r = layout.p_ring
    ranks = range(len(qf))
    my_r = [layout.coords(p)[1] for p in ranks]
    dev = qf[0].device
    f32 = lambda xs: [torch.zeros(x.shape, dtype=torch.float32, device=dev)
                      for x in xs]
    dq, dk, dv = f32(qf), f32(kf), f32(vf)
    stream = Stream("ring.bwd", backend=backend, interpret=interpret)
    kc, vc = kf, vf
    for s in range(p_r):
        nxt = (stream.put(layout.axes, layout.ring_perm(1), kc, vc,
                          label=f"kv{s}", overlaps="ring backward")
               if s < p_r - 1 else None)
        with mark_compute("ring backward", layout.axes, dev,
                          stream=stream.name):
            for p in ranks:
                owner = (my_r[p] - s) % p_r
                gq, gk, gv = flash_mqkv_bwd(
                    qf[p], kc[p], vc[p], of[p], dof[p], m[p], l[p],
                    pos[my_r[p]][0], pos[owner][1], group=group, scale=scale,
                    causal=causal, window=window)
                dq[p] += gq
                dk[p] += gk
                dv[p] += gv
        if p_r > 1:  # the accumulators follow their chunk (home at the end)
            dk, dv = stream.put(layout.axes, layout.ring_perm(1), dk, dv,
                                label=f"dkv{s}").wait()
        if nxt is not None:
            kc, vc = nxt.wait()
    return dq, dk, dv
