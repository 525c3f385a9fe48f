"""Ulysses Attention transforms (paper §2.2) over a logical Ulysses group
(counterpart of ``src/repro/core/ulysses.py``).

The forward transform runs the three all-to-alls on Q, K, V: scatter the
head dimension (H -> H/P_u) and gather the sequence dimension
(L/P -> P_u * L/P) within each Ulysses group.  The inverse transform is the
fourth all-to-all restoring O to [B, L/P, H, D].

Gathered chunks are ordered by source ulysses coordinate; because group
members are not adjacent in the global sequence when the group spans the
slow axis, the transforms also return global *position tensors* used for
exact causal/window masking downstream.  Every argument and result is a
rank list (one tensor per rank, flat-rank order).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..comm.channel import RankList, first
from .collectives import (GroupLayout, monolithic_all_to_all, rank_map,
                          ungroup_all_to_all)

HEAD_AXIS = 2  # [B, L, H, D]
SEQ_AXIS = 1


class Gathered(NamedTuple):
    q: RankList  # [B, P_u * Ls, Hq / P_u, D] per rank
    k: RankList  # [B, P_u * Ls, Hkv / P_u, D]
    v: RankList
    q_pos: RankList  # [P_u * Ls] global positions of the gathered sequence


def group_positions(layout: GroupLayout, shard_len: int, ring_r: int,
                    device: torch.device | None = None) -> torch.Tensor:
    """Global positions of the sequence gathered by the Ulysses group whose
    ring coordinate is ``ring_r``, ordered by source u."""
    us = torch.arange(layout.p_ulysses, device=device)
    if layout.ulysses_outer:
        ranks = us * layout.p_ring + ring_r
    else:
        ranks = ring_r * layout.p_ulysses + us
    return (ranks[:, None] * shard_len
            + torch.arange(shard_len, device=device)[None, :]).reshape(-1)


def gather_seq(x: RankList, layout: GroupLayout, *, backend: str = "xla",
               interpret: bool = True,
               wire_dtype: str | None = None) -> RankList:
    """One all-to-all of the forward transform: scatter the heads and
    gather the sequence, [B, Ls, H, D] -> [B, P_u * Ls, H / P_u, D] per
    rank, the sequence in source-u order."""
    stacked = monolithic_all_to_all(x, layout, split_axis=HEAD_AXIS,
                                    backend=backend, interpret=interpret,
                                    wire_dtype=wire_dtype)
    def gathered(s):  # [P_u, B, Ls, h, D]
        p_u, b, ls, h, d = s.shape
        return s.transpose(0, 1).reshape(b, p_u * ls, h, d)

    return rank_map(gathered, stacked)


def gather_qkv(
    q: RankList, k: RankList, v: RankList, layout: GroupLayout,
    *, backend: str = "xla", interpret: bool = True,
    wire_dtype: str | None = None,
) -> Gathered:
    """The first three all-to-alls of Ulysses Attention.  ``wire_dtype``
    compresses the inter-machine leg when the layout is hierarchical
    (``layout.u_groups > 1``); ignored otherwise."""
    shard_len = first(q).shape[SEQ_AXIS]
    kw = dict(backend=backend, interpret=interpret, wire_dtype=wire_dtype)
    dev = first(q).device
    return Gathered(
        q=gather_seq(q, layout, **kw), k=gather_seq(k, layout, **kw),
        v=gather_seq(v, layout, **kw),
        q_pos=[None if x is None else
               group_positions(layout, shard_len, layout.coords(p)[1], dev)
               for p, x in enumerate(q)])


def scatter_o(o: RankList, layout: GroupLayout, *, backend: str = "xla",
              interpret: bool = True,
              wire_dtype: str | None = None) -> RankList:
    """The fourth all-to-all: restore O from [B, P_u*Ls, H/P_u, D] to the
    original [B, Ls, H, D] sequence sharding."""
    p_u = layout.p_ulysses

    def by_source(x):
        b, lg, h, d = x.shape
        return x.reshape(b, p_u, lg // p_u, h, d).transpose(0, 1)

    stacked = rank_map(by_source, o)
    return ungroup_all_to_all(stacked, layout, concat_axis=HEAD_AXIS,
                              backend=backend, interpret=interpret,
                              wire_dtype=wire_dtype)
