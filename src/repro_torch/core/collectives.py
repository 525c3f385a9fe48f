"""Collective toolkit for the SP schedules on a mesh of virtual ranks
(counterpart of ``src/repro/core/collectives.py``).

Every schedule is built from channel puts over a *flattened* SP axis, with
the paper's logical (P_u x P_r) factorisation expressed as plain rank
arithmetic.  This module owns the layout bookkeeping (``GroupLayout``,
copied from the reference; ``tests/test_torch_copies.py`` pins it) and the
all-to-all entry points; the staged transfer programs are
``repro_torch.comm.stream``'s.  All functions take and return rank lists
(one tensor per rank of the group, flat-rank order).

Logical layout (see planner.py):
  flat rank p in [0, P_u * P_r) over the mesh SP axes (major axis first).
  SwiftFusion (ulysses_outer=True):  u = p // P_r,  r = p %  P_r
      -> Ulysses groups span the slow outer (pod) boundary, Ring groups are
        contiguous inside a pod.
  USP       (ulysses_outer=False):   u = p %  P_u,  r = p // P_u
      -> Ring groups span pods, Ulysses groups stay inside a pod.

The reference reads a rank's coordinates from the traced axis index
(``my_coords()``); the port asks for rank p's coordinates with
``coords(p)``.  On a mesh of virtual ranks every rank lives in this
process.  On a process mesh a rank list holds the tensors of the ranks
this process owns and None for the others: the schedules loop over
``owned_ranks`` and map with ``rank_map``, so one schedule serves both;
``SlicedLayout.owners`` says which process holds each entry.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..comm import (hier_all_to_all, hier_ungroup, staged_all_to_all,
                    staged_ungroup)
from ..comm import profiler as _profiler
from ..comm.channel import RankList, owned_ranks, rank_map

__all__ = ["GroupLayout", "SlicedLayout", "grouped_all_to_all",
           "monolithic_all_to_all", "owned_ranks", "rank_map",
           "ungroup_all_to_all"]

AxisNames = tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class GroupLayout:
    """(P_u × P_r) logical factorisation of a flattened SP axis."""

    axes: AxisNames
    p_ulysses: int
    p_ring: int
    ulysses_outer: bool  # True = SwiftFusion/TAS; False = USP
    # Hierarchical a2a factorisation (DESIGN.md §8.2): number of machine
    # sub-groups each Ulysses group is split into.  u_groups == 1 is the
    # flat (monolithic or staged) a2a; u_groups == N decomposes every
    # Ulysses transform into an intra-machine exchange followed by
    # staged inter-machine hops.  Only meaningful with ulysses_outer
    # (the u-blocks must be machine-contiguous); resolve_layout enforces
    # the divisibility conditions.
    u_groups: int = 1

    @property
    def size(self) -> int:
        return self.p_ulysses * self.p_ring

    @property
    def u_group_size(self) -> int:
        """m_u: Ulysses-group members per machine sub-group."""
        return self.p_ulysses // self.u_groups

    # -- static (python int) coordinates, used to build perm tables --------
    def coords(self, p: int) -> tuple[int, int]:
        if self.ulysses_outer:
            return p // self.p_ring, p % self.p_ring
        return p % self.p_ulysses, p // self.p_ulysses

    def rank(self, u: int, r: int) -> int:
        if self.ulysses_outer:
            return u * self.p_ring + r
        return r * self.p_ulysses + u

    # -- permutation tables --------------------------------------------------
    def ring_perm(self, shift: int = 1) -> list[tuple[int, int]]:
        """Rotate by ``shift`` inside each Ring group (same u)."""
        out = []
        for u in range(self.p_ulysses):
            for r in range(self.p_ring):
                out.append((self.rank(u, r), self.rank(u, (r + shift) % self.p_ring)))
        return out

    def ulysses_stage_perm(self, k: int) -> list[tuple[int, int]]:
        """Stage ``k`` of the decomposed all-to-all: u sends to (u + k) % P_u
        inside each Ulysses group (same r).  §4.3 'Breakdown of All-to-All'."""
        out = []
        for u in range(self.p_ulysses):
            for r in range(self.p_ring):
                out.append(
                    (self.rank(u, r), self.rank((u + k) % self.p_ulysses, r))
                )
        return out

    def ulysses_intra_stage_perm(self, j: int) -> list[tuple[int, int]]:
        """Stage ``j`` of the hierarchical a2a's *fast leg*: distance-j
        rotation of the local coordinate u_lo = u % m_u inside each machine
        sub-group (same u_hi, same r).  With u_groups == N and
        ulysses_outer, every (u_hi, r) block is exactly one machine, so
        this perm never crosses the slow boundary."""
        g, m_u = self.u_groups, self.u_group_size
        out = []
        for hi in range(g):
            for lo in range(m_u):
                for r in range(self.p_ring):
                    out.append((
                        self.rank(hi * m_u + lo, r),
                        self.rank(hi * m_u + (lo + j) % m_u, r),
                    ))
        return out

    def ulysses_inter_stage_perm(self, k: int) -> list[tuple[int, int]]:
        """Stage ``k`` of the hierarchical a2a's *slow leg*: distance-k
        rotation of the machine coordinate u_hi = u // m_u (same u_lo,
        same r) — the only leg that touches the inter-machine wire."""
        g, m_u = self.u_groups, self.u_group_size
        out = []
        for hi in range(g):
            for lo in range(m_u):
                for r in range(self.p_ring):
                    out.append((
                        self.rank(hi * m_u + lo, r),
                        self.rank(((hi + k) % g) * m_u + lo, r),
                    ))
        return out


@dataclasses.dataclass(frozen=True)
class SlicedLayout:
    """``group`` repeated over ``slices`` slices of the batch (the mesh's
    batch axes, the CFG axis first).  The rank lists then hold every rank
    of the batch and SP axes, slice-major as the reference numbers them:
    flat rank ``s * group.size + p`` is rank p of slice s.  Each slice runs
    the group's schedule on its own ranks; a perm table covers every
    slice, so one put moves the chunks of all slices.  On a process mesh
    ``owners`` is the lists' owner map (launch.mesh.OwnerMap over the
    batch and SP axes): which process holds each entry; every put of the
    schedule takes it (comm/stream.py ``owners_of``)."""

    group: GroupLayout
    slices: int
    owners: Any = None

    @property
    def axes(self) -> AxisNames:
        return self.group.axes

    @property
    def p_ulysses(self) -> int:
        return self.group.p_ulysses

    @property
    def p_ring(self) -> int:
        return self.group.p_ring

    @property
    def ulysses_outer(self) -> bool:
        return self.group.ulysses_outer

    @property
    def u_groups(self) -> int:
        return self.group.u_groups

    @property
    def u_group_size(self) -> int:
        return self.group.u_group_size

    @property
    def size(self) -> int:
        return self.group.size * self.slices

    def coords(self, p: int) -> tuple[int, int]:
        return self.group.coords(p % self.group.size)

    def _tiled(self, perm: list[tuple[int, int]]) -> list[tuple[int, int]]:
        n = self.group.size
        return [(s * n + a, s * n + b) for s in range(self.slices)
                for a, b in perm]

    def ring_perm(self, shift: int = 1) -> list[tuple[int, int]]:
        return self._tiled(self.group.ring_perm(shift))

    def ulysses_stage_perm(self, k: int) -> list[tuple[int, int]]:
        return self._tiled(self.group.ulysses_stage_perm(k))

    def ulysses_intra_stage_perm(self, j: int) -> list[tuple[int, int]]:
        return self._tiled(self.group.ulysses_intra_stage_perm(j))

    def ulysses_inter_stage_perm(self, k: int) -> list[tuple[int, int]]:
        return self._tiled(self.group.ulysses_inter_stage_perm(k))


# ---------------------------------------------------------------------------
# Grouped all-to-all via staged channel puts (the one-sided decomposition);
# the transfer programs live in repro_torch.comm.stream.
# ---------------------------------------------------------------------------

def grouped_all_to_all(
    x: RankList,
    layout: GroupLayout,
    *,
    split_axis: int,
    backend: str = "xla",
    interpret: bool = True,
    wire_dtype: str | None = None,
) -> RankList:
    """All-to-all restricted to Ulysses groups of ``layout``.

    Splits each rank's tensor into P_u equal chunks along ``split_axis``;
    chunk j is delivered to ulysses-peer j.  Returns, per rank, the
    received chunks stacked on a new leading axis ordered by *source*
    ulysses coordinate.  Implemented as P_u - 1 one-sided channel stages;
    the diagonal chunk is stationary (§4.3) and never moves.  With
    ``layout.u_groups > 1`` the exchange runs the hierarchical two-level
    program instead: an intra-machine exchange followed by staged
    inter-machine hops, bitwise the same output (it only routes), with
    ``wire_dtype`` optionally fp8 on the inter-machine wire.
    """
    if layout.u_groups > 1:
        return hier_all_to_all(x, layout, split_axis=split_axis,
                               backend=backend, interpret=interpret,
                               wire_dtype=wire_dtype)
    return staged_all_to_all(x, layout, split_axis=split_axis,
                             backend=backend, interpret=interpret)


def _all_to_all(chunks: list[list[torch.Tensor]], layout) -> RankList:
    """The atomic all-to-all of the reference (``lax.all_to_all`` over the
    whole group, P_r == 1): rank p receives its own chunk of every rank of
    its group, stacked in source order.  A group is P_u consecutive ranks
    of the list (one per batch slice under ``SlicedLayout``)."""
    n = layout.p_ulysses
    _observe_exchange(chunks, layout)
    return [torch.stack([chunks[p - p % n + j][p % n] for j in range(n)],
                        dim=0)
            for p in range(len(chunks))]


def _observe_exchange(chunks: list[list[torch.Tensor]], layout) -> None:
    """With a comm profiler active, record the atomic exchange's issue as a
    leg of every (src, dst) pair of the rank list, ``nbytes`` one chunk.
    It is no put: it has no signal and makes no span (emit_leg_spans pairs
    an issue with its signal); launch/dryrun.py counts its bytes."""
    prof = _profiler.active()
    if prof is None:
        return
    n = layout.p_ulysses
    ranks = len(chunks)
    first = chunks[0][0]
    meta = prof.new_leg(
        kind="comm", stream="", channel="ulysses.all_to_all", stage=0,
        axes=tuple(layout.axes), nbytes=first.numel() * first.element_size(),
        n_tensors=1, backend="xla", intent="", ranks=ranks,
        perm=tuple((p, p - p % n + j) for p in range(ranks)
                   for j in range(n)))
    _profiler.mark(prof, meta, "issue", first.device)


def monolithic_all_to_all(
    x: RankList, layout: GroupLayout, *, split_axis: int,
    backend: str = "xla", interpret: bool = True,
    wire_dtype: str | None = None,
) -> RankList:
    """Baseline atomic all-to-all (what Ulysses does before Torus).

    Same contract as :func:`grouped_all_to_all`.  One atomic exchange when
    the ulysses group covers the whole flattened SP axis (P_r == 1) and the
    backend is "xla", as the reference's ``lax.all_to_all``; otherwise the
    staged implementation.  A hierarchical layout (``u_groups > 1``)
    always takes the two-level program.
    """
    if layout.u_groups > 1:
        return hier_all_to_all(x, layout, split_axis=split_axis,
                               backend=backend, interpret=interpret,
                               wire_dtype=wire_dtype)
    if layout.p_ring == 1 and backend == "xla" and all(
            t is not None for t in x):
        # the atomic exchange reads every rank's chunks: on a process mesh
        # the staged puts below move the same values
        return _all_to_all(
            [torch.chunk(t, layout.p_ulysses, dim=split_axis) for t in x],
            layout)
    return grouped_all_to_all(x, layout, split_axis=split_axis,
                              backend=backend, interpret=interpret)


def ungroup_all_to_all(
    stacked: RankList, layout: GroupLayout, *, concat_axis: int,
    backend: str = "xla", interpret: bool = True,
    wire_dtype: str | None = None,
) -> RankList:
    """Inverse transform: send ``stacked[p][j]`` back to ulysses-peer j and
    concatenate the received chunks along ``concat_axis`` (the fourth
    all-to-all of Ulysses attention, applied to O)."""
    p_u = layout.p_ulysses
    if p_u == 1:
        return rank_map(lambda s: s[0], stacked)
    if layout.u_groups > 1:
        return hier_ungroup(stacked, layout, concat_axis=concat_axis,
                            backend=backend, interpret=interpret,
                            wire_dtype=wire_dtype)
    if layout.p_ring == 1 and backend == "xla" and all(
            s is not None for s in stacked):
        moved = _all_to_all([list(s) for s in stacked], layout)
        return [torch.cat(list(m), dim=concat_axis) for m in moved]
    return staged_ungroup(stacked, layout, concat_axis=concat_axis,
                          backend=backend, interpret=interpret)
