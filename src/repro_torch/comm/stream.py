"""Staged transfer programs over one-sided channels (counterpart of
``src/repro/comm/stream.py``).

A ``Stream`` is an ordered sequence of channel stages making up one logical
transfer program; each stage opens a channel (a fixed route) and puts its
rank lists.  The programs the flat SP schedules need:

  ring_shift        — one intra-ring rotation (Ring Attention's KV hop)
  torus_hop         — distance-k hop inside the Ulysses group (§4.3 stage k
                      of the decomposed all-to-all)
  staged_all_to_all — the full P_u-stage decomposition with the stationary
                      diagonal chunk (grouped_all_to_all)
  staged_ungroup    — its inverse (the Push-O / fourth all-to-all)
  pipe_handoff      — the displaced pipeline's stage-boundary hand-off,
                      one put over the pipe axis

Every program runs all ranks of the group in lockstep: stage k's put
carries every rank's chunk, and no rank reads stage k's receive buffer
before every rank's stage-k chunk was issued.  ``layout`` ducks as any
object with ``axes``, ``p_ulysses``, ``coords(p)``, ``ring_perm(k)`` and
``ulysses_stage_perm(k)`` (core/collectives.GroupLayout in practice).

Not ported yet (ROADMAP Queue 1 item 4): the hierarchical programs
``intra_hop``, ``inter_hop``, ``hier_all_to_all``, ``hier_ungroup`` and the
fp8 wire codec.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .channel import Channel, InFlight, RankList, shift_perm

__all__ = ["Stream", "pipe_handoff", "ring_shift", "torus_hop",
           "staged_all_to_all", "staged_ungroup"]


@dataclasses.dataclass
class Stream:
    """An ordered program of channel transfers.

    ``channel`` mints a Channel bound to this stream at the current stage;
    ``next_stage`` advances the program counter.  ``backend`` selects the
    channel lowering for every stage ("xla" | "pallas", see channel.py).
    """

    name: str
    stage: int = 0
    backend: str = "xla"
    interpret: bool = True

    def channel(self, axes, perm, label: str = "") -> Channel:
        return Channel(axes=tuple(axes), perm=tuple(perm),
                       name=f"{self.name}.{label}" if label else self.name,
                       stream=self.name, stage=self.stage,
                       backend=self.backend, interpret=self.interpret)

    def next_stage(self) -> int:
        self.stage += 1
        return self.stage

    def put(self, axes, perm, *tensors, label: str = "",
            overlaps: str = "") -> InFlight:
        fut = self.channel(axes, perm, label).put(*tensors, overlaps=overlaps)
        self.next_stage()
        return fut


def ring_shift(layout: Any, *tensors: RankList, shift: int = 1,
               stream: Stream | None = None,
               overlaps: str = "", backend: str = "xla",
               interpret: bool = True) -> InFlight:
    """One rotation inside each Ring group (same u): the KV hop of Ring
    Attention.  Returns the in-flight handle — the caller owns the wait."""
    stream = stream or Stream("ring", backend=backend, interpret=interpret)
    return stream.put(layout.axes, layout.ring_perm(shift), *tensors,
                      label=f"shift{shift}", overlaps=overlaps)


def torus_hop(layout: Any, k: int, *tensors: RankList,
              stream: Stream | None = None,
              overlaps: str = "", backend: str = "xla",
              interpret: bool = True) -> InFlight:
    """Distance-k hop inside each Ulysses group (same r): stage k of the
    §4.3 decomposed all-to-all."""
    stream = stream or Stream("torus", backend=backend, interpret=interpret)
    return stream.put(layout.axes, layout.ulysses_stage_perm(k), *tensors,
                      label=f"hop{k}", overlaps=overlaps)


def _u_of(layout: Any, p: int) -> int:
    return layout.coords(p)[0]


def staged_all_to_all(
    x: RankList,
    layout: Any,
    *,
    split_axis: int,
    stream: Stream | None = None,
    backend: str = "xla",
    interpret: bool = True,
) -> RankList:
    """All-to-all restricted to Ulysses groups, as P_u - 1 channel stages.

    Splits each rank's tensor into P_u chunks along ``split_axis``; chunk j
    is put to ulysses-peer j.  The diagonal chunk (j == the rank's u) is
    stationary (§4.3) and never moves.  Returns, per rank, the chunks
    stacked on a new leading axis in *source*-u order: ``out[p][j]`` is the
    chunk peer j produced for rank p.
    """
    stream = stream or Stream("a2a", backend=backend, interpret=interpret)
    p_u = layout.p_ulysses
    if x[0].shape[split_axis] % p_u:
        raise ValueError(f"axis {split_axis} of size {x[0].shape[split_axis]} "
                         f"does not split into {p_u} chunks")
    chunks = [torch.chunk(t, p_u, dim=split_axis) for t in x]
    if p_u == 1:
        return [torch.stack(c, dim=0) for c in chunks]
    us = [_u_of(layout, p) for p in range(len(x))]
    out = [[None] * p_u for _ in x]
    for p, u in enumerate(us):
        out[p][u] = chunks[p][u]
    for k in range(1, p_u):
        # each rank puts its chunk for peer (u + k); peer (u - k) puts its own
        send = [chunks[p][(u + k) % p_u] for p, u in enumerate(us)]
        recv = torus_hop(layout, k, send, stream=stream).wait()
        for p, u in enumerate(us):
            out[p][(u - k) % p_u] = recv[p]
    return [torch.stack(o, dim=0) for o in out]


def staged_ungroup(
    stacked: RankList,
    layout: Any,
    *,
    concat_axis: int,
    stream: Stream | None = None,
    backend: str = "xla",
    interpret: bool = True,
) -> RankList:
    """Inverse program: put ``stacked[p][j]`` back to ulysses-peer j and
    concatenate the received chunks along ``concat_axis`` (the fourth
    all-to-all of Ulysses attention / Torus Push-O; diagonal stays put)."""
    stream = stream or Stream("a2a.inv", backend=backend, interpret=interpret)
    p_u = layout.p_ulysses
    if p_u == 1:
        return [s[0] for s in stacked]
    us = [_u_of(layout, p) for p in range(len(stacked))]
    out = [[None] * p_u for _ in stacked]
    for p, u in enumerate(us):
        out[p][u] = stacked[p][u]
    for k in range(1, p_u):
        send = [stacked[p][(u + k) % p_u] for p, u in enumerate(us)]
        recv = torus_hop(layout, k, send, stream=stream,
                         overlaps="next-layer compute").wait()
        for p, u in enumerate(us):
            out[p][(u - k) % p_u] = recv[p]
    return [torch.cat(o, dim=concat_axis) for o in out]


def pipe_handoff(
    x: torch.Tensor,
    mesh: Any,
    axis: str,
    *,
    shift: int = 1,
    batch_axes: tuple[str, ...] | None = None,
    stream: Stream | None = None,
    backend: str = "xla",
    interpret: bool = True,
) -> torch.Tensor:
    """Stage-boundary hand-off of the displaced patch pipeline: rotate the
    activation one stage forward along the pipe ``axis``.

    The activation is replicated over the pipe axis and split over
    ``batch_axes`` (the reference's shard_map spec), so the rank list holds
    one batch slice per (slice, pipe rank), slice-major, and ONE put over
    the single axis moves every rank's slice: with ``backend="pallas"``
    and ``interpret=False`` that is one direct put, K3.  The rotation
    preserves values; the result is what pipe rank 0 received, per slice.
    """
    stream = stream or Stream("pipe", backend=backend, interpret=interpret)
    pp = mesh.shape[axis]
    if pp == 1:
        return x
    n = mesh.axes_size(batch_axes or ())
    perm = [(s * pp + a, s * pp + b) for s in range(n)
            for a, b in shift_perm(pp, shift)]
    ch = stream.channel((axis,), perm, f"handoff{stream.stage}")
    stream.next_stage()
    ranks = [xs for xs in torch.chunk(x.contiguous(), n, dim=0)
             for _ in range(pp)]
    recv = ch.put(ranks, overlaps="stage compute").wait()
    return torch.cat(recv[::pp], dim=0)
