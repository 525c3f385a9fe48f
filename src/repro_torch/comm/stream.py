"""Staged transfer programs over one-sided channels (counterpart of
``src/repro/comm/stream.py``).

A ``Stream`` is an ordered sequence of channel stages making up one logical
transfer program; each stage opens a channel (a fixed route) and puts its
rank lists.  The programs the SP schedules need:

  ring_shift          — one intra-ring rotation (Ring Attention's KV hop)
  torus_hop           — distance-k hop inside the Ulysses group (§4.3
                        stage k of the decomposed all-to-all)
  staged_all_to_all   — the full P_u-stage decomposition with the
                        stationary diagonal chunk (grouped_all_to_all)
  staged_ungroup      — its inverse (the Push-O / fourth all-to-all)
  intra_hop/inter_hop — the two legs of the hierarchical all-to-all:
                        distance-j rotation inside a machine sub-group /
                        distance-k rotation across machine sub-groups
  hier_all_to_all     — the two-level (intra-machine exchange, then staged
                        inter-machine hops) decomposition of the Ulysses
                        all-to-all; bitwise the flat path's output,
                        optionally fp8 on the inter-machine wire
  hier_ungroup        — its inverse (the hierarchical Push-O)
  pipe_handoff        — the displaced pipeline's stage-boundary hand-off,
                        one put over the pipe axis
  sp_all_gather       — a process mesh's shards gathered over the SP
                        axes (the warm pass's layer KV, its output rows;
                        over the cfg axis, the branches' velocities)

Every program runs all ranks of the group in lockstep: stage k's put
carries every rank's chunk, and no rank reads stage k's receive buffer
before every rank's stage-k chunk was issued.  The stages of one leg are
independent of each other, and in eager PyTorch the order of issue is the
schedule: a leg issues all its stage puts, then places the stationary
diagonal chunk (the compute block they run beside; the reference's update
fusions), then waits for the stages in turn.  On a process mesh a
program issues only the sources this process owns and waits only on the
destinations it owns (the other entries of its rank lists are None).
``layout`` ducks as any
object with ``axes``, ``p_ulysses``, ``coords(p)``, ``ring_perm(k)`` and
``ulysses_stage_perm(k)`` (core/collectives.GroupLayout in practice; the
hierarchical programs also read ``u_groups`` and the intra / inter stage
perms).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from . import compress as _compress
from .channel import (Channel, InFlight, RankList, first, owned_ranks,
                      rank_map, shift_perm)
from .profiler import mark_compute

__all__ = ["Handoff", "Stream", "hier_all_to_all",
           "hier_ungroup", "inter_hop", "intra_hop", "owners_of",
           "pipe_handoff", "ring_shift", "sp_all_gather",
           "staged_all_to_all", "staged_ungroup", "torus_hop"]


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

    def channel(self, axes, perm, label: str = "", owners=None) -> Channel:
        return Channel(axes=tuple(axes), perm=tuple(perm),
                       name=f"{self.name}.{label}" if label else self.name,
                       stream=self.name, stage=self.stage,
                       backend=self.backend, interpret=self.interpret,
                       owners=owners)

    def next_stage(self) -> int:
        self.stage += 1
        return self.stage

    def put(self, axes, perm, *tensors, label: str = "",
            overlaps: str = "", owners=None) -> InFlight:
        fut = self.channel(axes, perm, label, owners).put(*tensors,
                                                          overlaps=overlaps)
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
                      label=f"shift{shift}", overlaps=overlaps,
                      owners=owners_of(layout))


def torus_hop(layout: Any, k: int, *tensors: RankList,
              stream: Stream | None = None,
              overlaps: str = "", backend: str = "xla",
              interpret: bool = True) -> InFlight:
    """Distance-k hop inside each Ulysses group (same r): stage k of the
    §4.3 decomposed all-to-all."""
    stream = stream or Stream("torus", backend=backend, interpret=interpret)
    return stream.put(layout.axes, layout.ulysses_stage_perm(k), *tensors,
                      label=f"hop{k}", overlaps=overlaps,
                      owners=owners_of(layout))


def intra_hop(layout: Any, j: int, *tensors: RankList,
              stream: Stream | None = None,
              overlaps: str = "", backend: str = "xla",
              interpret: bool = True) -> InFlight:
    """Distance-j hop inside the machine-local Ulysses sub-group (same
    u_hi, same r): stage j of the hierarchical all-to-all's fast leg.
    Never crosses the slow boundary."""
    stream = stream or Stream("hier", backend=backend, interpret=interpret)
    return stream.put(layout.axes, layout.ulysses_intra_stage_perm(j),
                      *tensors, label=f"intra{j}", overlaps=overlaps,
                      owners=owners_of(layout))


def inter_hop(layout: Any, k: int, *tensors: RankList,
              stream: Stream | None = None,
              overlaps: str = "", backend: str = "xla",
              interpret: bool = True) -> InFlight:
    """Distance-k hop across machine sub-groups (same u_lo, same r): stage
    k of the hierarchical all-to-all's slow leg, the only leg that touches
    the inter-machine wire."""
    stream = stream or Stream("hier", backend=backend, interpret=interpret)
    return stream.put(layout.axes, layout.ulysses_inter_stage_perm(k),
                      *tensors, label=f"inter{k}", overlaps=overlaps,
                      owners=owners_of(layout))


def owners_of(layout: Any):
    """The owner map of a layout's rank lists on a process mesh
    (``collectives.SlicedLayout.owners``), else None."""
    return getattr(layout, "owners", None)


def _u_of(layout: Any, p: int) -> int:
    return layout.coords(p)[0]


def _split(x: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    """``x`` split into ``n`` chunks along ``axis``, stacked on a new
    leading axis, as a view."""
    if x.shape[axis] % n:
        raise ValueError(f"axis {axis} of size {x.shape[axis]} does not "
                         f"split into {n} chunks")
    return x.unflatten(axis, (n, -1)).movedim(axis, 0)


def _diagonal(out: RankList, src: RankList, idx: list[int], layout: Any,
              stream: Stream) -> None:
    """Place each rank's stationary chunk, ``out[p][idx[p]] =
    src[p][idx[p]]``: the compute block a leg's puts run beside."""
    with mark_compute(f"{stream.name} diagonal", layout.axes,
                      first(src).device, stream=stream.name):
        for p in owned_ranks(src):
            out[p][idx[p]].copy_(src[p][idx[p]])


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
    chunks = rank_map(lambda t: _split(t, p_u, split_axis), x)
    if p_u == 1:
        return rank_map(
            lambda c: c.clone(memory_format=torch.contiguous_format), chunks)
    us = [_u_of(layout, p) for p in range(len(x))]
    # each rank puts its chunk for peer (u + k); peer (u - k) puts its own
    futs = [torus_hop(layout, k, _send(chunks, us, k, p_u), stream=stream)
            for k in range(1, p_u)]
    out = rank_map(lambda c: torch.empty_like(
        c, memory_format=torch.contiguous_format), chunks)
    _diagonal(out, chunks, us, layout, stream)
    for k, fut in enumerate(futs, start=1):
        recv = fut.wait()
        for p in owned_ranks(out):
            out[p][(us[p] - k) % p_u].copy_(recv[p])
    return out


def _send(chunks: RankList, us: list[int], k: int, p_u: int) -> RankList:
    """Each held rank's chunk for its ulysses peer u + k."""
    return [None if c is None else c[(u + k) % p_u]
            for c, u in zip(chunks, us)]


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
        return rank_map(lambda s: s[0], stacked)
    us = [_u_of(layout, p) for p in range(len(stacked))]
    futs = [torus_hop(layout, k, _send(stacked, us, k, p_u), stream=stream,
                      overlaps="next-layer compute")
            for k in range(1, p_u)]
    out = rank_map(lambda s: _concat_buffer(s, concat_axis), stacked)
    _diagonal(out, stacked, us, layout, stream)
    for k, fut in enumerate(futs, start=1):
        recv = fut.wait()
        for p in owned_ranks(out):
            out[p][(us[p] - k) % p_u].copy_(recv[p])
    return rank_map(lambda o: o.movedim(0, concat_axis).flatten(
        concat_axis, concat_axis + 1), out)


def _concat_buffer(stacked: torch.Tensor, axis: int) -> torch.Tensor:
    """A buffer for ``torch.cat(list(stacked), dim=axis)``, as the view
    [P_u, ...] that ``stacked`` indexes into: writing ``buf[j]`` writes
    chunk j of the concatenation."""
    n, *rest = stacked.shape
    shape = rest[:axis] + [n * rest[axis]] + rest[axis + 1:]
    buf = stacked.new_empty(shape)
    return buf.unflatten(axis, (n, -1)).movedim(axis, 0)


def _hier_exchange(
    chunks: RankList,
    layout: Any,
    *,
    stream: Stream,
    wire_dtype: str | None = None,
    err: list[tuple[torch.Tensor, ...]] | None = None,
    overlaps_inter: str = "peer inter hops + update fusions",
    out: RankList | None = None,
) -> RankList | tuple[RankList, list[tuple[torch.Tensor, ...]]]:
    """Two-level routing core shared by hier_all_to_all / hier_ungroup.

    ``chunks[p]`` is [P_u, ...] in destination-u order (chunk j is what
    rank p owes peer u = j); writes, per rank, [P_u, ...] in source-u order
    (``out[p][j]`` = what peer u = j produced for rank p) — the exact
    contract of the flat staged path — into ``out`` (fresh buffers when
    None) and returns it.

    Factor u = u_hi * m_u + u_lo over (machine sub-group, local slot),
    g = layout.u_groups, m_u = P_u / g.  Two legs:

      fast leg (m_u - 1 intra stages): within each machine, local slot b
        sends the whole [g]-bundle of chunks destined for local slot
        (b + j) — after it, W[b'] holds the g chunks source (a, b')
        produced for the b-slots of every machine sub-group.
      slow leg (g - 1 inter stages): across machines, sub-group a sends
        the [m_u]-bundle W[:, (a + k) % g] — m_u chunks in one message, so
        the inter-machine wire sees g - 1 stages instead of P_u - 1.

    Both diagonals are stationary.  The program only routes, so the output
    is bitwise the flat path's.  With ``wire_dtype`` the slow leg
    quantises each bundle (compress.py) before the put — each rank with
    its own absmax scale, a 0-d float32 tensor in the same put — and
    dequantises on arrival; ``err`` (per rank, a tuple of g - 1 float32
    buffers) turns on error feedback, and the new residuals are returned
    beside the output.
    """
    g = layout.u_groups
    p_u = layout.p_ulysses
    m_u = p_u // g
    ranks = owned_ranks(chunks)
    rest = tuple(first(chunks).shape[1:])
    ab = [divmod(_u_of(layout, p), m_u) for p in range(len(chunks))]
    shaped = rank_map(lambda c: c.reshape((g, m_u) + rest), chunks)

    def send(pick):  # each held rank's bundle, None where another holds it
        return [None if shaped[p] is None else pick(p)
                for p in range(len(chunks))]

    # fast leg: intra-machine exchange of dest-local-slot bundles
    futs = [intra_hop(layout, j, send(lambda p: shaped[p][:, (ab[p][1] + j)
                                                          % m_u]),
                      stream=stream) for j in range(1, m_u)]
    # w[p][b'] = the [g] bundle source (a, b') produced for rank p's slot
    w = rank_map(lambda c: c.new_empty((g, m_u) + rest).transpose(0, 1),
                 chunks)
    _diagonal(w, rank_map(lambda s: s.transpose(0, 1), shaped),
              [b for _, b in ab], layout, stream)
    for j, fut in enumerate(futs, start=1):
        recv = fut.wait()
        for p in ranks:
            w[p][(ab[p][1] - j) % m_u].copy_(recv[p])

    # slow leg: inter-machine exchange of per-sub-group bundles, every
    # stage in flight at once
    new_err: list[list[torch.Tensor] | None] = [
        None if c is None else [] for c in chunks]
    futs = []
    for k in range(1, g):
        x = send(lambda p: w[p][:, (ab[p][0] + k) % g])
        if wire_dtype is None:
            futs.append(inter_hop(layout, k, x, stream=stream,
                                  overlaps=overlaps_inter))
            continue
        wires, scales = [None] * len(x), [None] * len(x)
        for p in ranks:
            if err is not None:
                wires[p], scales[p], e = _compress.ef_encode(
                    x[p], err[p][k - 1], wire_dtype)
                new_err[p].append(e)
            else:
                wires[p], scales[p] = _compress.quantize(x[p], wire_dtype)
        futs.append(inter_hop(layout, k, wires, scales, stream=stream,
                              overlaps=overlaps_inter))
    if out is None:
        out = rank_map(lambda c: c.new_empty((p_u,) + rest), chunks)
    hier_out = rank_map(lambda o: o.unflatten(0, (g, m_u)), out)
    _diagonal(hier_out, rank_map(lambda x: x.transpose(0, 1), w),
              [a for a, _ in ab], layout, stream)
    for k, fut in enumerate(futs, start=1):
        recv = fut.wait()
        if wire_dtype is not None:
            rw, rs = recv
            recv = [None if rw[p] is None else
                    _compress.dequantize(rw[p], rs[p], chunks[p].dtype)
                    for p in range(len(chunks))]
        for p in ranks:
            hier_out[p][(ab[p][0] - k) % g].copy_(recv[p])
    if err is not None:
        return out, [None if e is None else tuple(e) for e in new_err]
    return out


def hier_all_to_all(
    x: RankList,
    layout: Any,
    *,
    split_axis: int,
    stream: Stream | None = None,
    backend: str = "xla",
    interpret: bool = True,
    wire_dtype: str | None = None,
    err: list[tuple[torch.Tensor, ...]] | None = None,
) -> RankList | tuple[RankList, list[tuple[torch.Tensor, ...]]]:
    """Hierarchical two-level grouped all-to-all: the contract of
    :func:`staged_all_to_all` — split into P_u chunks along
    ``split_axis``, deliver chunk j to ulysses-peer j, return the received
    chunks stacked on a new leading axis in source-u order — routed as an
    intra-machine exchange followed by g - 1 bundled inter-machine hops."""
    stream = stream or Stream("hier.a2a", backend=backend,
                              interpret=interpret)
    p_u = layout.p_ulysses
    chunks = rank_map(lambda t: _split(t, p_u, split_axis), x)
    if p_u == 1:
        out = rank_map(
            lambda c: c.clone(memory_format=torch.contiguous_format), chunks)
        return out if err is None else (out, [() for _ in x])
    return _hier_exchange(chunks, layout, stream=stream,
                          wire_dtype=wire_dtype, err=err)


def hier_ungroup(
    stacked: RankList,
    layout: Any,
    *,
    concat_axis: int,
    stream: Stream | None = None,
    backend: str = "xla",
    interpret: bool = True,
    wire_dtype: str | None = None,
    err: list[tuple[torch.Tensor, ...]] | None = None,
) -> RankList | tuple[RankList, list[tuple[torch.Tensor, ...]]]:
    """Hierarchical inverse: the contract of :func:`staged_ungroup` —
    ``stacked[p][j]`` goes back to ulysses-peer j, the received chunks
    concatenate along ``concat_axis``.  The exchange core is its own
    inverse (a transpose of the u coordinate), so this is the same two-leg
    program, writing straight into the concatenated output."""
    stream = stream or Stream("hier.a2a.inv", backend=backend,
                              interpret=interpret)
    p_u = layout.p_ulysses
    if p_u == 1:
        out = rank_map(lambda s: s[0], stacked)
        return out if err is None else (out, [() for _ in stacked])
    bufs = rank_map(lambda s: _concat_buffer(s, concat_axis), stacked)
    res = _hier_exchange(stacked, layout, stream=stream,
                         wire_dtype=wire_dtype, err=err,
                         overlaps_inter="next-layer compute", out=bufs)
    moved, new_err = res if err is not None else (res, None)
    out = rank_map(lambda o: o.movedim(0, concat_axis).flatten(
        concat_axis, concat_axis + 1), moved)
    return out if err is None else (out, new_err)


@dataclasses.dataclass(frozen=True)
class Handoff:
    """A pipeline hand-off in flight; ``wait`` returns the activation."""

    fut: InFlight | None  # None: no put (pp == 1)
    x: torch.Tensor | None = None  # the activation when there is no put
    pp: int = 1
    index: int | None = None  # a process mesh: the entry this process holds

    def wait(self) -> torch.Tensor:
        if self.fut is None:
            return self.x
        if self.index is not None:
            return self.fut.wait()[self.index]
        return torch.cat(self.fut.wait()[::self.pp], dim=0)


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
) -> Handoff:
    """Stage-boundary hand-off of the displaced patch pipeline: rotate the
    activation one stage forward along the pipe ``axis``.

    The activation is replicated over the pipe axis and split over
    ``batch_axes`` (the reference's shard_map spec), so the rank list holds
    one batch slice per (slice, pipe rank), slice-major, and ONE put over
    the single axis moves every rank's slice: with ``backend="pallas"``
    and ``interpret=False`` that is one direct put, K3.  The rotation
    preserves values.  Returns the put in flight: the caller computes
    beside it (the next patch's stage) before ``wait`` gives what pipe
    rank 0 received, per slice — the reference waits inside the call.

    On a process mesh ``x`` is this process's batch slice, and the list's
    one entry it holds goes to the process at pipe rank + shift with the
    same coordinates on every other axis (the list's owner map; one K3
    per process); ``wait`` gives what this process received.
    """
    stream = stream or Stream("pipe", backend=backend, interpret=interpret)
    pp = mesh.shape[axis]
    if pp == 1:
        return Handoff(None, x)
    batch_axes = tuple(batch_axes or ())
    n = mesh.axes_size(batch_axes)
    perm = [(s * pp + a, s * pp + b) for s in range(n)
            for a, b in shift_perm(pp, shift)]
    owners = index = None
    if mesh.is_process_mesh:
        owners = mesh.owner_map(batch_axes + (axis,))
        (index,) = owners.owned
        ranks = [None] * (n * pp)
        ranks[index] = x
    else:
        ranks = [xs for xs in torch.chunk(x.contiguous(), n, dim=0)
                 for _ in range(pp)]
    ch = stream.channel((axis,), perm, f"handoff{stream.stage}", owners)
    stream.next_stage()
    return Handoff(ch.put(ranks, overlaps="stage compute"), pp=pp,
                   index=index)


def sp_all_gather(
    xs: list[torch.Tensor],
    mesh: Any,
    sp_axes: tuple[str, ...],
    batch_axes: tuple[str, ...] | None,
    *,
    dim: int,
    out: list[torch.Tensor] | None = None,
    stream: Stream | None = None,
    backend: str = "xla",
    interpret: bool = True,
) -> list[torch.Tensor]:
    """On a process mesh: each of ``xs`` is this process's shard along
    ``dim`` (its run of SP ranks' shards, of its batch slice); returns
    each gathered over the SP axes, the whole in SP rank order (into
    ``out`` when given).  With blocks of b SP ranks, P = SP / b blocks a
    slice, it is P - 1 puts over the SP axes: put j moves every held
    rank's shard j blocks on, so each shard reaches every other block
    once.  ``sp_axes`` may be any axes the process's ranks form a run
    over (the MoE layer gathers over 'model', over the batch axes and
    over every axis), with ``batch_axes`` None.  The caller brackets it
    with a step fence."""
    stream = stream or Stream("gather", backend=backend,
                              interpret=interpret)
    sp = mesh.axes_size(sp_axes)
    owners = mesh.owner_map(tuple(batch_axes or ()) + tuple(sp_axes))
    owned = owners.owned
    b = len(owned)
    if (owned != tuple(range(owned[0], owned[0] + b))
            or owned[0] % sp + b > sp):
        raise ValueError(f"process {mesh.process} holds entries {owned} of "
                         f"a list over {tuple(sp_axes)}: not a run of one "
                         "slice, which a gather needs")
    lists = []
    for x in xs:
        parts = dict(zip(owned, torch.chunk(x, b, dim=dim)))
        lists.append([parts.get(p) for p in range(owners.size)])
    futs = []
    for j in range(1, sp // b):
        perm = [(s * sp + p, s * sp + (p + j * b) % sp)
                for s in range(owners.size // sp) for p in range(sp)]
        futs.append(stream.put(tuple(sp_axes), perm, *lists,
                               label=f"gather{j}", owners=owners))
    if out is None:
        out = []
        for x in xs:
            shape = list(x.shape)
            shape[dim] *= sp // b
            out.append(x.new_empty(shape))
    chunk = xs[0].shape[dim] // b
    for o, x in zip(out, xs):
        o.narrow(dim, (owned[0] % sp) * chunk, b * chunk).copy_(x)
    for j, fut in enumerate(futs, start=1):
        recv = fut.wait()
        recv = (recv,) if len(xs) == 1 else recv
        for o, r in zip(out, recv):
            for p in owned:
                src = (p % sp - j * b) % sp
                o.narrow(dim, src * chunk, chunk).copy_(r[p])
    return out
