"""SP strategy dispatch: full | ring | ulysses | usp | swift | swift_torus
(counterpart of ``src/repro/core/strategy.py``).

This is the entry point models call for attention.  ``SPConfig`` carries
every field of the reference's, so configurations move between the two
packages unchanged.

The reference runs the SP schedules under ``shard_map`` over the mesh's SP
axes.  Here every rank of the mesh is a *virtual rank* in this process
(launch/mesh.py): ``sp_attention`` splits the global [B, L, H, D] tensors
into per-rank sequence shards in flat-rank order, runs the schedule for all
ranks in lockstep (stage s of every rank is issued before any rank
consumes stage s's receive buffers) and concatenates the result.  Batch
axes of the mesh (``effective_batch_axes``: the CFG axis, then the data
axes) split the batch into slices; each slice runs the schedule on its own
SP ranks, and the rank lists hold the ranks of every slice (slice-major,
``collectives.SlicedLayout``), so one put still covers every rank.  At SP
degree 1 every strategy computes plain attention through the flash_mqkv
kernel (``kernels.ops.flash_attention``).

Strategies (P = SP degree, N = machines, M = devices per machine):
  full        — no SP; single-device attention.
  ring        — Ring Attention over the whole SP group (P_u = 1).
  ulysses     — Ulysses Attention over the whole SP group (P_r = 1).
  usp         — USP baseline [5]: Ulysses intra-machine, Ring inter.
  swift       — SwiftFusion TAS (§4.2): Ulysses *inter*-machine, Ring
                *intra*; monolithic all-to-alls.
  swift_torus — TAS + Torus Attention (§4.3): chunked all-to-all overlapped
                with compute, one-sided puts.

``hier_a2a`` decomposes every Ulysses all-to-all that spans the machine
boundary into an intra-machine exchange and staged inter-machine hops
(comm/stream.py ``hier_all_to_all``), and ``a2a_wire_dtype`` puts the
inter-machine leg in fp8 (comm/compress.py).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..comm.channel import first
from ..comm.compress import WIRE_DTYPES
from ..comm.kernel_backend import process_step
from ..kernels.ops import flash_attention
from . import planner
from .collectives import GroupLayout, SlicedLayout, rank_map
from .ring import ring_attention
from .softmax import finalize
from .sp_grad import SPAttention
from .torus import torus_attention
from .ulysses import gather_qkv, group_positions, scatter_o

STRATEGIES = ("full", "ring", "ulysses", "usp", "swift", "swift_torus")


@dataclasses.dataclass(frozen=True)
class SPConfig:
    """How attention is distributed (fields as in the reference)."""

    strategy: str = "swift_torus"
    sp_axes: tuple[str, ...] = ("model",)  # sequence-parallel mesh axes
    batch_axes: tuple[str, ...] | None = ("data",)  # batch (DP) mesh axes
    machine_axis: str = "pod"  # the slow-boundary axis (paper's N)
    replicate_kv: bool = False  # allow P_u up to gcd(SP, Hq) by replicating KV
    # hybrid-parallel axes: the CFG branch axis and the patch-pipeline
    # stage axis (never touched by attention itself)
    cfg_axis: str | None = None
    pp_axis: str | None = None
    unroll_ring: bool = True  # kept so configurations carry across; eager
    # PyTorch runs the same ring steps either way, so nothing reads it
    # beyond-paper: fuse all Pull-Q stage compute into one ring circulation
    torus_fused_pull_q: bool = False
    # beyond-paper: cap the materialized score matrix per attend
    attn_kv_block: int | None = None
    # comm lowering (names kept from the reference so configurations carry
    # across): "xla" = plain copies for the puts and plain attention per
    # chunk; "pallas" = the hand-written kernels, K2/K1 per ring step and
    # the put kernels K3/K4.  kernel_interpret=False on a single-axis route
    # selects the direct put K3, as on the TPU.
    comm_backend: str = "xla"
    kernel_interpret: bool = True
    # Hierarchical a2a: decompose every Ulysses all-to-all into an
    # intra-machine exchange plus staged inter-machine hops whenever the
    # Ulysses groups span machines (it engages only when the topology
    # qualifies: ulysses-outer placement, N > 1, N | P_u, P_u > N —
    # otherwise the flat path runs unchanged).  a2a_wire_dtype compresses
    # the inter-machine leg ("float8_e4m3fn" / "float8_e5m2",
    # comm/compress.py); None keeps the wire exact, which is what makes
    # the hierarchical path bitwise the flat one.
    hier_a2a: bool = False
    a2a_wire_dtype: str | None = None

    def __post_init__(self):
        assert self.strategy in STRATEGIES, self.strategy
        assert self.comm_backend in ("xla", "pallas"), self.comm_backend
        if self.a2a_wire_dtype is not None:
            assert self.a2a_wire_dtype in WIRE_DTYPES, self.a2a_wire_dtype

    def effective_batch_axes(self, mesh=None) -> tuple[str, ...] | None:
        """Batch mesh axes with the CFG axis prepended (when present); with
        a mesh, axes it does not carry are dropped (as the reference)."""
        axes = ((self.cfg_axis,) if self.cfg_axis else ()) + tuple(
            self.batch_axes or ())
        if mesh is not None:
            axes = tuple(a for a in axes if a in mesh.axis_names)
        return axes or None


def resolve_layout(cfg: SPConfig, mesh, num_q_heads: int,
                   num_kv_heads: int) -> GroupLayout:
    """Instantiate the paper's (P_u x P_r) plan for this mesh + head count
    (the reference's rule)."""
    sp = mesh.axes_size(cfg.sp_axes)
    n = mesh.shape[cfg.machine_axis] if cfg.machine_axis in cfg.sp_axes else 1
    m = sp // n

    def u_groups(p_u: int, outer: bool) -> int:
        # The hierarchical decomposition applies when the Ulysses groups
        # span the machine boundary with > 1 member per machine: u-blocks
        # are then machine-contiguous (block size (P_u/N)·P_r = M) and the
        # two-level factorisation u = u_hi·m_u + u_lo is exact.
        if (cfg.hier_a2a and outer and n > 1 and p_u > n
                and p_u % n == 0):
            return n
        return 1
    if cfg.strategy == "ring":
        return GroupLayout(cfg.sp_axes, 1, sp, ulysses_outer=True)
    if cfg.strategy == "ulysses":
        heads = (num_q_heads if cfg.replicate_kv
                 else math.gcd(num_q_heads, num_kv_heads))
        if heads % sp != 0:
            raise ValueError(
                f"ulysses needs SP ({sp}) | heads ({heads}); use usp/swift "
                "instead")
        return GroupLayout(cfg.sp_axes, sp, 1, ulysses_outer=True,
                           u_groups=u_groups(sp, True))
    swift = cfg.strategy in ("swift", "swift_torus")
    pl = planner.plan(n, m, num_q_heads, num_kv_heads, swift=swift,
                      replicate_kv=cfg.replicate_kv)
    return GroupLayout(cfg.sp_axes, pl.p_ulysses, pl.p_ring,
                       ulysses_outer=swift,
                       u_groups=u_groups(pl.p_ulysses, swift))


def _usp_like(q, k, v, layout: GroupLayout, *, scale, causal, window,
              kv_block=None, backend="xla", interpret=True, wire_dtype=None,
              return_stats=False):
    """Shared body for usp/swift/ulysses/ring: monolithic Ulysses gather ->
    Ring Attention -> scatter.  The layout decides which boundary each
    technique crosses (that single bit is the paper's §4.2 contribution).
    ``return_stats`` also returns each rank's final (m, l), as
    ``torus_attention`` does."""
    lk = first(k).shape[1]  # the K/V shard's own length (cross-attention)
    dev = first(q).device
    g = gather_qkv(q, k, v, layout, backend=backend, interpret=interpret,
                   wire_dtype=wire_dtype)

    def kpos_fn(p, owner_r):
        return group_positions(layout, lk, owner_r, dev)

    parts = ring_attention(
        g.q, g.k, g.v, layout,
        q_pos=g.q_pos, k_pos_fn=kpos_fn,
        scale=scale, causal=causal, window=window,
        kv_block=kv_block, backend=backend, interpret=interpret,
    )
    dtype = first(q).dtype
    out = scatter_o(rank_map(lambda pt: finalize(pt, dtype=dtype), parts),
                    layout, backend=backend, interpret=interpret,
                    wire_dtype=wire_dtype)
    if return_stats:
        return out, rank_map(lambda pt: (pt.m, pt.l), parts)
    return out


def sp_attention(
    q: torch.Tensor,  # [B, L, Hq, D]
    k: torch.Tensor,  # [B, L, Hkv, D]
    v: torch.Tensor,
    *,
    cfg: SPConfig,
    mesh=None,
    scale: float | None = None,
    causal: bool = False,
    window: int | None = None,
) -> torch.Tensor:
    """Attention per the configured SP strategy over the mesh's ranks.

    The sequence is split over ``cfg.sp_axes`` (flat-rank order, major axis
    first) and the batch over the mesh's batch axes; heads and head dim
    stay whole inside the SP group.  Without a mesh, or at SP degree 1, or
    with strategy "full", it runs the flash_mqkv kernel on the whole
    sequence and batch.  When q, k or v wants a gradient, the schedule
    runs inside ``sp_grad.SPAttention``, whose backward is the
    schedule's (K1b per KV chunk, the puts).

    On a process mesh (``mesh.is_process_mesh``) q, k and v are already
    this process's part: its batch slice (one coordinate of the batch
    axes) and its sequence shard, the concatenation of its SP ranks'
    shards.  The split and the concatenation are skipped, the schedule
    runs over the owned entries of the sliced rank lists (global
    positions come from their rank numbers; ``SlicedLayout.owners`` says
    which process holds each entry) and the result is this process's
    rows of the output.  The call is one step of the process heap's fence
    (kernel_backend.process_step).
    """
    sp = mesh.axes_size(cfg.sp_axes) if mesh is not None else 1
    if cfg.strategy == "full" or sp == 1:
        return flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale)
    if q.device != mesh.device:
        raise ValueError(f"q is on {q.device}, the mesh on {mesh.device}")
    procs = mesh.is_process_mesh
    slices = mesh.axes_size(cfg.effective_batch_axes(mesh) or ())
    if procs:
        # a block lies within one coordinate of every axis outside the SP
        # axes (one batch slice, one pipe stage) and holds a contiguous run
        # of SP ranks; q and k/v are that slice's shards of those ranks,
        # each at its own length (Lq != Lk: each chunked over the owned
        # ranks, each rank's positions from its own shard length)
        mesh.check_blocks(cfg.sp_axes)
    if not procs and q.shape[0] % slices:
        raise ValueError(f"batch {q.shape[0]} does not split evenly over "
                         f"{slices} batch slices (as shard_map requires)")
    held = mesh.sp_owned(cfg.sp_axes) if procs else range(sp)
    for seq in {q.shape[1], k.shape[1]}:
        if seq % len(held):
            raise ValueError(f"sequence length {seq} does not split evenly "
                             f"over SP degree {sp} (as shard_map requires)")

    layout = resolve_layout(cfg, mesh, q.shape[2], k.shape[2])
    if cfg.replicate_kv and layout.p_ulysses > 1:
        rep = layout.p_ulysses // math.gcd(layout.p_ulysses, k.shape[2])
        if rep > 1:
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)

    kw = dict(scale=scale, causal=causal, window=window,
              kv_block=cfg.attn_kv_block,
              backend=cfg.comm_backend, interpret=cfg.kernel_interpret,
              wire_dtype=cfg.a2a_wire_dtype)
    if procs:
        # rank lists of every (slice, SP rank), slice-major, None where
        # another process holds the entry
        layout = SlicedLayout(layout, slices, owners=mesh.owner_map(
            (cfg.effective_batch_axes(mesh) or ()) + tuple(cfg.sp_axes)))
        owned = layout.owners.owned
        shards = []
        for x in (q, k, v):
            parts = dict(zip(owned, torch.chunk(x, len(owned), dim=1)))
            shards.append([parts.get(p) for p in range(layout.size)])
    else:
        if slices > 1:
            layout = SlicedLayout(layout, slices)
        # rank lists, slice-major: rank s * sp + p holds sequence shard p
        # of batch slice s
        shards = [[c for xs in torch.chunk(x, slices, dim=0)
                   for c in torch.chunk(xs, sp, dim=1)] for x in (q, k, v)]

    def schedule(q_, k_, v_, **extra):
        if cfg.strategy == "swift_torus":
            return torus_attention(q_, k_, v_, layout,
                                   fused_pull_q=cfg.torus_fused_pull_q,
                                   **kw, **extra)
        return _usp_like(q_, k_, v_, layout, **kw, **extra)

    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        if procs:
            raise NotImplementedError(
                "training over a process mesh is a later slice (ROADMAP "
                "Queue 1 item 12)")
        bwd_kw = dict(scale=scale, causal=causal, window=window,
                      backend=cfg.comm_backend, interpret=cfg.kernel_interpret)
        out = SPAttention.apply(schedule, layout, bwd_kw, *shards[0],
                                *shards[1], *shards[2])
    else:
        with process_step(q.device):
            out = schedule(*shards)
    if procs:
        return torch.cat([o for o in out if o is not None], dim=1)
    return torch.cat([torch.cat(out[s * sp:(s + 1) * sp], dim=1)
                      for s in range(slices)], dim=0)

