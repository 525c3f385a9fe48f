"""Distributed decode attention over a sequence-sharded KV cache
(counterpart of ``src/repro/core/decode.py``).

Decode inverts the SP problem: Q is a single position, the KV cache is
what is sharded.  Every SP rank owns an equal slice of the cache's
sequence axis (flat-rank order over ``cfg.sp_axes``, as ``sp_attention``
splits a sequence).  Each rank writes the new token's K/V into its slice
if it owns position ``cur_index`` (here one write into the cache the
slices are views of), attends the replicated q against its
slice under ``pos <= cur_index`` (and ``pos > cur_index - window``),
producing an online-softmax partial ``(O', l, m)``; the partials are
merged with the reference's ``pmax`` / ``psum`` / ``psum`` (the distributed
Appendix-C merge, with its ``-inf`` and ``l == 0`` guards).  No heavy
tensor moves: only the [B, H, 1]-sized statistics cross ranks.

Here the ranks are virtual (launch/mesh.py): each rank's slice is a view of
the one cache tensor, and the merge is a reduction over the rank list (the
reference's XLA collectives, no put and no kernel).  The attention is
plain torch, as the reference's (``attend_partial``, outside Pallas).
Batch axes of the mesh split the slots into slices that each run this on
their own SP ranks; rows never mix, so every slice is computed at once.

On a process mesh (launch/procs.py) the caches are this process's part:
its batch slice's slots and its SP ranks' slices of the positions.  The
write lands only where an owned slice holds ``cur_index`` (still no
``.item()``), each owned rank's partial is computed as above, and the
partials of every SP rank are gathered by puts (``comm.stream``'s
``sp_all_gather``, one step of the heap's fence: P - 1 puts of (O', l, m)
for P processes a slice); every process then merges them all in rank
order, so the processes of a slice get the same bits.

Two differences of form from the reference, neither of value:
  * the caches are written in place (the reference returns updated
    copies); the returned caches are the tensors given, so a captured
    decode tick (serving/graphs.py) keeps them in its static buffers;
  * every index stays on the device (no ``.item()``, no Python branch on
    the owning rank), so the tick can be captured as a CUDA graph.
As in the reference, a cache whose dtype differs from the new K/V's is
refused (its ``dynamic_update_slice`` raises TypeError): a bfloat16 model
decodes from bfloat16 caches.
"""
from __future__ import annotations

import torch

from ..comm.kernel_backend import process_step
from ..comm.stream import sp_all_gather
from .softmax import MaskSpec, Partial, attend_partial


def device_index(cur_index, device: torch.device) -> torch.Tensor:
    """cur_index as a 0-d int64 tensor on ``device`` (a Python int is
    filled in place, never copied from the host)."""
    if isinstance(cur_index, torch.Tensor):
        return cur_index.to(device=device, dtype=torch.int64).reshape(())
    return torch.full((), int(cur_index), dtype=torch.int64, device=device)


def _write(cache: torch.Tensor, new: torch.Tensor, cur: torch.Tensor) -> None:
    """cache[:, cur] = new in place, where some rank owns ``cur`` (the
    ranks' slices tile the cache, so one write stands for the owner's; on
    a process mesh ``cur`` is relative to this process's part, and the
    write happens only where one of its ranks owns it); unchanged
    otherwise."""
    l_max = cache.shape[1]
    at = cur.clamp(0, l_max - 1).reshape(1)
    owned = (cur >= 0) & (cur < l_max)
    cache.index_copy_(1, at, torch.where(owned, new,
                                         cache.index_select(1, at)))


def decode_attention(
    q: torch.Tensor,  # [B, 1, Hq, D] the new token's query
    k_cache: torch.Tensor,  # [B, L_max, Hkv, D], L sharded over cfg.sp_axes
    v_cache: torch.Tensor,
    new_k: torch.Tensor,  # [B, 1, Hkv, D]
    new_v: torch.Tensor,
    cur_index: torch.Tensor | int,  # position being decoded
    *,
    mesh=None,
    cfg,
    scale: float | None = None,
    window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (attention output [B, 1, Hq, D], k_cache, v_cache), the
    caches written in place."""
    b, l_cache = k_cache.shape[:2]
    sp = mesh.axes_size(cfg.sp_axes) if mesh is not None else 1
    procs = mesh is not None and mesh.is_process_mesh
    held = mesh.sp_owned(cfg.sp_axes) if procs else range(sp)
    if l_cache % len(held):
        raise ValueError(f"cache length {l_cache * sp // len(held)} does not "
                         f"split evenly over SP degree {sp} (as shard_map "
                         "requires)")
    if mesh is not None and not procs:
        slices = mesh.axes_size(cfg.effective_batch_axes(mesh) or ())
        if b % slices:
            raise ValueError(f"batch {b} does not split evenly over "
                             f"{slices} batch slices (as shard_map requires)")
    for name, cache, new in (("k", k_cache, new_k), ("v", v_cache, new_v)):
        if cache.dtype != new.dtype:
            raise TypeError(f"{name} cache is {cache.dtype}, the new {name} "
                            f"{new.dtype}: the cache's dtype must be the "
                            "activations' (the reference's update refuses "
                            "mixed dtypes too)")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    shard_len = l_cache // len(held)
    base = held.start * shard_len  # the position of the cache's first row
    dev = q.device
    cur = device_index(cur_index, dev)
    offsets = torch.arange(shard_len, device=dev)
    _write(k_cache, new_k, cur - base)
    _write(v_cache, new_v, cur - base)
    parts = []
    for i in range(len(held)):
        start = i * shard_len
        kc = k_cache[:, start:start + shard_len]  # this rank's slice (views)
        vc = v_cache[:, start:start + shard_len]
        pos = base + start + offsets
        valid = pos <= cur
        if window is not None:
            valid &= pos > cur - window
        parts.append(attend_partial(q, kc, vc, scale=scale,
                                    mask=MaskSpec(valid_k=valid)))
    if procs:
        parts = _gather_partials(parts, mesh, cfg)
    # the distributed Appendix-C merge: one max and two sums over the ranks
    m_g = torch.stack([pt.m for pt in parts]).amax(dim=0)
    l_g, o_g = 0.0, 0.0
    for pt in parts:
        safe = torch.where(torch.isneginf(pt.m) & torch.isneginf(m_g),
                           torch.zeros_like(pt.m), pt.m - m_g)
        a = torch.exp(safe)
        l_g = l_g + pt.l * a
        o_g = o_g + pt.o * a.transpose(1, 2)[..., None]
    l_sw = l_g.transpose(1, 2)[..., None]  # [B, Lq, Hq, 1]
    o = o_g / torch.where(l_sw == 0.0, torch.ones_like(l_sw), l_sw)
    return o.to(q.dtype), k_cache, v_cache


def _gather_partials(parts: list[Partial], mesh, cfg) -> list[Partial]:
    """On a process mesh: every SP rank's partial (of this process's batch
    slice), in rank order, from the owned ranks' ``parts``.  One step of
    the heap's fence: ``comm.stream.sp_all_gather`` of (o, l, m), stacked
    over the owned ranks, P - 1 puts for P processes a slice."""
    stacked = [torch.stack(xs, dim=1) for xs in zip(*parts)]
    with process_step(stacked[0].device):
        o, l, m = sp_all_gather(
            stacked, mesh, cfg.sp_axes, cfg.effective_batch_axes(mesh),
            dim=1, backend=cfg.comm_backend, interpret=cfg.kernel_interpret)
    return [Partial(o[:, r], l[:, r], m[:, r]) for r in range(o.shape[1])]
