"""The gradient of a channel put (the counterpart of JAX's transpose rules:
the transpose of ``lax.ppermute(x, perm)`` is a ppermute along the inverse
permutation, and so that of a tiled ``lax.all_to_all`` is an all-to-all).

A put moves rank ``s``'s tensor into the receive buffer of rank
``perm[s]``.  Its cotangent map is the put of the buffers' cotangents
along the inverse route: rank ``perm[s]``'s cotangent goes back to rank
``s``.  ``Put`` is the ``torch.autograd.Function`` that ``Channel.put``
applies when grad mode is on and a payload tensor requires a gradient:

  forward  -> the put exactly as without a gradient (the same lowering,
              kernels and handle, its event and its wait), run under
              ``torch.no_grad()`` on every device, so that no device gets
              its gradient from a plain version's ``copy_``: on CUDA the
              put kernels K3/K4 write the receive buffers through ctypes,
              which autograd cannot see;
  backward -> one put of the cotangents along the inverse route, over the
              same axes with the same ``backend`` and ``interpret`` (so
              K3 on a single-axis route with ``interpret=False``, else K4,
              or a plain copy per rank for "xla"), waited on before it
              returns.  A cotangent autograd passes as None (a delivery
              the caller dropped, as ``models/ssm.py:shift_ranks`` drops
              the wrapped-around ones) is a zero of the buffer's shape.

Everything built from ``Channel.put`` inherits the gradient: ring shifts,
the staged and hierarchical all-to-alls and their inverses.  A put whose
wire is fp8 (comm/compress.py) has no gradient: under one it raises.  The
fused put (``Channel.put_fused``, K2) only runs inside SP attention's
forward, which runs without a gradient (core/sp_grad.py).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

__all__ = ["Put", "inverse_perm", "put_with_grad", "wants_grad"]

FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)  # comm/compress.py's wires


def wants_grad(tensors: Sequence[Sequence[torch.Tensor]]) -> bool:
    """Whether a put of ``tensors`` (rank lists) must be differentiated:
    grad mode on and any payload tensor requires a gradient."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for ranks in tensors
        for t in ranks)


def inverse_perm(perm: Sequence[tuple[int, int]]
                 ) -> tuple[tuple[int, int], ...]:
    """The route that takes every delivery back to its sender."""
    return tuple((d, s) for s, d in perm)


class Put(torch.autograd.Function):
    """``apply(issue, channel, n, handle, *flat)``: ``flat`` holds ``n``
    rank lists one after another; ``issue(tensors)`` runs the put without
    a gradient and returns its ``InFlight`` handle, which is appended to
    the list ``handle``.  Returns the receive buffers, flat in the same
    order."""

    @staticmethod
    def forward(ctx, issue, channel, n: int, handle: list,
                *flat: torch.Tensor):
        ranks = len(flat) // n
        tensors = tuple(list(flat[i * ranks:(i + 1) * ranks])
                        for i in range(n))
        with torch.no_grad():
            fut = issue(tensors)
        handle.append(fut)
        ctx.channel, ctx.n, ctx.ranks = channel, n, ranks
        ctx.meta = [(t.shape, t.dtype, t.device) for r in fut.payload
                    for t in r]
        return tuple(t for r in fut.payload for t in r)

    @staticmethod
    def backward(ctx, *grads: torch.Tensor):
        n, ranks = ctx.n, ctx.ranks
        want = [any(ctx.needs_input_grad[4 + i * ranks:4 + (i + 1) * ranks])
                for i in range(n)]
        cot = []
        for i in range(n):
            if not want[i]:
                continue
            row = []
            for j in range(i * ranks, (i + 1) * ranks):
                g = grads[j]
                if g is None:
                    shape, dtype, dev = ctx.meta[j]
                    g = torch.zeros(shape, dtype=dtype, device=dev)
                row.append(g.contiguous())
            cot.append(row)
        out: list = [None] * (n * ranks)
        if cot:
            ch = ctx.channel
            back = dataclasses.replace(ch, perm=inverse_perm(ch.perm),
                                       name=f"{ch.name}.grad")
            recv = back.put(*cot).wait()
            recv = (recv,) if len(cot) == 1 else recv
            it = iter(recv)
            for i in range(n):
                if want[i]:
                    out[i * ranks:(i + 1) * ranks] = next(it)
        return (None, None, None, None, *out)


def put_with_grad(channel, issue, tensors: Sequence[Sequence[torch.Tensor]]):
    """The put of ``tensors`` through ``Put``: its ``InFlight`` handle,
    whose payload is the receive buffers with ``Put``'s backward as their
    gradient function."""
    if any(t.dtype in FP8 for ranks in tensors for t in ranks):
        raise NotImplementedError(
            "a put with an fp8 wire has no gradient: train with "
            "a2a_wire_dtype=None")
    n, handle = len(tensors), []
    flat = Put.apply(issue, channel, n, handle,
                     *(t for ranks in tensors for t in ranks))
    ranks = len(tensors[0])
    payload = tuple(list(flat[i * ranks:(i + 1) * ranks]) for i in range(n))
    return dataclasses.replace(handle[0], payload=payload)
