"""One-sided channel primitive (counterpart of ``src/repro/comm/channel.py``):
NVSHMEM put/signal/wait over the virtual ranks of a mesh.

The paper moves every tensor with one-sided NVSHMEM puts: the sender
writes straight into the receiver's buffer, sets a signal flag, and the
receiver waits on the flag only when it needs the data.  Here every rank
of the group lives in this process on one device, so a put's payload is a
**rank list** — one tensor per rank of the group, in flat-rank order — and
the put delivers rank ``s``'s tensor into the receive buffer of rank
``perm[s]``:

    put     -> the copies are issued on a side CUDA stream, so they run
               beside the compute that follows on the current stream.
               ``backend="xla"``: a plain copy per rank (the counterpart of
               ``lax.ppermute``).  ``backend="pallas"``: the hand-written
               put kernels of comm/kernel_backend.py (K3 or K4).
    signal  -> a CUDA event recorded on the side stream after the copies
               (the kernels also release-store per-tensor signal words).
    wait    -> the consuming stream waits on that event; the host never
               synchronises inside a schedule.

On the CPU everything runs in program order and there is no event.

A ``Channel`` is a fixed (mesh axes, permutation) route; every ``put``
returns an ``InFlight`` handle whose payload is the receive buffers.
Streams (stream.py) compose channels into staged transfer programs;
trace.py records every put, wait and signal for ``validate`` and
``validate_semaphores``, and under an active profiler (profiler.py) each
put is one leg observed at its issue, signal and wait.  Under a gradient
a put is differentiable (grad.py): its backward is a put of the
cotangents along the inverse route, through the same lowering.

On a process mesh (launch/procs.py) each process holds the tensors of the
ranks it owns, and a rank list holds None for the others.  Which process
owns an entry is the channel's ``owners`` (launch.mesh.OwnerMap): the
entry stands for the mesh point at its coordinates on the list's axes and
this process's own on the other axes, which need not be the route's axes
(a sliced SP list spans the batch axes too, the pipe hand-off's list the
batch axes and the pipe axis).  A put then writes into the receive
buffers of the owning peer process, mapped into this one
(kernel_backend.deliver_procs), and the wait is on the signal words in
this process's own heap at the put's epoch.  Across cards (NVLink,
InfiniBand) that path is ROADMAP Queue 1 item 8.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch

from . import profiler as _profiler
from . import trace as _trace

__all__ = ["Channel", "InFlight", "RankList", "fence", "first",
           "owned_ranks", "pin", "rank_map", "ring_perm_of", "shift_perm"]

RankList = list  # list[torch.Tensor]: one tensor per rank, flat-rank order


def first(xs: RankList) -> torch.Tensor:
    """The first tensor of a rank list that this process holds."""
    return next(x for x in xs if x is not None)


def owned_ranks(xs: RankList) -> list[int]:
    """The ranks of a rank list whose tensors this process holds: every
    rank on a mesh of virtual ranks; on a process mesh its own (the
    entries of the ranks other processes own are None)."""
    return [p for p, x in enumerate(xs) if x is not None]


def rank_map(f: Callable, *xs: RankList) -> RankList:
    """``f`` over the held ranks of rank lists (rank by rank), None where
    another process holds the rank."""
    return [None if a[0] is None else f(*a) for a in zip(*xs)]


def shift_perm(size: int, shift: int = 1) -> tuple[tuple[int, int], ...]:
    """Rotation permutation: rank r -> (r + shift) % size."""
    return tuple((r, (r + shift) % size) for r in range(size))


def ring_perm_of(layout: Any, shift: int = 1) -> tuple[tuple[int, int], ...]:
    """The layout's intra-ring rotation as a hashable perm table."""
    return tuple(layout.ring_perm(shift))


def dest_table(perm: Sequence[tuple[int, int]], size: int) -> list[int]:
    """perm pairs as a table: entry s is the destination of rank s.  The
    route must be a permutation of ``range(size)``."""
    tbl = [-1] * size
    for s, d in perm:
        tbl[s] = d
    if sorted(tbl) != list(range(size)):
        raise ValueError(f"route {tuple(perm)} is not a permutation of "
                         f"{size} ranks")
    return tbl


def receive_buffers(tensors: Sequence[RankList],
                    dst: Sequence[int]) -> tuple[RankList, ...]:
    """One empty receive buffer per (tensor, rank), shaped like what the
    rank receives, allocated on the current stream."""
    out = []
    for ranks in tensors:
        recv: RankList = [None] * len(ranks)
        for s, t in enumerate(ranks):
            recv[dst[s]] = torch.empty(t.shape, dtype=t.dtype, device=t.device)
        out.append(recv)
    return tuple(out)


def issue(device: torch.device, side: "torch.cuda.Stream | None",
          work: Callable[[], None], touched: Sequence[torch.Tensor],
          meta: "_profiler.LegMeta | None" = None):
    """Run ``work`` (the copies of one put) on the side stream after what
    the current stream has issued so far.  Returns the event that signals
    its completion and the tensors the put's handle must hold until its
    wait.  Every tensor the copies touch was allocated on the current
    stream: ``record_stream`` keeps the allocator from reusing it while
    the copies run.  While a CUDA graph is being captured, record_stream
    would bar the memory from reuse for the rest of the capture, so the
    handle holds the tensors instead: the wait joins the side stream
    back, and only later work can reuse them.  On the CPU ``work`` runs
    now and there is no event.  With ``meta`` (an active profiler's leg),
    the put's issue is observed on the current stream where the side
    stream joins it, and its signal on the side stream after the
    copies."""
    prof = _profiler.active() if meta is not None else None
    if prof is not None:
        _profiler.mark(prof, meta, "issue", device)
    if device.type != "cuda":
        work()
        if prof is not None:
            _profiler.mark(prof, meta, "signal", device)
        return None, ()
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        work()
        if prof is not None:
            _profiler.mark(prof, meta, "signal", device)
        done = torch.cuda.Event()
        done.record(side)
    if torch.cuda.is_current_stream_capturing():
        return done, tuple(touched)
    for t in touched:
        t.record_stream(side)
    return done, ()


@dataclasses.dataclass(frozen=True)
class Channel:
    """A fixed one-sided route: ``put`` moves rank lists one hop along
    ``perm`` over the named mesh ``axes``.

    ``backend`` selects the lowering: ``"xla"`` (a plain copy per rank, the
    counterpart of ppermute) or ``"pallas"`` (the put kernels K3/K4 with
    signal words, comm/kernel_backend.py); ``interpret`` keeps the
    reference's meaning: only ``interpret=False`` on a single-axis route
    takes the direct put K3.
    """

    axes: tuple[str, ...]
    perm: tuple[tuple[int, int], ...]
    name: str = "chan"
    stream: str = ""  # owning Stream name (trace bookkeeping)
    stage: int = 0  # stage index within the stream program
    backend: str = "xla"  # "xla" | "pallas"
    interpret: bool = True
    owners: Any = None  # the rank list's OwnerMap on a process mesh

    def __post_init__(self):
        assert self.backend in ("xla", "pallas"), self.backend

    def _event(self, tensors: tuple[RankList, ...], overlaps: str,
               backend: str) -> _trace.TransferEvent:
        return _trace.TransferEvent(
            stream=self.stream, channel=self.name, stage=self.stage,
            axes=tuple(self.axes), perm=tuple(self.perm),
            shape=tuple(first(tensors[0]).shape), n_tensors=len(tensors),
            overlaps=overlaps, backend=backend)

    def put(self, *tensors: RankList, overlaps: str = "") -> "InFlight":
        """Issue the one-sided transfer of ``tensors`` (rank lists).

        Several tensors ride one put (K and V travel together).  The
        returned handle's payload is the receive buffers, one rank list per
        tensor: ``payload[i][perm[s]]`` holds ``tensors[i][s]``.  When a
        payload tensor wants a gradient, the put runs inside
        ``grad.Put``, whose backward puts the cotangents along the
        inverse route; otherwise nothing is added.
        """
        from . import grad as _grad

        if _grad.wants_grad(tensors):
            return _grad.put_with_grad(
                self, lambda ts: self._put(ts, overlaps), tensors)
        return self._put(tensors, overlaps)

    def _put(self, tensors: tuple[RankList, ...],
             overlaps: str) -> "InFlight":
        if self.backend == "pallas":
            return self._put_kernel(tensors, overlaps)
        from . import kernel_backend as _kb

        dev = first(tensors[0]).device
        if _kb.process_heap(dev) is not None:
            return self._put_procs(tensors, overlaps, "xla", "copy")
        dst = dest_table(self.perm, len(tensors[0]))
        recv = receive_buffers(tensors, dst)

        def work():
            for ranks, out in zip(tensors, recv):
                for s, t in enumerate(ranks):
                    out[dst[s]].copy_(t)

        touched = [t for ranks in tensors + recv for t in ranks]
        meta = self._leg_meta(tensors, overlaps, "xla")
        event, keep = issue(dev, _kb.heap_for(dev).side_stream(), work,
                            touched, meta)
        _trace.emit(self._event(tensors, overlaps, "xla"))
        put = _trace.emit_issue(_lowering(dev), dev.type)
        return InFlight(channel=self, payload=recv, event=event, meta=meta,
                        put=put, keep=keep)

    def _leg_meta(self, tensors: tuple[RankList, ...], overlaps: str,
                  backend: str) -> "_profiler.LegMeta | None":
        """The profiler's leg for one put, or None when no profiler is
        active (the zero-cost default)."""
        prof = _profiler.active()
        if prof is None:
            return None
        return prof.new_leg(
            kind="comm", stream=self.stream, channel=self.name,
            stage=self.stage, axes=tuple(self.axes),
            nbytes=_profiler.nbytes_of(tensors), n_tensors=len(tensors),
            backend=backend, intent=overlaps, ranks=len(tensors[0]),
            perm=tuple(self.perm))

    def _put_procs(self, tensors: tuple[RankList, ...], overlaps: str,
                   backend: str, lowering: str) -> "InFlight":
        """A put on a process mesh (kernel_backend.deliver_procs): the
        handle waits on the signal words in this process's heap."""
        from . import kernel_backend as _kb

        dev = first(tensors[0]).device
        sem = _kb.new_sem(self.name, self.stage) if backend == "pallas" else ""
        _trace.emit(self._event(tensors, overlaps, backend))
        put = _trace.emit_issue(_lowering(dev), dev.type)
        if sem:
            _trace.emit_sem(_trace.SemEvent(
                kind="put", sem=sem, stream=self.stream, channel=self.name,
                stage=self.stage))
        meta = self._leg_meta(tensors, overlaps, backend)
        out, words, epoch, keep = _kb.deliver_procs(
            tensors, tuple(self.perm), owners=self.owners, lowering=lowering,
            meta=meta)
        if sem:
            _trace.emit_sem(_trace.SemEvent(
                kind="signal", sem=sem, stream=self.stream,
                channel=self.name, stage=self.stage))
        return InFlight(channel=self, payload=tuple(out), sem=sem, meta=meta,
                        put=put, keep=keep, words=words, epoch=epoch)

    def _put_kernel(self, tensors: tuple[RankList, ...],
                    overlaps: str) -> "InFlight":
        """The put kernels' lowering: signal-tracked delivery."""
        from . import kernel_backend as _kb

        if _kb.process_heap(first(tensors[0]).device) is not None:
            direct = not self.interpret and len(self.axes) == 1
            return self._put_procs(tensors, overlaps, "pallas",
                                   "remote_put" if direct
                                   else "landing_copy")
        sem = _kb.new_sem(self.name, self.stage)
        _trace.emit(self._event(tensors, overlaps, "pallas"))
        dev = tensors[0][0].device
        put = _trace.emit_issue(_lowering(dev), dev.type)
        _trace.emit_sem(_trace.SemEvent(
            kind="put", sem=sem, stream=self.stream, channel=self.name,
            stage=self.stage))
        meta = self._leg_meta(tensors, overlaps, "pallas")
        out, event, keep = _kb.deliver(tensors, tuple(self.axes),
                                       tuple(self.perm),
                                       interpret=self.interpret, meta=meta)
        _trace.emit_sem(_trace.SemEvent(
            kind="signal", sem=sem, stream=self.stream, channel=self.name,
            stage=self.stage))
        return InFlight(channel=self, payload=out, sem=sem, event=event,
                        meta=meta, put=put, keep=keep)

    def put_fused(self, *tensors: RankList, launch: Callable[[], None],
                  overlaps: str = "", words: Any = None,
                  epoch: int = 0) -> "InFlight":
        """A put that a fused kernel (K2, kernels/ring_flash.py) performs:
        ``launch`` enqueues the kernels, whose blocks write the chunk
        straight into the receive buffers ``tensors`` of the destination
        ranks while they compute, on the current stream.  So there is
        nothing to copy — where the reference still needs a ppermute for
        the hop — and this records the schedule (a put flagged
        ``overlap=True``, whose wait the validator requires to follow a
        compute block), brackets ``launch`` with the leg's issue and signal
        observations, and hands the buffers on.  On a process mesh the
        buffers lie in the peers' heaps and ``words`` (this process's
        completion words, written by its ring predecessor's K2 at
        ``epoch``) are what the wait waits on."""
        assert self.backend == "pallas", "put_fused is a Pallas-path verb"
        from . import kernel_backend as _kb

        dev = first(tensors[0]).device
        meta = self._leg_meta(tensors, overlaps, "pallas")
        if meta is not None:
            _profiler.mark(_profiler.active(), meta, "issue", dev)
        sem = _kb.fused_transfer_events(
            self, tuple(first(tensors[0]).shape), len(tensors),
            overlaps=overlaps)
        put = _trace.emit_issue("kernel", dev.type)
        launch()
        _trace.emit_sem(_trace.SemEvent(
            kind="signal", sem=sem, stream=self.stream, channel=self.name,
            stage=self.stage))
        if meta is not None:
            _profiler.mark(_profiler.active(), meta, "signal", dev)
        return InFlight(channel=self, payload=tuple(tensors), sem=sem,
                        meta=meta, put=put, words=words, epoch=epoch)


def _lowering(device: torch.device) -> str:
    """Where a put's copies run: the side stream on CUDA, program order on
    the CPU (trace.HostOp)."""
    return "side" if device.type == "cuda" else "program"


@dataclasses.dataclass(frozen=True)
class InFlight:
    """Handle to a put in flight; ``payload`` is the receive buffers."""

    channel: Channel
    payload: tuple[RankList, ...]
    sem: str = ""  # semaphore id (kernel backend only)
    event: Any = None  # completion event on the side stream (CUDA only)
    meta: Any = None  # the profiler's leg (profiling only)
    put: int = -1  # the put's index in the recording trace (-1: none)
    # the put's tensors, held until the wait while a graph is captured
    keep: tuple = ()
    # process mesh: the signal words in this process's heap, and the
    # epoch they reach once the payload has landed
    words: Any = None
    epoch: int = 0

    def wait(self, *deps: Any) -> Any:
        """Signal-wait: the current stream waits for the put's completion.

        Returns the payload (unpacked when it is a single rank list); with
        ``deps``, ``(payload..., deps...)`` as the reference does.  Eager
        PyTorch issues work in program order, so the deps need no fence.
        """
        if self.sem:
            _trace.emit_sem(_trace.SemEvent(
                kind="wait", sem=self.sem, stream=self.channel.stream,
                channel=self.channel.name, stage=self.channel.stage))
        _trace.emit_wait(self.put)
        dev = first(self.payload[0]).device
        prof = _profiler.active()
        if self.meta is not None and prof is not None:
            # when the consumer needs the buffer: the current stream has
            # enqueued everything before this wait
            _profiler.mark(prof, self.meta, "wait", dev)
        if self.event is not None:
            torch.cuda.current_stream(dev).wait_event(self.event)
        if self.words is not None:
            from . import kernel_backend as _kb

            _kb.heap_for(dev).wait_words([self.words], self.epoch)
        if not deps:
            return self.payload[0] if len(self.payload) == 1 else self.payload
        if len(self.payload) == 1:
            return (self.payload[0], *deps)
        return (*self.payload, *deps)


def fence(tensors: Sequence[Any],
          deps: Sequence[Any]) -> tuple[tuple, tuple]:
    """Joint ordering point of the reference (an XLA optimization barrier).
    Eager PyTorch issues every op in program order on one stream, which
    already orders the consumer after the deps, so this returns its
    arguments unchanged."""
    return tuple(tensors), tuple(deps)


def pin(xs: Sequence[Any]) -> tuple:
    """Serialise a value chain across schedule steps: program order does it
    in eager PyTorch, so this returns its argument as a tuple."""
    return tuple(xs)
