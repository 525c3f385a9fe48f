"""The put kernels of the channel layer (counterpart of
``src/repro/comm/pallas_backend.py``): K3 ``remote_put`` and K4
``landing_copy``, hand-written in CUDA (``csrc/one_sided.cu``), with the
signal words and the side stream they use.

    put     -> the copies, issued on a side stream (channel.issue).
    signal  -> each copied tensor's signal word, release-stored with the
               put's epoch once its bytes have landed (the NVSHMEM signal
               / the TPU's DMA semaphore); the event after the launch is
               what the consuming stream waits on.
    wait    -> the consuming stream waits on that event (InFlight.wait).

``deliver`` keeps the reference's branch rule (``pallas_backend.py:180``):

  * a single-axis route with ``interpret=False`` takes the direct put, K3:
    one launch copies every rank's tensors into the receive buffers of
    ``perm[r]`` and signals each (destination, tensor);
  * every other route takes the emulation branch: the transport moves the
    bytes between rank buffers with a plain copy (the counterpart of the
    reference's ``lax.ppermute``, which is no Pallas kernel either), then
    K4 delivers them into the receive buffers, with one completion flag
    per tensor.

Each launch covers all ranks of the route (one launch per put).  On the
CPU, plain versions of K3 and K4 deliver the same values and set the same
signal words.  The signal words and block counters live in a per-device
``SymmetricHeap``: on one device every rank's words are in one tensor.
"""
from __future__ import annotations

import ctypes
import itertools
from typing import Sequence

import torch

from . import trace as _trace
from .channel import RankList, dest_table, issue, receive_buffers

__all__ = ["BACKENDS", "SymmetricHeap", "deliver", "existing_heap",
           "fused_transfer_events", "heap_for", "landing_copy", "launch_count",
           "new_sem", "remote_put", "reset_launch_count", "reset_signals"]

BACKENDS = ("xla", "pallas")
MAX_ENTRIES = 96  # ranks x tensors of one K3/K4 launch (csrc/one_sided.cu)
SIGNAL_WORDS = 128  # per signal row of the heap

_sem_counter = itertools.count()
_launches = {"remote_put": 0, "landing_copy": 0}


def new_sem(channel_name: str, stage: int) -> str:
    """Mint a unique semaphore id for one put (trace bookkeeping)."""
    return f"{channel_name}.s{stage}#{next(_sem_counter)}"


def launch_count(name: str) -> int:
    """CUDA launches of ``name`` ("remote_put" | "landing_copy") since the
    last reset."""
    return _launches[name]


def reset_launch_count() -> None:
    for name in _launches:
        _launches[name] = 0


class SymmetricHeap:
    """Per-device state of the one-sided puts: signal words (one row per
    kind of put: the fused ring put K2, K3 and K4), the block counters the
    kernels keep at zero, the epoch counter, and the side stream the puts
    run on.  All ranks of a mesh share one device, hence one heap."""

    ROWS = {"fused": 0, "remote_put": 1, "landing_copy": 2}

    def __init__(self, device: torch.device):
        self.device = device
        # the heap outlives the call that makes it: a heap first made under
        # inference mode (a served step) must still take in-place writes
        # outside it
        with torch.inference_mode(False):
            self.signals = torch.zeros((len(self.ROWS), SIGNAL_WORDS),
                                       dtype=torch.int32, device=device)
            self.arrive = torch.zeros_like(self.signals)
        self.epoch = 0
        self._side = None
        # while a step is captured: (row, start, n, epoch) of every put
        self.log: list | None = None

    def next_epoch(self) -> int:
        """A fresh epoch for one put (eager steps never reset the words; a
        captured step zeroes them at its start, serving/graphs.py)."""
        self.epoch = self.epoch % (2**31 - 1) + 1
        return self.epoch

    def words(self, kind: str, start: int = 0, n: int = 1,
              epoch: int | None = None):
        """``n`` signal words of row ``kind`` and their block counters, for
        a put of ``epoch``."""
        if start + n > SIGNAL_WORDS:
            raise ValueError(f"{start + n} signal words > {SIGNAL_WORDS}")
        row = self.ROWS[kind]
        if self.log is not None and epoch is not None:
            self.log.append((row, start, n, epoch))
        return (self.signals[row, start:start + n],
                self.arrive[row, start:start + n])

    def side_stream(self):
        """The stream puts run on (CUDA only; None on the CPU)."""
        if self.device.type != "cuda":
            return None
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        return self._side


_heaps: dict[torch.device, SymmetricHeap] = {}


def _key(device: torch.device) -> torch.device:
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def heap_for(device: torch.device) -> SymmetricHeap:
    """The heap of ``device``, made on first use."""
    device = _key(device)
    heap = _heaps.get(device)
    if heap is None:
        heap = _heaps[device] = SymmetricHeap(device)
    return heap


def existing_heap(device: torch.device) -> SymmetricHeap | None:
    """The heap of ``device`` if one was made."""
    return _heaps.get(_key(device))


def reset_signals(device: torch.device) -> None:
    """Zero every signal word of ``device``'s heap (none made: nothing to
    do).  A captured step runs this first, as a memset node."""
    heap = existing_heap(device)
    if heap is not None:
        heap.signals.zero_()


# ---------------------------------------------------------------------------
# K3 / K4: wrappers, plain versions, launches
# ---------------------------------------------------------------------------

def _check_entries(src: Sequence[Sequence[torch.Tensor]],
                   dst: Sequence[Sequence[torch.Tensor]],
                   to: Sequence[int]) -> torch.device:
    ranks, tensors = len(src), len(src[0])
    if ranks * tensors > MAX_ENTRIES:
        raise ValueError(f"{ranks} ranks x {tensors} tensors > {MAX_ENTRIES} "
                         "entries of one launch")
    dev = src[0][0].device
    for r in range(ranks):
        if len(src[r]) != tensors or len(dst[r]) != tensors:
            raise ValueError("every rank puts the same number of tensors")
        for i in range(tensors):
            s, d = src[r][i], dst[to[r]][i]
            if s.device != dev or d.device != dev:
                raise ValueError(f"rank {r} tensor {i} is not on {dev}")
            if s.dtype != d.dtype or s.shape != d.shape:
                raise ValueError(f"rank {r} tensor {i}: {s.dtype}{tuple(s.shape)}"
                                 f" into {d.dtype}{tuple(d.shape)}")
            if not (s.is_contiguous() and d.is_contiguous()):
                raise ValueError(f"rank {r} tensor {i} must be contiguous")
    return dev


def _bound_library() -> ctypes.CDLL:
    from ..kernels import _build

    lib = _build.load("one_sided")
    if lib.remote_put.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.remote_put.argtypes = [i, i, p, p, p, p, p, p, ctypes.c_uint, p]
        lib.remote_put.restype = i
        lib.landing_copy.argtypes = [i, i, p, p, p, p, p, ctypes.c_uint, p]
        lib.landing_copy.restype = i
        lib.one_sided_error_string.argtypes = [i]
        lib.one_sided_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, src, dst, perm: Sequence[int] | None, signal, arrive,
            epoch: int) -> None:
    ranks, tensors = len(src), len(src[0])
    n = ranks * tensors
    flat_src = [t for r in src for t in r]
    flat_dst = [t for r in dst for t in r]
    src_ptrs = (ctypes.c_void_p * n)(*(t.data_ptr() for t in flat_src))
    dst_ptrs = (ctypes.c_void_p * n)(*(t.data_ptr() for t in flat_dst))
    nbytes = (ctypes.c_longlong * n)(
        *(t.numel() * t.element_size() for t in flat_src))
    lib = _bound_library()
    dev = flat_src[0].device
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        common = (ranks, tensors, src_ptrs, dst_ptrs, nbytes)
        words = (ctypes.c_void_p(signal.data_ptr()),
                 ctypes.c_void_p(arrive.data_ptr()), epoch & 0xFFFFFFFF, stream)
        if name == "remote_put":
            table = (ctypes.c_int * ranks)(*perm)
            err = lib.remote_put(*common, table, *words)
        else:
            err = lib.landing_copy(*common, *words)
    if err != 0:
        msg = lib.one_sided_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")
    _launches[name] += 1


def remote_put_plain(src, dst, perm: Sequence[int], signal: torch.Tensor,
                     epoch: int) -> None:
    """K3 in plain PyTorch: the same copies and signal words."""
    tensors = len(src[0])
    for r, ranks in enumerate(src):
        for i, t in enumerate(ranks):
            dst[perm[r]][i].copy_(t)
            signal[perm[r] * tensors + i] = epoch


def remote_put(src: Sequence[Sequence[torch.Tensor]],
               dst: Sequence[Sequence[torch.Tensor]], perm: Sequence[int],
               *, signal: torch.Tensor, arrive: torch.Tensor,
               epoch: int) -> None:
    """K3: ``src[r][i]`` (rank r's tensor i) into ``dst[perm[r]][i]``, the
    receive buffer of rank ``perm[r]``, in one launch; then
    ``signal[perm[r] * n + i] = epoch``.  ``arrive`` holds as many zeroed
    words, which the kernel leaves at zero."""
    ranks = len(src)
    if sorted(perm) != list(range(ranks)):
        raise ValueError(f"perm {list(perm)} is not a permutation")
    dev = _check_entries(src, dst, perm)
    words = ranks * len(src[0])
    if signal.numel() < words or arrive.numel() < words:
        raise ValueError(f"{words} signal words needed")
    if dev.type == "cpu":
        return remote_put_plain(src, dst, perm, signal, epoch)
    if dev.type != "cuda":
        raise ValueError(f"remote_put runs on cpu or cuda, not {dev}")
    _launch("remote_put", src, dst, perm, signal, arrive, epoch)


def landing_copy_plain(src, dst, signal: torch.Tensor, epoch: int) -> None:
    """K4 in plain PyTorch: the same copies and completion flags."""
    tensors = len(src[0])
    for r, ranks in enumerate(src):
        for i, t in enumerate(ranks):
            dst[r][i].copy_(t)
            signal[r * tensors + i] = epoch


def landing_copy(src: Sequence[Sequence[torch.Tensor]],
                 dst: Sequence[Sequence[torch.Tensor]], *,
                 signal: torch.Tensor, arrive: torch.Tensor,
                 epoch: int) -> None:
    """K4: each received tensor ``src[r][i]`` into its delivered buffer
    ``dst[r][i]``, all in one launch, with the completion flag
    ``signal[r * n + i] = epoch`` per tensor."""
    ranks = len(src)
    dev = _check_entries(src, dst, range(ranks))
    words = ranks * len(src[0])
    if signal.numel() < words or arrive.numel() < words:
        raise ValueError(f"{words} signal words needed")
    if dev.type == "cpu":
        return landing_copy_plain(src, dst, signal, epoch)
    if dev.type != "cuda":
        raise ValueError(f"landing_copy runs on cpu or cuda, not {dev}")
    _launch("landing_copy", src, dst, None, signal, arrive, epoch)


# ---------------------------------------------------------------------------
# the channel's lowering
# ---------------------------------------------------------------------------

def deliver(
    tensors: Sequence[RankList],
    axes: tuple[str, ...],
    perm: Sequence[tuple[int, int]],
    *,
    interpret: bool = True,
    meta=None,
):
    """Move rank lists one hop along the route through the put kernels.

    Returns the receive buffers (one rank list per tensor), the event
    that signals their completion (None on the CPU) and the tensors the
    caller's handle holds until its wait (see ``channel.issue``).  The caller
    (Channel.put) owns the trace events and the profiler's leg ``meta``;
    this function owns the branch.
    """
    tensors = tuple(tensors)
    n, ranks = len(tensors), len(tensors[0])
    dev = tensors[0][0].device
    heap = heap_for(dev)
    to = dest_table(perm, ranks)  # to[s]: the rank that receives rank s's
    src = [[tensors[i][r].contiguous() for i in range(n)] for r in range(ranks)]
    recv = receive_buffers([[src[r][i] for r in range(ranks)]
                            for i in range(n)], to)
    by_rank = [[recv[i][r] for i in range(n)] for r in range(ranks)]
    epoch = heap.next_epoch()
    touched = [t for row in src + by_rank for t in row]
    if not interpret and len(axes) == 1:
        signal, arrive = heap.words("remote_put", 0, ranks * n, epoch)

        def work():
            remote_put(src, by_rank, to, signal=signal, arrive=arrive,
                       epoch=epoch)
    else:
        # emulation branch: the transport moves the bytes, K4 lands them
        moved = [[torch.empty_like(src[s][i]) for i in range(n)]
                 for s in range(ranks)]
        moved_at = [None] * ranks  # moved_at[d]: what rank d received
        for s in range(ranks):
            moved_at[to[s]] = moved[s]
        touched += [t for row in moved for t in row]
        signal, arrive = heap.words("landing_copy", 0, ranks * n, epoch)

        def work():
            for s in range(ranks):
                for i in range(n):
                    moved[s][i].copy_(src[s][i])
            landing_copy(moved_at, by_rank, signal=signal, arrive=arrive,
                         epoch=epoch)
    event, keep = issue(dev, heap.side_stream(), work, touched, meta)
    return recv, event, keep


def fused_transfer_events(
    channel,
    shape: tuple[int, ...],
    n_tensors: int,
    *,
    overlaps: str,
) -> str:
    """Record the schedule of a put a fused kernel performed (K2): the
    kernel copies the chunk while it computes, so the event sequence is
    put -> signal at completion; InFlight.wait emits the matching wait and
    the ring schedule marks the compute in between.  Returns the minted
    semaphore id."""
    sem = new_sem(channel.name, channel.stage)
    _trace.emit(_trace.TransferEvent(
        stream=channel.stream, channel=channel.name, stage=channel.stage,
        axes=tuple(channel.axes), perm=tuple(channel.perm),
        shape=tuple(shape), n_tensors=n_tensors,
        overlaps=overlaps, backend="pallas"))
    _trace.emit_sem(_trace.SemEvent(
        kind="put", sem=sem, stream=channel.stream, channel=channel.name,
        stage=channel.stage, overlap=True))
    return sem
