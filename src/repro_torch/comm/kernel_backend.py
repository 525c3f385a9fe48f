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

On a process mesh (launch/procs.py) the heap is carved from this
process's slab, and the peers' slabs are mapped beside it (CUDA IPC on
the card, shared memory on the CPU).  ``deliver_procs`` then lowers a put
over the ranks this process owns.  Who owns an entry of a rank list is
the list's owner map (``launch.mesh.OwnerMap``, the channel's
``owners``): the entry stands for a point of the mesh, found from its
coordinates on the list's axes and this process's own on the others, and
that point's process owns it, at a slot among its entries.  Receive
buffers and signal words come from a bump allocator whose offsets every
process computes alike, so a sender writes into the receiver's buffer at
an address it knows before the receiver allocates.  K3 runs once per
owned source rank and writes into the peer's slab; on the emulation
branch the transport copy writes into the peer's slab and the receiver's
K4 lands it there; the consumer waits on the signal words in its own
heap (``wait_words``: a stream wait on the card, a spin with a deadline
on the CPU).  The allocator restarts at a step fence (``process_step``),
which brackets every group of puts: an SP attention call, a gather, a
displaced forward's hand-offs, a cfg exchange.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import itertools
import time
from typing import Sequence

import torch

from . import trace as _trace
from ..kernels.ref import PLAIN_DEVICES
from .channel import RankList, dest_table, issue, receive_buffers

__all__ = ["BACKENDS", "SymmetricHeap", "deliver", "deliver_procs",
           "existing_heap", "fused_slots", "fused_transfer_events", "heap_for",
           "install_heap", "landing_copy", "launch_count", "new_sem",
           "process_step", "remote_put", "reset_launch_count",
           "reset_signals", "uninstall_heap"]

BACKENDS = ("xla", "pallas")
MAX_ENTRIES = 96  # ranks x tensors of one K3/K4 launch (csrc/one_sided.cu)
SIGNAL_WORDS = 128  # per signal row of the heap
# a slab's head (int32 words): one step-fence word per process, then the
# signal and arrive rows, then the words the puts of a step allocate
FENCE_WORDS = 64
STEP_WORDS = 16384
ALIGN = 256  # bytes: every buffer of a slab starts on it (TMA wants 16)

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
    run on.  All ranks of a mesh of virtual ranks share one device, hence
    one heap.

    With ``slabs`` (a process mesh: one uint8 tensor per process, this
    process's own at ``process``, the peers' mapped) the words are carved
    from the head of this process's slab and the rest is a bump allocator
    of receive buffers; offsets are the same in every slab.  ``deadline``
    bounds a wait on the CPU."""

    ROWS = {"fused": 0, "remote_put": 1, "landing_copy": 2}

    def __init__(self, device: torch.device,
                 slabs: Sequence[torch.Tensor] | None = None,
                 process: int = 0, deadline: float = 600.0):
        self.device = device
        self.slabs = list(slabs) if slabs is not None else None
        self.process = process
        self.procs = 1 if slabs is None else len(slabs)
        self.deadline = deadline
        shape = (len(self.ROWS), SIGNAL_WORDS)
        # the heap outlives the call that makes it: a heap first made under
        # inference mode (a served step) must still take in-place writes
        # outside it
        with torch.inference_mode(False):
            if self.slabs is None:
                self.signals = torch.zeros(shape, dtype=torch.int32,
                                           device=device)
                self.arrive = torch.zeros_like(self.signals)
            else:
                rows = len(self.ROWS) * SIGNAL_WORDS
                self.fence = self.words_at(process, 0, FENCE_WORDS)
                self.signals = self.words_at(
                    process, FENCE_WORDS, rows).view(shape)
                self.arrive = self.words_at(
                    process, FENCE_WORDS + rows, rows).view(shape)
                self._words0 = FENCE_WORDS + 2 * rows
                self._bytes0 = -(-4 * (self._words0 + STEP_WORDS)
                                 // ALIGN) * ALIGN
                if self.slabs[process].numel() <= self._bytes0:
                    raise ValueError("a slab must be larger than "
                                     f"{self._bytes0} bytes")
                if self.procs > FENCE_WORDS:
                    raise ValueError(f"{self.procs} processes > "
                                     f"{FENCE_WORDS} fence words")
                self.steps = 0
                self._next_word = self._words0
                self._next_byte = self._bytes0
                self.high_water = 0  # the most bytes one step allocated
                # a list: every allocation's (kind, offset), in order
                self.trace: list | None = None
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

    # -- a process mesh's symmetric heap ------------------------------------
    def words_at(self, process: int, index: int, n: int) -> torch.Tensor:
        """``n`` int32 words from word ``index`` of ``process``'s slab."""
        return self.slabs[process][4 * index:4 * (index + n)].view(
            torch.int32)

    def alloc_words(self, n: int) -> int:
        """The index of ``n`` fresh signal words of this step (the same in
        every process).  They only ever hold epochs, which grow, so a word
        reused by a later step needs no reset."""
        index = self._next_word
        if index + n > self._words0 + STEP_WORDS:
            raise RuntimeError(f"a step's puts need more than {STEP_WORDS} "
                               "signal words")
        self._next_word += n
        if self.trace is not None:
            self.trace.append(("words", index))
        return index

    def alloc(self, like: torch.Tensor) -> int:
        """The offset of a fresh buffer shaped like ``like`` (the same in
        every process)."""
        nbytes = like.numel() * like.element_size()
        off = self._next_byte
        end = off + -(-nbytes // ALIGN) * ALIGN
        if end > self.slabs[self.process].numel():
            raise RuntimeError(
                f"the heap's slab of {self.slabs[self.process].numel()} bytes "
                f"cannot hold this step's puts ({end} bytes so far): give "
                "the launcher a larger slab")
        self._next_byte = end
        self.high_water = max(self.high_water, end)
        if self.trace is not None:
            self.trace.append(("buffer", off))
        return off

    def buffer(self, process: int, off: int,
               like: torch.Tensor) -> torch.Tensor:
        """The buffer at ``off`` of ``process``'s slab, shaped like
        ``like``."""
        nbytes = like.numel() * like.element_size()
        return self.slabs[process][off:off + nbytes].view(like.dtype).view(
            like.shape)

    def begin_step(self) -> None:
        """The step fence's wait: before this step's first put, every peer
        has consumed the steps before (their receive buffers are free to
        overwrite); then the allocator starts over."""
        if self.steps:
            self.wait_words([self.fence[q:q + 1] for q in range(self.procs)
                             if q != self.process], self.steps)
        self._next_word, self._next_byte = self._words0, self._bytes0

    def end_step(self) -> None:
        """The step fence's signal: once everything this process enqueued
        (its reads of the step's receive buffers included) has run, tell
        every peer so."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).wait_stream(
                self.side_stream())
        self.steps += 1
        for q in range(self.procs):
            if q != self.process:
                self.write_words(self.words_at(q, self.process, 1),
                                 self.steps)

    def wait_words(self, words: Sequence[torch.Tensor], value: int) -> None:
        """Until every word holds ``value`` or a later epoch: on CUDA the
        current stream waits (cuStreamWaitValue32, no host wait and no
        spinning block); on the CPU the host spins, up to the deadline."""
        value &= 0xFFFFFFFF
        if self.device.type == "cuda":
            lib = _bound_library()
            stream = ctypes.c_void_p(
                torch.cuda.current_stream(self.device).cuda_stream)
            for w in words:
                for i in range(w.numel()):
                    _check_stream_op("signal_wait_on_stream",
                                     lib.signal_wait_on_stream(
                                         w.data_ptr() + 4 * i, value, stream))
            return
        until = time.monotonic() + self.deadline
        for w in words:
            # (int32)(word - value) >= 0: epochs wrap as the kernels' do
            while any(((int(x) - value) & 0xFFFFFFFF) >= 2**31
                      for x in w.tolist()):
                if time.monotonic() > until:
                    raise TimeoutError(
                        f"process {self.process}: a signal word never "
                        f"reached {value} in {self.deadline} s")
                time.sleep(1e-4)

    def write_words(self, words: torch.Tensor, value: int) -> None:
        """Store ``value`` into ``words`` once what the current stream has
        issued before is done (cuStreamWriteValue32 behind its memory
        barrier on CUDA; at once on the CPU, where the copies are done)."""
        if self.device.type == "cuda":
            lib = _bound_library()
            stream = ctypes.c_void_p(
                torch.cuda.current_stream(self.device).cuda_stream)
            for i in range(words.numel()):
                _check_stream_op("signal_write_on_stream",
                                 lib.signal_write_on_stream(
                                     words.data_ptr() + 4 * i,
                                     value & 0xFFFFFFFF, stream))
            return
        words.fill_(value)


def _check_stream_op(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(
            f"{name} failed (CUresult {err}): the device refuses stream "
            "memory operations, which a process mesh needs")


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


def install_heap(heap: SymmetricHeap) -> None:
    """Make ``heap`` its device's heap (launch/procs.py installs each
    worker's slab heap before the job runs)."""
    _heaps[_key(heap.device)] = heap


def uninstall_heap(device: torch.device) -> None:
    """Forget ``device``'s heap (a worker, before it lets go of the
    peers' slabs)."""
    _heaps.pop(_key(device), None)


def process_heap(device: torch.device) -> SymmetricHeap | None:
    """The heap of ``device`` when it is a process mesh's, else None."""
    heap = _heaps.get(_key(device))
    return heap if heap is not None and heap.procs > 1 else None


@contextlib.contextmanager
def process_step(device: torch.device):
    """Bracket one step of puts (an SP attention call, a gather, a
    displaced forward's hand-offs, a cfg exchange) with the step fence of
    a process mesh's heap; a no-op on a mesh of virtual ranks."""
    heap = process_heap(device)
    if heap is None:
        yield
        return
    heap.begin_step()
    yield
    heap.end_step()


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
        for entry in (lib.signal_wait_on_stream, lib.signal_write_on_stream):
            entry.argtypes = [p, ctypes.c_uint, p]
            entry.restype = i
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
    if dev.type in PLAIN_DEVICES:
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
    if dev.type in PLAIN_DEVICES:
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


def _owned_sources(owners, tensors: Sequence[RankList]):
    """This process's entries of the rank lists (``owners.owned``) and
    their contiguous tensors; every rank's tensor i has one shape, which
    the symmetric offsets rely on."""
    if owners is None:
        raise ValueError("a put on a process mesh needs its rank list's "
                         "owner map (launch.mesh.OwnerMap)")
    size = len(tensors[0])
    owned = owners.owned
    held = [p for p, x in enumerate(tensors[0]) if x is not None]
    if size != owners.size or held != list(owned):
        raise ValueError(f"a rank list of {size} entries holding {held} "
                         f"against the owner map over {owners.axes} "
                         f"({owners.size} entries, this process's {owned})")
    src = {s: [t[s].contiguous() for t in tensors] for s in owned}
    like = src[owned[0]]
    for s in owned:
        for a, b in zip(src[s], like):
            if a.shape != b.shape or a.dtype != b.dtype:
                raise ValueError("a process mesh puts equal shards: rank "
                                 f"{s} has {a.dtype}{tuple(a.shape)}, rank "
                                 f"{owned[0]} {b.dtype}{tuple(b.shape)}")
    return owned, src, like


def deliver_procs(tensors: Sequence[RankList], perm, *, owners,
                  lowering: str, meta=None):
    """One put on a process mesh, over the entries this process owns.

    ``owners`` is the rank list's owner map: entry d of the list belongs
    to process ``owners.owner(d)[0]``, at that slot.  ``lowering`` is
    ``"copy"`` (a plain copy into the peer's buffer and a signal word
    written behind it: the "xla" backend), ``"remote_put"`` (K3, one
    launch per owned source rank, into the peer's buffer and signal
    words) or ``"landing_copy"`` (the transport copies into the peer's
    slab and signals; each process's K4 lands what it received there,
    one launch per put, and signals its own words).  Every process runs
    the same puts in the same order, so they allocate the same slots: per
    tensor one receive buffer per owned entry, then n words per owned
    entry.  Returns the receive buffers (rank lists, None for the entries
    other processes own), the signal words this process waits on, the
    put's epoch and what the handle must hold."""
    tensors = tuple(tensors)
    n, size = len(tensors), len(tensors[0])
    dev = next(t for t in tensors[0] if t is not None).device
    heap = process_heap(dev)
    owned, src, like = _owned_sources(owners, tensors)
    k, me = len(owned), heap.process
    to = dest_table(perm, size)

    def slots():  # [i][slot] -> offset, the same in every slab
        return [[heap.alloc(like[i]) for _ in range(k)] for i in range(n)]

    recv_off, words = slots(), heap.alloc_words(k * n)
    moved_off = moved_words = None
    if lowering == "landing_copy":
        moved_off, moved_words = slots(), heap.alloc_words(k * n)
    epoch = heap.next_epoch()
    recv = [[None] * size for _ in range(n)]
    for j, d in enumerate(owned):
        for i in range(n):
            recv[i][d] = heap.buffer(me, recv_off[i][j], like[i])
    mine = heap.words_at(me, words, k * n)

    def peer(s, offs, base):
        """Rank s's destination buffers and signal words, in the slab of
        the process that owns ``to[s]``."""
        q, j = owners.owner(to[s])
        return ([heap.buffer(q, offs[i][j], like[i]) for i in range(n)],
                heap.words_at(q, base + j * n, n))

    def work():
        if lowering == "remote_put":
            arrive = heap.arrive[heap.ROWS["remote_put"], :n]
            for s in owned:
                dst, sig = peer(s, recv_off, words)
                remote_put([src[s]], [dst], [0], signal=sig, arrive=arrive,
                           epoch=epoch)
            return
        offs, base = ((recv_off, words) if lowering == "copy"
                      else (moved_off, moved_words))
        for s in owned:
            dst, sig = peer(s, offs, base)
            for a, b in zip(dst, src[s]):
                a.copy_(b)
            heap.write_words(sig, epoch)
        if lowering == "copy":
            return
        # what this process received, landed by its own K4
        heap.wait_words([heap.words_at(me, moved_words, k * n)], epoch)
        moved = [[heap.buffer(me, moved_off[i][j], like[i]) for i in range(n)]
                 for j in range(k)]
        landing_copy(moved, [[recv[i][d] for i in range(n)] for d in owned],
                     signal=mine,
                     arrive=heap.arrive[heap.ROWS["landing_copy"], :k * n],
                     epoch=epoch)

    touched = [t for row in src.values() for t in row]
    _, keep = issue(dev, heap.side_stream(), work, touched, meta)
    return recv, mine, epoch, keep


@dataclasses.dataclass
class FusedSlots:
    """The receive buffers and signal words of one fused ring put (K2):
    ``k`` / ``v`` by destination rank (what the launches write into),
    ``payload`` what this process's ranks receive, ``flag(p)`` rank p's
    completion word and block counter, ``words`` what this process waits
    on (none on a mesh of virtual ranks: K2 runs on the consuming
    stream)."""

    k: list
    v: list
    payload: tuple
    flag: object
    words: object = None


def fused_slots(kc: RankList, vc: RankList, dst: Sequence[int],
                epoch: int, owners=None) -> FusedSlots:
    """Receive buffers and words for one fused ring step whose source
    rank p sends to ``dst[p]``: fresh buffers and the heap's "fused" row
    on a mesh of virtual ranks; on a process mesh, symmetric slots, the
    destinations in the slab of the process that owns the next ring rank
    (``owners``, the rank list's owner map)."""
    dev = next(t for t in kc if t is not None).device
    heap = process_heap(dev)
    if heap is None:
        k_recv = [torch.empty_like(t) for t in kc]
        v_recv = [torch.empty_like(t) for t in vc]
        base = heap_for(dev)
        return FusedSlots(k_recv, v_recv, (k_recv, v_recv),
                          lambda p: base.words("fused", dst[p], epoch=epoch))
    size = len(kc)
    owned, _, (k_like, v_like) = _owned_sources(owners, (kc, vc))
    n, me = len(owned), heap.process
    k_off = [heap.alloc(k_like) for _ in range(n)]
    v_off = [heap.alloc(v_like) for _ in range(n)]
    words = heap.alloc_words(n)
    k_recv, v_recv = [None] * size, [None] * size
    for d in sorted({dst[p] for p in owned} | set(owned)):
        q, j = owners.owner(d)
        k_recv[d] = heap.buffer(q, k_off[j], k_like)
        v_recv[d] = heap.buffer(q, v_off[j], v_like)
    payload = tuple([x if x is not None and owners.owner(d)[0] == me
                     else None for d, x in enumerate(xs)]
                    for xs in (k_recv, v_recv))

    def flag(p):
        q, j = owners.owner(dst[p])
        i = owners.owner(p)[1]
        return (heap.words_at(q, words + j, 1),
                heap.arrive[heap.ROWS["fused"], i:i + 1])

    return FusedSlots(k_recv, v_recv, payload, flag,
                      heap.words_at(me, words, n))


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
