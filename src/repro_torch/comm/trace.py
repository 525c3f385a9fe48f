"""Schedule recording and validation (counterpart of
``src/repro/comm/trace.py``).

The one-sided channel layer records the schedule it *intends*: every put,
its completion signal, every wait, and the compute blocks a fused put is
meant to overlap.  Two checks read the record:

  * ``validate_semaphores`` — the framework-free half of the reference
    (its lines 55-240, copied; ``tests/test_torch_copies.py`` pins the
    copy): each put signalled exactly once, no wait before its put, no
    blocking wait on a fused put.
  * ``validate`` — the counterpart of the reference's gate on the
    compiled HLO, checked on the recorded schedule of an eager program.
    Eager PyTorch compiles nothing: the order in which the host enqueues
    work IS the schedule, so the record also holds every put's issue,
    every ``InFlight.wait`` and every compute block
    (``profiler.mark_compute``) in host order (``host_ops``).  A put's
    route must be the reference's ppermute route (``expected_pairs``),
    and a put that declares an ``overlaps`` intent must have a compute
    block enqueued between its issue and its wait, and on CUDA run off
    the compute stream.

The reference's HLO parser (``parse_computations``,
``collective_permutes``, ``independent_compute``, ``_between_start_done``,
``HloInstr``) has no counterpart: there is no compiled program to parse.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Iterator

import numpy as np

__all__ = [
    "TransferEvent",
    "SemEvent",
    "ScheduleTrace",
    "record",
    "emit",
    "emit_sem",
    "mark_compute",
    "validate_semaphores",
    "SemReport",
    "HostOp",
    "host_ops",
    "emit_issue",
    "emit_wait",
    "emit_compute",
    "expected_pairs",
    "validate",
    "ValidationReport",
]


# ---------------------------------------------------------------------------
# schedule recording (trace-time side channel, active only under record())
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TransferEvent:
    """One intended transfer: a ``Channel.put`` observed at trace time."""

    stream: str  # owning Stream (or "" for a bare channel)
    channel: str  # channel name, e.g. "torus.pullq1"
    stage: int  # stage index within the stream program
    axes: tuple[str, ...]  # mesh axes the permute runs over
    perm: tuple[tuple[int, int], ...]  # logical (src, dst) pairs on ``axes``
    shape: tuple[int, ...]  # per-device payload shape (first tensor)
    n_tensors: int  # tensors moved by this put (k and v travel together)
    overlaps: str  # label of the compute this transfer should hide behind
    backend: str = "xla"  # lowering that issued the put ("xla" | "pallas")


@dataclasses.dataclass(frozen=True)
class SemEvent:
    """One semaphore-protocol step of the Pallas lowering (DESIGN.md §8.1).

    The Pallas backend realises put/signal/wait with explicit semaphores
    (DMA completion + REGULAR flags) instead of XLA data dependencies, so
    the schedule becomes a sequence of discrete protocol steps that can be
    checked for well-formedness independently of HLO:

        put     — the async (remote) copy is issued (rdma.start())
        signal  — the completion semaphore fires (DMA done / remote flag)
        wait    — the consumer blocks on the semaphore
        compute — a compute block consumed between issue and wait (the
                  overlap the fused kernel provides; emitted by the kernel
                  wrappers, not by bare channels)
    """

    kind: str  # "put" | "signal" | "wait" | "compute"
    sem: str  # semaphore id ("" for compute markers)
    stream: str = ""
    channel: str = ""
    stage: int = 0
    overlap: bool = False  # put declared in-kernel overlap (fused path)


@dataclasses.dataclass
class ScheduleTrace:
    """The recorded intent of one traced program."""

    name: str
    events: list[TransferEvent] = dataclasses.field(default_factory=list)
    sem_events: list[SemEvent] = dataclasses.field(default_factory=list)

    def by_perm(self) -> dict[tuple, list[TransferEvent]]:
        """Group events by (axes, perm) — the key that maps to HLO pairs."""
        out: dict[tuple, list[TransferEvent]] = {}
        for e in self.events:
            out.setdefault((e.axes, e.perm), []).append(e)
        return out

    @property
    def overlap_events(self) -> list[TransferEvent]:
        return [e for e in self.events if e.overlaps]


_ACTIVE: contextvars.ContextVar[ScheduleTrace | None] = contextvars.ContextVar(
    "repro_comm_trace", default=None)


@contextlib.contextmanager
def record(name: str) -> Iterator[ScheduleTrace]:
    """Record every Channel.put issued while tracing under this context."""
    tr = ScheduleTrace(name)
    tok = _ACTIVE.set(tr)
    try:
        yield tr
    finally:
        _ACTIVE.reset(tok)


def emit(event: TransferEvent) -> None:
    """Called by Channel.put; no-op unless a trace is being recorded."""
    tr = _ACTIVE.get()
    if tr is not None:
        tr.events.append(event)


def emit_sem(event: SemEvent) -> None:
    """Called by the Pallas backend; no-op unless a trace is recording."""
    tr = _ACTIVE.get()
    if tr is not None:
        tr.sem_events.append(event)


def mark_compute(label: str = "", stream: str = "") -> None:
    """Record one compute block consumed between a fused put's issue and
    its wait — the overlap evidence `validate_semaphores` checks."""
    emit_sem(SemEvent(kind="compute", sem="", stream=stream, channel=label))


# ---------------------------------------------------------------------------
# semaphore-schedule validation (the Pallas-path analogue of the HLO gate)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SemReport:
    """Well-formedness verdict on a recorded semaphore schedule."""

    trace: str
    puts: int
    waits: int
    failures: list[str]

    @property
    def ok(self) -> bool:
        return not self.failures

    def summary(self) -> str:
        status = "OK" if self.ok else "FAIL"
        lines = [f"comm.trace[{self.trace}] sem {status}: "
                 f"{self.puts} puts, {self.waits} waits"]
        lines += [f"  FAIL: {f}" for f in self.failures]
        return "\n".join(lines)


def validate_semaphores(trace: ScheduleTrace) -> SemReport:
    """Check the recorded semaphore schedule is a valid protocol pairing.

    Rules (program order = recorded order, which is trace-time issue
    order, i.e. the order the SPMD program executes the protocol steps):

      * no wait-before-put: every ``wait`` on a semaphore must be preceded
        by the ``put`` that will satisfy it;
      * every put is signaled exactly once — a put with zero signals is a
        transfer whose completion nothing observes (a lost flag), one with
        two is a double-fire;
      * a ``signal`` with no preceding put on its semaphore is spurious;
      * no blocking wait: a put that declared in-kernel overlap
        (``overlap=True``, the fused ring kernel's puts) must have at
        least one compute block between its issue and its wait — a wait
        immediately after the put serialises the transfer, which is
        exactly the schedule bug the fused kernel exists to avoid.
    """
    failures: list[str] = []
    put_idx: dict[str, int] = {}
    overlap_puts: set[str] = set()
    signal_count: dict[str, int] = {}
    wait_idx: dict[str, int] = {}
    compute_idxs: list[int] = []
    for i, e in enumerate(trace.sem_events):
        if e.kind == "put":
            if e.sem in put_idx:
                failures.append(f"{e.sem}: put issued twice")
            put_idx[e.sem] = i
            if e.overlap:
                overlap_puts.add(e.sem)
            signal_count.setdefault(e.sem, 0)
        elif e.kind == "signal":
            if e.sem not in put_idx:
                failures.append(f"{e.sem}: signal with no preceding put")
            signal_count[e.sem] = signal_count.get(e.sem, 0) + 1
        elif e.kind == "wait":
            if e.sem not in put_idx:
                failures.append(f"{e.sem}: wait before put")
            elif e.sem not in wait_idx:
                wait_idx[e.sem] = i
        elif e.kind == "compute":
            compute_idxs.append(i)
    for sem, n in signal_count.items():
        if n != 1:
            failures.append(f"{sem}: signaled {n} times (want exactly 1)")
    for sem in overlap_puts:
        wi = wait_idx.get(sem)
        if wi is None:
            continue
        pi = put_idx[sem]
        if not any(pi < ci < wi for ci in compute_idxs):
            failures.append(
                f"{sem}: blocking wait — no compute block between the "
                "put and its wait")
    return SemReport(
        trace=trace.name,
        puts=len(put_idx),
        waits=len(wait_idx),
        failures=failures,
    )


# ---------------------------------------------------------------------------
# the eager schedule: host order of issues, waits and compute blocks
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HostOp:
    """One step of an eager program, in the order the host enqueued it."""

    kind: str  # "issue" | "wait" | "compute"
    put: int  # index of the put's TransferEvent in trace.events (-1: compute)
    label: str = ""  # compute block label
    # issue only: where the copies run.  "side" — the side CUDA stream,
    # with a completion event; "kernel" — inside the fused kernel (K2)
    # that computes beside them; "program" — in program order (the CPU)
    lowering: str = ""
    device: str = ""  # issue only: the device type of the payload


def host_ops(trace: ScheduleTrace) -> list[HostOp]:
    """The host-ordered steps recorded into ``trace``.  They live beside
    the copied ``ScheduleTrace`` fields, so that the copy stays the
    reference's text."""
    return vars(trace).setdefault("host_ops", [])


@contextlib.contextmanager
def paused() -> Iterator[None]:
    """Record nothing inside the context (a captured step's eager warm-up:
    its schedule is recorded once, when the step is captured)."""
    tok = _ACTIVE.set(None)
    try:
        yield
    finally:
        _ACTIVE.reset(tok)


def emit_issue(lowering: str, device: str) -> int:
    """Called by Channel right after it emitted a put's TransferEvent;
    returns the put's index (-1 unless a trace is recording)."""
    tr = _ACTIVE.get()
    if tr is None:
        return -1
    put = len(tr.events) - 1
    host_ops(tr).append(HostOp("issue", put, lowering=lowering,
                               device=device))
    return put


def emit_wait(put: int) -> None:
    """Called by InFlight.wait; no-op unless a trace is recording."""
    tr = _ACTIVE.get()
    if tr is not None and put >= 0:
        host_ops(tr).append(HostOp("wait", put))


def emit_compute(label: str) -> None:
    """Called when a marked compute block has been enqueued."""
    tr = _ACTIVE.get()
    if tr is not None:
        host_ops(tr).append(HostOp("compute", -1, label=label))


# ---------------------------------------------------------------------------
# route and overlap validation (the eager counterpart of the HLO gate)
# ---------------------------------------------------------------------------

def expected_pairs(mesh, axes: tuple[str, ...],
                   perm: tuple[tuple[int, int], ...]
                   ) -> frozenset[tuple[int, int]]:
    """Expand a logical perm over ``axes`` to flat device-id pairs (the
    reference's function; a device's id is its row-major index in the
    mesh).  Flat ranks over ``axes`` are major-first in the given order;
    every assignment of the remaining mesh axes replicates the perm."""
    ids = np.arange(mesh.size).reshape(tuple(mesh.shape.values()))
    names = list(mesh.axis_names)
    sub_sizes = [mesh.shape[a] for a in axes]
    other = [a for a in names if a not in axes]
    other_sizes = [mesh.shape[a] for a in other]

    def coords(flat: int, sizes: list[int]) -> list[int]:
        out = []
        for s in reversed(sizes):
            out.append(flat % s)
            flat //= s
        return list(reversed(out))

    pairs = set()
    n_other = 1
    for s in other_sizes:
        n_other *= s
    for oflat in range(n_other):
        oc = dict(zip(other, coords(oflat, other_sizes)))
        for (src, dst) in perm:
            sc = dict(zip(axes, coords(src, sub_sizes)))
            dc = dict(zip(axes, coords(dst, sub_sizes)))
            s_idx = tuple((sc | oc)[a] for a in names)
            d_idx = tuple((dc | oc)[a] for a in names)
            pairs.add((int(ids[s_idx]), int(ids[d_idx])))
    return frozenset(pairs)


@dataclasses.dataclass(frozen=True)
class _Slices:
    """The ranks a put covers: ``slices`` batch slices (major) of the
    ``axes`` sub-mesh, as a mesh for ``expected_pairs``."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes))


def _route_error(mesh, axes: tuple[str, ...],
                 perm: tuple[tuple[int, int], ...]) -> str:
    """Why a put's perm is not a route of ``axes`` on ``mesh`` ("" if it
    is).  A put moves one rank list: every rank of the ``axes`` group,
    once per batch slice, slice-major.  The reference's ppermute replicates
    one perm of the group over every other mesh coordinate, so the perm
    must be a permutation of the group's ranks replicated over the slices
    — ``expected_pairs`` of its first slice on the mesh (slices, *axes)."""
    missing = [a for a in axes if a not in mesh.axis_names]
    if missing:
        return f"axes {missing} are not axes of the mesh"
    group = mesh.axes_size(axes)
    n = len(perm)
    srcs = sorted(s for s, _ in perm)
    dsts = sorted(d for _, d in perm)
    if n % group or srcs != list(range(n)) or dsts != list(range(n)):
        return (f"perm over {n} ranks is not a permutation of whole "
                f"{axes} groups of {group} ranks")
    first = tuple((s, d) for s, d in perm if s < group)
    view = _Slices(("(slices)",) + tuple(axes),
                   (n // group,) + tuple(mesh.shape[a] for a in axes))
    want = expected_pairs(view, tuple(axes), first)
    if frozenset(perm) != want:
        bad = sorted(frozenset(perm) - want)[:4]
        return (f"pairs {bad} leave their batch slice or differ between "
                "slices")
    return ""


@dataclasses.dataclass
class ValidationReport:
    """Verdict on one recorded eager program (the reference's report;
    ``hlo_permutes`` counts the puts, each the eager counterpart of one
    collective-permute)."""

    trace: str
    hlo_permutes: int
    matched_groups: int
    overlapped: list[str]  # channel names whose overlap intent is satisfied
    failures: list[str]

    @property
    def ok(self) -> bool:
        return not self.failures

    def summary(self) -> str:
        status = "OK" if self.ok else "FAIL"
        lines = [f"comm.trace[{self.trace}] {status}: "
                 f"{self.hlo_permutes} collective-permutes, "
                 f"{self.matched_groups} schedule groups matched, "
                 f"{len(self.overlapped)} overlap intents validated"]
        lines += [f"  FAIL: {f}" for f in self.failures]
        return "\n".join(lines)


def validate(trace: ScheduleTrace, mesh, *,
             require_overlap: bool = True) -> ValidationReport:
    """Check a recorded eager program.

    Every (axes, perm) group of puts must be a route of its axes on
    ``mesh`` (``_route_error``).  Every put that declared an ``overlaps``
    intent must have been issued and waited, with at least one compute
    block enqueued between the two — the work it runs beside — and, when
    its payload is on CUDA, its copies must run off the compute stream (on
    the side stream, or inside the fused kernel).  A put waited before
    anything else was enqueued fails.  ``require_overlap`` additionally
    fails a program that declares intents but validates none."""
    ops = host_ops(trace)
    issue_at: dict[int, int] = {}
    wait_at: dict[int, int] = {}
    computes: list[int] = []
    for i, op in enumerate(ops):
        if op.kind == "issue":
            issue_at[op.put] = i
        elif op.kind == "wait":
            wait_at.setdefault(op.put, i)
        elif op.kind == "compute":
            computes.append(i)
    failures: list[str] = []
    overlapped: list[str] = []
    groups = trace.by_perm()
    matched = 0
    for (axes, perm), events in groups.items():
        err = _route_error(mesh, axes, perm)
        if err:
            failures.append(f"{events[0].channel}: {err}")
        else:
            matched += 1
    for put, e in enumerate(trace.events):
        if not e.overlaps:
            continue
        where = f"{e.channel} (stage {e.stage})"
        lo, hi = issue_at.get(put), wait_at.get(put)
        if lo is None or hi is None:
            what = "never issued" if lo is None else "never waited"
            failures.append(f"{where}: put {what}")
            continue
        issue = ops[lo]
        if issue.device == "cuda" and issue.lowering not in ("side",
                                                             "kernel"):
            failures.append(f"{where}: copies run on the compute stream")
        elif not any(lo < c < hi for c in computes):
            failures.append(
                f"{where}: transfer cannot overlap '{e.overlaps}' — waited "
                "with no compute enqueued since its issue")
        elif e.channel not in overlapped:
            overlapped.append(e.channel)
    if require_overlap and trace.overlap_events and not overlapped:
        failures.append("no overlap intent could be validated")
    return ValidationReport(trace=trace.name, hlo_permutes=len(trace.events),
                            matched_groups=matched, overlapped=overlapped,
                            failures=failures)
