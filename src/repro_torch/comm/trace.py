"""Schedule recording and semaphore-schedule validation — the
framework-free half of the reference's ``comm/trace.py`` (lines 55-240,
copied; ``tests/test_torch_copies.py`` pins the copy).

The one-sided channel layer records the schedule it *intends*: every put,
its completion signal, every wait, and the compute blocks a fused put is
meant to overlap.  ``validate_semaphores`` checks that record for
well-formedness (each put signalled exactly once, no wait before its put,
no blocking wait on a fused put).

The reference's other half checks the compiled XLA HLO; it has no
counterpart here (ROADMAP Queue 1 item 5 replaces it with a check on CUDA
streams and events).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Iterator

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
