"""Span profiler of the comm runtime (counterpart of
``src/repro/comm/profiler.py``).

trace.py checks the schedule a program *intends*; this module measures
what ran.  While a ``profile(profiler)`` context is active, every put
(channel.py) and every compute block the schedules mark records
observations:

    issue   — the put's operands are ready and its copies may start: on
              CUDA an event on the compute stream at the point the side
              stream waits for (channel.issue), before the fused kernels
              for a K2 put.  (An event on the side stream would fire only
              once the side stream is done with earlier puts, possibly
              after the consumer's wait, and the pairing would then lose
              the wait.)
    signal  — the copies are done: an event on the side stream after the
              put's launch (on the compute stream after the fused
              kernels).
    wait    — the consumer needs the buffer: an event on the consuming
              stream in ``InFlight.wait``, before it waits on the put.
    start / end — bracket a compute block (``mark_compute``).

On CUDA an observation is a timing event (``torch.cuda.Event``); ``take``
synchronises once and turns event times into host ``perf_counter``
seconds through an anchor (one event recorded with a ``perf_counter``
reading when ``profile`` is entered), so the host's ``engine.step`` spans
and the ``comm.*`` spans share one clock.  On the CPU an observation is a
``perf_counter`` reading.  Without an active profiler nothing is recorded
and the puts keep their untimed completion event: profiling costs nothing
by default.

A leg is one put call.  Eager execution has no trace time, so each put is
one leg with one occurrence.  One device runs every virtual rank and one
put covers all of them, so a put is stamped once, on the device's track
(``_track`` gives ``"dev"``): ``nbytes`` is what ONE rank sends, as in the
reference, so that the report's bandwidth residuals compare, and the
``ranks`` tag holds the route's rank count.  Stamping one timeline per
virtual rank would multiply the spans and add no information.

Exposure per occurrence of a leg: ``exposed = max(0, t_signal - t_wait)``.
``emit_leg_spans`` pairs the events into ``comm.leg`` / ``comm.compute`` /
``comm.exposed_wait`` spans (the reference's pairing, copied;
``tests/test_torch_copies.py`` pins it), which ``launch/trace_report.py``
renders.  In a step captured as a CUDA graph (serving/graphs.py) the
events are captured with it, as external event-record nodes: the
capture files them once, and after each replay ``replayed`` reads them
as that replay's observations, so a captured leg has one occurrence per
replay, as a leg of the reference's jitted step has.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import threading
import time
from typing import Any, Iterator, Sequence

import torch

from . import trace as _trace

__all__ = ["CommProfiler", "LegEvent", "LegMeta", "active", "emit_leg_spans",
           "mark", "mark_compute", "nbytes_of", "profile"]


@dataclasses.dataclass(frozen=True)
class LegMeta:
    """Identity of one instrumented leg: one put, or one compute block."""

    leg: int
    kind: str  # "comm" | "compute"
    stream: str
    channel: str
    stage: int
    axes: tuple[str, ...]
    nbytes: int  # per rank
    n_tensors: int
    backend: str
    intent: str  # ``overlaps`` label from the put ("" = not meant hidden)
    label: str = ""
    ranks: int = 1  # ranks of the route one put covers
    # a put's (src, dst) flat ranks on ``axes`` (launch/dryrun.py reads
    # which of them cross the pod axis)
    perm: tuple[tuple[int, int], ...] = ()


@dataclasses.dataclass(frozen=True)
class LegEvent:
    """One observation: leg + phase + coords + time.  ``t`` is
    ``perf_counter`` seconds (a ``torch.cuda.Event`` until ``take``)."""

    meta: LegMeta
    phase: str  # "issue" | "signal" | "wait" | "start" | "end"
    coords: tuple[int, ...]  # () = the device's one track
    t: Any


class CommProfiler:
    """Thread-safe event sink."""

    def __init__(self):
        self.events: list[LegEvent] = []
        self._lock = threading.Lock()
        self._ids = itertools.count()
        # CUDA: (device, anchor event, perf_counter seconds of the event)
        self._anchor: tuple[torch.device, Any, float] | None = None

    def new_leg(self, **kw: Any) -> LegMeta:
        return LegMeta(leg=next(self._ids), **kw)

    def _record(self, meta: LegMeta, phase: str, coords, t: Any = None
                ) -> None:
        # must never raise: it runs inside the schedules
        if t is None:
            t = time.perf_counter()
        try:
            cs = tuple(int(c) for c in coords)
        except Exception:
            cs = ()
        with self._lock:
            self.events.append(LegEvent(meta, phase, cs, t))

    def anchor(self, device: torch.device) -> None:
        """Tie ``device``'s event clock to ``perf_counter``: with the device
        idle, record an event and take the host reading at its midpoint."""
        if self._anchor is not None and self._anchor[0] == device:
            return
        torch.cuda.synchronize(device)
        ev = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev.record(torch.cuda.current_stream(device))
        ev.synchronize()
        self._anchor = (device, ev, (t0 + time.perf_counter()) / 2)

    def replayed(self, captured: Sequence[LegEvent]) -> None:
        """File the observations of a captured step's replay: ``captured``
        holds the events its capture recorded (external event nodes, which
        every replay records again).  One device synchronisation."""
        dev, ref, t_ref = self._anchor
        torch.cuda.synchronize(dev)
        evs = [dataclasses.replace(e, t=t_ref + ref.elapsed_time(e.t) / 1e3)
               for e in captured]
        with self._lock:
            self.events.extend(evs)

    def take(self) -> list[LegEvent]:
        """Atomically drain the recorded events, with every event time in
        ``perf_counter`` seconds (one device synchronisation on CUDA)."""
        with self._lock:
            evs, self.events = self.events, []
        if not any(isinstance(e.t, torch.cuda.Event) for e in evs):
            return evs
        dev, ref, t_ref = self._anchor
        torch.cuda.synchronize(dev)
        return [dataclasses.replace(e, t=t_ref + ref.elapsed_time(e.t) / 1e3)
                if isinstance(e.t, torch.cuda.Event) else e for e in evs]


_ACTIVE: contextvars.ContextVar[CommProfiler | None] = contextvars.ContextVar(
    "repro_torch_comm_profiler", default=None)


def active() -> CommProfiler | None:
    """The profiler the puts and compute blocks record into, if any."""
    return _ACTIVE.get()


@contextlib.contextmanager
def profile(profiler: CommProfiler) -> Iterator[CommProfiler]:
    """Record every put and marked compute block issued inside the
    context.  With CUDA in use, the event clock is anchored on entry."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        profiler.anchor(torch.device("cuda", torch.cuda.current_device()))
    token = _ACTIVE.set(profiler)
    try:
        yield profiler
    finally:
        _ACTIVE.reset(token)


def mark(prof: CommProfiler, meta: LegMeta, phase: str,
         device: torch.device) -> None:
    """Record one observation of ``meta`` now: on CUDA a timing event on
    ``device``'s current stream, on the CPU a ``perf_counter`` reading."""
    if device.type != "cuda":
        prof._record(meta, phase, ())
        return
    if torch.cuda.is_current_stream_capturing():
        # an event-record node of the graph: the anchor was set by the
        # step's eager warm-up (no synchronisation while capturing)
        if prof._anchor is None:
            raise RuntimeError("a profiled step was captured before its "
                               "profiler was anchored")
        ev = torch.cuda.Event(enable_timing=True, external=True)
    else:
        prof.anchor(device)
        ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    prof._record(meta, phase, (), ev)


def nbytes_of(tensors: Sequence[Sequence[torch.Tensor]]) -> int:
    """Bytes one rank sends: the first held rank's tensor of every rank
    list."""
    firsts = [next(x for x in r if x is not None) for r in tensors]
    return sum(x.numel() * x.element_size() for x in firsts)


@contextlib.contextmanager
def mark_compute(label: str, axes: Sequence[str], device: torch.device, *,
                 stream: str = "") -> Iterator[None]:
    """Bracket a compute block: the ops the body enqueues.

    With a profiler active, ``start`` is observed before the body and
    ``end`` after it (on CUDA: events on the compute stream, so the span
    is when the device ran the block).  With a schedule trace recording,
    the block is also a host op that ``trace.validate`` counts as compute
    between a put's issue and its wait."""
    prof = active()
    meta = None
    if prof is not None:
        meta = prof.new_leg(kind="compute", stream=stream, channel=label,
                            stage=0, axes=tuple(axes), nbytes=0,
                            n_tensors=0, backend="", intent="", label=label)
        mark(prof, meta, "start", device)
    yield
    if meta is not None:
        mark(prof, meta, "end", device)
    _trace.emit_compute(label)


def _track(meta: LegMeta, coords: tuple[int, ...]) -> str:
    """Perfetto track id: 'pod=0,model=3', or 'dev' for the device."""
    if not coords or all(c < 0 for c in coords):
        return "dev"
    return ",".join(f"{a}={c}" for a, c in zip(meta.axes, coords))


def emit_leg_spans(profiler: CommProfiler, tracker: Any) -> int:
    """Drain the profiler and publish paired spans into ``tracker``
    (``span_event``, t_start relative to ``tracker.epoch``).  Returns the
    number of spans emitted.  Safe to call repeatedly (per batch)."""
    events = profiler.take()
    epoch = tracker.epoch

    def rel(t: float) -> float:
        # events recorded before the tracker existed clamp to its epoch
        return max(t - epoch, 0.0)

    groups: dict[tuple[int, tuple[int, ...]], list[LegEvent]] = {}
    for ev in events:
        groups.setdefault((ev.meta.leg, ev.coords), []).append(ev)
    n = 0
    for (leg, coords), evs in sorted(groups.items()):
        evs.sort(key=lambda e: e.t)
        meta = evs[0].meta
        track = _track(meta, coords)
        if meta.kind == "compute":
            occ, start = 0, None
            for ev in evs:
                if ev.phase == "start":
                    start = ev.t
                elif ev.phase == "end" and start is not None:
                    tracker.span_event(
                        "comm.compute", rel(start),
                        max(ev.t - start, 0.0),
                        tags={"label": meta.label, "stream": meta.stream,
                              "track": track, "leg": leg, "occ": occ})
                    occ, start = occ + 1, None
                    n += 1
            continue
        # comm leg: each "issue" starts a new occurrence
        occs: list[dict[str, float]] = []
        cur: dict[str, float] | None = None
        for ev in evs:
            if ev.phase == "issue":
                cur = {"issue": ev.t}
                occs.append(cur)
            elif cur is not None and ev.phase not in cur:
                cur[ev.phase] = ev.t
        for occ_i, o in enumerate(occs):
            if "signal" not in o:
                continue
            t0, t1 = o["issue"], o["signal"]
            tags: dict[str, Any] = {
                "stream": meta.stream, "channel": meta.channel,
                "stage": meta.stage, "axes": ",".join(meta.axes),
                "track": track, "leg": leg, "occ": occ_i,
                "nbytes": meta.nbytes, "tensors": meta.n_tensors,
                "backend": meta.backend, "intent": meta.intent,
                "ranks": meta.ranks}
            if "wait" in o:
                exposed = max(0.0, t1 - o["wait"])
                tags["exposed_s"] = exposed
                if exposed > 0:
                    tracker.span_event(
                        "comm.exposed_wait", rel(o["wait"]),
                        exposed, tags={"stream": meta.stream,
                                       "channel": meta.channel,
                                       "track": track, "leg": leg,
                                       "occ": occ_i})
                    n += 1
            tracker.span_event("comm.leg", rel(t0),
                               max(t1 - t0, 0.0), tags=tags)
            n += 1
    return n
