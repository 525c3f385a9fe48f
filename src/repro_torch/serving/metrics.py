"""Serving observability: a unified metrics tracker (DESIGN.md §11).

The control loop built across PRs 3–5 generates rich internal signals —
plan-cache hit/miss/invalidation counters, per-step wall clocks,
preemption and resync tallies, calibration drift ratios — but until this
subsystem each lived in its own ad-hoc attribute, observable only by
reaching into objects.  This module turns them into one time-series
surface in the spirit of levanter's ``tracker.py``: components publish
named metrics to a ``Tracker`` sink; what happens to the stream is the
sink's business (dropped, held in memory, streamed to disk).  The fleet
router on the ROADMAP consumes exactly this surface cross-replica.

Sink taxonomy:

  * ``Tracker``       — the default threaded through every engine when no
    sink is given: aggregates counters and per-series gauge statistics
    (so the legacy attributes like ``PlanCache.hits`` keep working as
    thin reads, and ``summary()`` can print an end-of-run table) but
    retains **no per-record stream** — a long-running server never
    accumulates unbounded history by default.
  * ``NullTracker``   — a TRUE no-op: no counters, no stats, no records.
    Legacy counter reads through it are always 0; use it only when the
    attribute surface is not consumed.
  * ``RecordingTracker`` — ``Tracker`` plus the full in-memory record
    stream (``records``).  The test sink.
  * ``JsonlTracker``  — ``Tracker`` plus one schema-versioned JSON line
    per record streamed to disk (``launch/serve.py --metrics out.jsonl``,
    ``benchmarks/run.py --metrics``).  ``read_jsonl`` round-trips the
    file back into ``Record`` objects bit-exactly.

Every record carries ``schema`` (``SCHEMA_VERSION``) so mixed streams —
bench trajectories and serving telemetry share this schema — stay
self-describing; ``validate_record`` is the single checker CI's
``scripts/check_metrics_schema.py`` gate and the tests both call.

Metric kinds:

  * ``count(name, value)`` — monotone counter; the emitted record's
    ``value`` is the NEW cumulative total (so a JSONL stream replays to
    the same final counts without summing) and ``Tracker.counter(name)``
    reads the current total.
  * ``log(name, value)``   — gauge / time-series sample (per-step wall
    clocks, drift trajectories, event markers).  ``step`` orders samples
    within a series; ``tags`` split series (bucket shape, admission id).
  * ``span(name)`` / ``span_event(name, t_start, dur)`` — timed interval
    (DESIGN.md §12): ``value`` is the duration in seconds, ``t_start``
    the offset from the tracker's ``epoch``.  ``span`` is a context
    manager that times a host region (nesting recorded via a ``parent``
    tag); ``span_event`` publishes an interval measured elsewhere (the
    comm profiler's drained device-side legs).  ``scripts/trace_report.py``
    turns a span stream into a Perfetto timeline plus overlap/residual
    reports.

Everything is host-side pure Python — no jax — so the discrete-event
simulation in ``benchmarks/sched_sweep.py`` publishes through the exact
sink type the real engine uses.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import pathlib
import time
from typing import IO, Any, Iterable, Iterator, Mapping

SCHEMA_VERSION = "metrics.v1"

# record kinds a conforming stream may contain.  "span" is the PR 7
# extension (DESIGN.md §12): a timed interval — ``value`` is the duration
# in seconds and ``t_start`` its offset from the tracker's epoch — and is
# backward compatible: span-free streams are unchanged, and readers that
# predate spans see a gauge-shaped record with one extra field.
KINDS = ("counter", "gauge", "span")

# a tag value must survive a JSON round-trip unchanged
TagValue = str | int | float | bool

_REQUIRED_FIELDS = ("schema", "seq", "name", "kind", "value")


@dataclasses.dataclass(frozen=True)
class Record:
    """One metric sample.  ``seq`` is the tracker-assigned monotone
    record index (total order of the stream, even across interleaved
    series); ``step`` is the caller's position within ITS series (sampler
    step, refit ordinal) and may repeat across series."""

    name: str
    value: float
    kind: str = "gauge"
    step: int | None = None
    tags: dict[str, TagValue] = dataclasses.field(default_factory=dict)
    seq: int = 0
    schema: str = SCHEMA_VERSION
    # spans only: start offset (seconds) from the tracker's epoch; the
    # duration is ``value``.  None for counters/gauges.
    t_start: float | None = None

    def to_dict(self) -> dict[str, Any]:
        d = {"schema": self.schema, "seq": self.seq, "name": self.name,
             "kind": self.kind, "value": self.value}
        if self.step is not None:
            d["step"] = self.step
        if self.tags:
            d["tags"] = dict(self.tags)
        if self.t_start is not None:
            d["t_start"] = self.t_start
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Record":
        return cls(name=d["name"], value=d["value"], kind=d["kind"],
                   step=d.get("step"), tags=dict(d.get("tags") or {}),
                   seq=d["seq"], schema=d["schema"],
                   t_start=d.get("t_start"))


def validate_record(d: Mapping[str, Any]) -> list[str]:
    """Schema check for one record dict; returns the list of violations
    (empty = conforming).  The single source of truth shared by the unit
    tests and ``scripts/check_metrics_schema.py``."""
    errs = []
    for f in _REQUIRED_FIELDS:
        if f not in d:
            errs.append(f"missing field {f!r}")
    if errs:
        return errs
    if d["schema"] != SCHEMA_VERSION:
        errs.append(f"schema {d['schema']!r} != {SCHEMA_VERSION!r}")
    if d["kind"] not in KINDS:
        errs.append(f"kind {d['kind']!r} not in {KINDS}")
    if not isinstance(d["name"], str) or not d["name"]:
        errs.append("name must be a non-empty string")
    if not isinstance(d["value"], (int, float)) or isinstance(d["value"], bool):
        errs.append(f"value {d['value']!r} is not a number")
    if not isinstance(d["seq"], int) or d["seq"] < 0:
        errs.append(f"seq {d['seq']!r} is not a non-negative int")
    step = d.get("step")
    if step is not None and not isinstance(step, int):
        errs.append(f"step {step!r} is not an int")
    tags = d.get("tags", {})
    if not isinstance(tags, Mapping):
        errs.append("tags is not a mapping")
    else:
        for k, v in tags.items():
            if not isinstance(k, str):
                errs.append(f"tag key {k!r} is not a string")
            if not isinstance(v, (str, int, float, bool)):
                errs.append(f"tag {k}={v!r} is not str/int/float/bool")
    t_start = d.get("t_start")
    if d["kind"] == "span":
        if t_start is None:
            errs.append("span record is missing t_start")
        elif (not isinstance(t_start, (int, float))
              or isinstance(t_start, bool) or t_start < 0):
            errs.append(f"t_start {t_start!r} is not a non-negative number")
        if isinstance(d["value"], (int, float)) and d["value"] < 0:
            errs.append(f"span duration {d['value']!r} is negative")
    elif t_start is not None:
        errs.append(f"t_start is only valid on span records, not {d['kind']}")
    unknown = set(d) - {*_REQUIRED_FIELDS, "step", "tags", "t_start"}
    if unknown:
        errs.append(f"unknown fields {sorted(unknown)}")
    return errs


def _tag_key(tags: Mapping[str, TagValue] | None) -> tuple:
    """Canonical hashable identity of a tag set (order-insensitive)."""
    if not tags:
        return ()
    return tuple(sorted(tags.items()))


@dataclasses.dataclass
class SeriesStats:
    """Constant-space aggregate of one gauge series (per (name, tags))."""

    n: int = 0
    total: float = 0.0
    vmin: float = float("inf")
    vmax: float = float("-inf")
    last: float = 0.0

    def add(self, v: float) -> None:
        self.n += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        self.last = v

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0


class Tracker:
    """Aggregating sink: counters + per-series gauge statistics, no
    record retention.  Subclasses persist the stream by overriding
    ``_emit`` (called once per record, AFTER aggregation)."""

    def __init__(self):
        self._counters: dict[tuple[str, tuple], float] = {}
        self._stats: dict[tuple[str, tuple], SeriesStats] = {}
        self._seq = 0
        # span timebase: every t_start in this tracker's stream is an
        # offset from this perf_counter reading, so spans from different
        # components (host code, drained comm-profiler events) share one
        # clock and the trace report never has to reconcile epochs.
        self.epoch = time.perf_counter()
        self._span_stack: list[str] = []

    # -- publishing -------------------------------------------------------
    def count(self, name: str, value: float = 1.0, *, step: int | None = None,
              tags: Mapping[str, TagValue] | None = None) -> float:
        """Increment a monotone counter; returns (and emits) the new
        cumulative total.  ``value`` must be non-negative — counters
        never decrease (test_metrics.py pins the monotonicity)."""
        assert value >= 0, f"counter increment must be >= 0, got {value}"
        key = (name, _tag_key(tags))
        total = self._counters.get(key, 0.0) + value
        self._counters[key] = total
        self._record(name, total, "counter", step, tags)
        return total

    def log(self, name: str, value: float, *, step: int | None = None,
            tags: Mapping[str, TagValue] | None = None) -> None:
        """Publish one gauge sample of the series (name, tags)."""
        key = (name, _tag_key(tags))
        st = self._stats.get(key)
        if st is None:
            st = self._stats[key] = SeriesStats()
        st.add(float(value))
        self._record(name, float(value), "gauge", step, tags)

    def now(self) -> float:
        """Seconds since this tracker's epoch — the span timebase."""
        return time.perf_counter() - self.epoch

    def span_event(self, name: str, t_start: float, dur: float, *,
                   step: int | None = None,
                   tags: Mapping[str, TagValue] | None = None) -> None:
        """Publish one already-measured span: ``t_start`` is seconds since
        ``self.epoch`` (use ``now()``), ``dur`` the duration in seconds.
        Durations aggregate into the same per-series stats as gauges, so
        ``summary()`` shows span timing tables for free."""
        key = (name, _tag_key(tags))
        st = self._stats.get(key)
        if st is None:
            st = self._stats[key] = SeriesStats()
        st.add(float(dur))
        self._record(name, float(dur), "span", step, tags,
                     t_start=float(t_start))

    @contextlib.contextmanager
    def span(self, name: str, *, step: int | None = None,
             tags: Mapping[str, TagValue] | None = None) -> Iterator[None]:
        """Time a host-side region as a span record.  Nested spans get a
        ``parent`` tag automatically (unless the caller sets one), which
        is how ``scripts/trace_report.py`` rebuilds the step→stage tree.
        The record is emitted even if the body raises, so a crashed
        step's partial timing still lands in the stream."""
        t0 = self.now()
        tags = dict(tags) if tags else {}
        if self._span_stack and "parent" not in tags:
            tags["parent"] = self._span_stack[-1]
        self._span_stack.append(name)
        try:
            yield
        finally:
            self._span_stack.pop()
            self.span_event(name, t0, self.now() - t0, step=step,
                            tags=tags or None)

    def _record(self, name: str, value: float, kind: str,
                step: int | None, tags: Mapping[str, TagValue] | None, *,
                t_start: float | None = None) -> None:
        rec = Record(name=name, value=value, kind=kind, step=step,
                     tags=dict(tags) if tags else {}, seq=self._seq,
                     t_start=t_start)
        self._seq += 1
        self._emit(rec)

    def _emit(self, rec: Record) -> None:  # aggregate-only: drop the record
        pass

    # -- reading ----------------------------------------------------------
    # Sinks that retain the full record stream set this True; the engine
    # reads it to decide whether per-step wall clocks are worth their
    # device sync even without the control loop engaged (DESIGN.md §11).
    persistent = False

    def counter(self, name: str,
                tags: Mapping[str, TagValue] | None = None) -> float:
        """Current cumulative value of a counter (0.0 if never bumped) —
        what the legacy attributes (``PlanCache.hits`` & co.) read."""
        return self._counters.get((name, _tag_key(tags)), 0.0)

    def counter_total(self, name: str) -> float:
        """Sum of a counter over ALL tag sets sharing ``name``."""
        return sum(v for (n, _), v in self._counters.items() if n == name)

    def counter_items(self, name: str) -> list[tuple[dict, float]]:
        """Every tag set of a counter with its total — how a fleet router
        enumerates a folded multi-replica view (e.g. which ``replica``
        tags have compiled which ``seq`` shapes) without knowing the tag
        sets in advance."""
        return [(dict(k), v) for (n, k), v in self._counters.items()
                if n == name]

    def series_items(self, name: str) -> list[tuple[dict, "SeriesStats"]]:
        """Every tag set of a gauge/span series with its aggregate stats
        (the gauge counterpart of ``counter_items``)."""
        return [(dict(k), st) for (n, k), st in self._stats.items()
                if n == name]

    def series(self, name: str,
               tags: Mapping[str, TagValue] | None = None) -> SeriesStats:
        """Aggregate stats of one gauge series (empty stats if unseen)."""
        return self._stats.get((name, _tag_key(tags)), SeriesStats())

    def summary(self) -> list[dict[str, Any]]:
        """End-of-run aggregate table: one row per counter and per gauge
        series, sorted by name then tags — what ``launch/serve.py``
        prints after a ``--metrics`` run."""
        rows: list[dict[str, Any]] = []
        for (name, tags), v in self._counters.items():
            rows.append({"name": name, "kind": "counter",
                         "tags": dict(tags), "value": v})
        for (name, tags), st in self._stats.items():
            rows.append({"name": name, "kind": "gauge", "tags": dict(tags),
                         "n": st.n, "mean": st.mean, "min": st.vmin,
                         "max": st.vmax, "last": st.last})
        rows.sort(key=lambda r: (r["name"], sorted(r["tags"].items())))
        return rows

    def format_summary(self) -> str:
        """The summary as an aligned text table."""
        lines = ["metric                                   kind     value"]
        for r in self.summary():
            tag_s = ("{" + ",".join(f"{k}={v}" for k, v in
                                    sorted(r["tags"].items())) + "}"
                     if r["tags"] else "")
            name = f"{r['name']}{tag_s}"
            if r["kind"] == "counter":
                val = f"{r['value']:g}"
            else:
                val = (f"n={r['n']} mean={r['mean']:.6g} "
                       f"min={r['min']:.6g} max={r['max']:.6g}")
            lines.append(f"{name:<40} {r['kind']:<8} {val}")
        return "\n".join(lines)

    def close(self) -> None:
        pass

    def __enter__(self) -> "Tracker":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class NullTracker(Tracker):
    """A true no-op sink: publishing does nothing at all (no counters,
    no stats, no seq advance), reads are always empty/zero."""

    def count(self, name: str, value: float = 1.0, *, step=None,
              tags=None) -> float:
        return 0.0

    def log(self, name: str, value: float, *, step=None, tags=None) -> None:
        pass

    def span_event(self, name, t_start, dur, *, step=None, tags=None) -> None:
        pass

    @contextlib.contextmanager
    def span(self, name, *, step=None, tags=None):
        yield


class RecordingTracker(Tracker):
    """In-memory sink for tests: full record stream + the aggregates."""

    def __init__(self):
        super().__init__()
        self.records: list[Record] = []

    persistent = True

    def _emit(self, rec: Record) -> None:
        self.records.append(rec)


class JsonlTracker(Tracker):
    """Streams every record to ``path`` as one JSON line (sorted keys, so
    byte output is deterministic given the record stream).

    Crash safety: by default every record is flushed to the OS as soon as
    it is written (``flush_every=1``), so a run killed mid-serve leaves a
    trace whose completed lines are all readable and schema-valid — at
    worst the final line is truncated (``read_jsonl(partial_tail="drop")``
    recovers everything before it).  Raise ``flush_every`` to amortize
    the flush for high-rate span streams; the tracker still flushes on
    ``close()``, and the context-manager protocol closes on exception."""

    def __init__(self, path: str | pathlib.Path, *, flush_every: int = 1):
        super().__init__()
        assert flush_every >= 1, f"flush_every must be >= 1, got {flush_every}"
        self.path = pathlib.Path(path)
        self.flush_every = flush_every
        self._since_flush = 0
        self._fh: IO[str] | None = self.path.open("w")

    persistent = True

    def _emit(self, rec: Record) -> None:
        assert self._fh is not None, "JsonlTracker is closed"
        self._fh.write(json.dumps(rec.to_dict(), sort_keys=True) + "\n")
        self._since_flush += 1
        if self._since_flush >= self.flush_every:
            self._fh.flush()
            self._since_flush = 0

    def flush(self) -> None:
        if self._fh is not None:
            self._fh.flush()
            self._since_flush = 0

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def read_jsonl(path: str | pathlib.Path, validate: bool = True,
               partial_tail: str = "error") -> list[Record]:
    """Load a JSONL trace back into ``Record`` objects (the round-trip
    inverse of ``JsonlTracker``); ``validate`` schema-checks every line.
    ``partial_tail="drop"`` tolerates a truncated FINAL line (a crashed
    writer) — corruption anywhere else still raises."""
    assert partial_tail in ("error", "drop"), partial_tail
    records = []
    lines = pathlib.Path(path).read_text().splitlines()
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            d = json.loads(line)
        except json.JSONDecodeError:
            if partial_tail == "drop" and i == len(lines) - 1:
                break
            raise
        if validate:
            errs = validate_record(d)
            if errs:
                raise ValueError(f"{path}:{i + 1}: {'; '.join(errs)}")
        records.append(Record.from_dict(d))
    return records


class TraceFold:
    """Incremental fold of one shipped record stream into another tracker
    — the consumer side of the fleet tier's trace-shipping protocol
    (DESIGN.md §13; ``serving/fleet.py``).

    Counter records carry cumulative totals, so writing them into the
    destination verbatim would (a) bypass ``_emit`` — persistent sinks
    like ``JsonlTracker`` would silently drop every replayed counter —
    and (b) make a second stream folded into the same tracker CLOBBER
    the first (last record wins) instead of summing.  The fold instead
    differences consecutive totals per SOURCE series and re-publishes the
    increments through the tracker API (``count``/``log``/``span_event``),
    so:

      * every replayed record reaches ``_emit`` (persistent sinks see it),
      * multiple replicas' streams folded into one tracker SUM,
      * re-folding a growing trace from the start is idempotent on the
        already-folded prefix (records are deduplicated by ``seq``).

    ``tags`` namespaces every re-published record (the router passes
    ``{"replica": rid}``), so per-replica series stay distinguishable in
    the folded view while ``counter_total`` still sums across them."""

    def __init__(self, tags: Mapping[str, TagValue] | None = None):
        self.tags: dict[str, TagValue] = dict(tags) if tags else {}
        self._totals: dict[tuple[str, tuple], float] = {}
        self._cursor = -1  # highest source seq already folded

    def fold(self, records: Iterable[Record], into: Tracker) -> int:
        """Re-publish every not-yet-folded record into ``into``; returns
        the number of records folded."""
        n = 0
        for r in records:
            if r.seq <= self._cursor:
                continue  # already folded in an earlier ship
            self._cursor = r.seq
            tags = {**r.tags, **self.tags} or None
            if r.kind == "counter":
                key = (r.name, _tag_key(r.tags))
                prev = self._totals.get(key, 0.0)
                assert r.value >= prev, (
                    f"counter {r.name} decreased in source stream "
                    f"({prev} -> {r.value}); not a valid metrics.v1 trace")
                self._totals[key] = r.value
                into.count(r.name, r.value - prev, step=r.step, tags=tags)
            elif r.kind == "span":
                into.span_event(r.name, r.t_start, r.value, step=r.step,
                                tags=tags)
            else:
                into.log(r.name, r.value, step=r.step, tags=tags)
            n += 1
        return n


def replay(records: Iterable[Record], into: Tracker | None = None,
           tags: Mapping[str, TagValue] | None = None) -> Tracker:
    """Re-publish a record stream into a tracker — counters land on their
    recorded cumulative totals via per-series increments routed through
    the tracker API (so persistent sinks receive the replayed records and
    folding a SECOND stream into the same tracker sums instead of
    clobbering), gauges rebuild their series stats, spans keep their
    windows.  ``tags`` namespaces the folded records (a fleet router
    passes ``{"replica": rid}`` per shipped trace); use ``TraceFold``
    directly for incremental shipping of a growing trace."""
    t = into if into is not None else Tracker()
    TraceFold(tags=tags).fold(records, t)
    return t
