"""Multi-replica fleet tier (DESIGN.md §13): data-parallel serving above
the single-mesh engine.

One ``DiTServer`` on one mesh cannot carry heavy global traffic; the
fleet tier runs N independent replicas — each one mesh plus the full
PR-3/5 scheduler/control stack (bucketer, admission, plan cache,
forecaster) — behind a ``FleetRouter`` doing global SLA-aware dispatch.
This is the dp(fleet) × hybrid(replica) sweep shape xDiT demonstrates
with its dp_degree × pp_degree grids, lifted to a serving tier.

**Replica state machine** — ``active`` ⇄ ``draining`` / ``failed``:

    active ──drain()──▶ draining ──resume()──▶ active
    active ──fail()───▶ failed   ──resume()──▶ active

A draining replica accepts no new dispatch but serves out its queue; a
failed replica additionally evacuates its queued (never-admitted)
requests, which the router re-dispatches with submission age intact
(``RequestScheduler.submit(resubmit=True)``).  A batch already in flight
runs to completion in both cases — KV state is per-batch and disposable,
so drain/fail are queue-level events, not mid-step aborts.

**Trace-shipping protocol** — every replica publishes its serving
telemetry through its own ``metrics.v1`` tracker (a ``JsonlTracker`` in
production); the router periodically *ships* each stream — ``read_jsonl``
the file, fold the new records through ``TraceFold`` into the router's
own tracker under a ``{"replica": rid}`` tag namespace.  Counter records
carry cumulative totals, so the fold differences them per source series
and re-publishes increments through the tracker API: multi-replica folds
SUM (never clobber) and persistent router sinks see every record.

**The router reads only the folded view.**  Queue depth, plan-cache
warmth, drain/fail state and per-bucket arrival rates are all derived
from folded replica records (plus the router's own dispatch ledger for
the records not yet shipped) — never by reaching into a replica's
scheduler.  That keeps the tier honest about distribution: everything a
real cross-host router could know arrives over the same shipped streams
CI validates with ``scripts/check_metrics_schema.py``.

**Dispatch policies** (``FleetRouter.policy``):

  * ``round_robin``   — cycle over active replicas (the baseline).
  * ``least_loaded``  — minimum effective queue depth (folded depth gauge
    + unshipped dispatch ledger).
  * ``warmth``        — resolution-band affinity: each latent-length band
    has a home pool whose plan caches are already warm for its bucket
    shapes (first assignment prefers a replica whose folded stream shows
    a compiled step for the band), with least-queue spill when the home
    pool's depth exceeds the fleet minimum by ``spill_depth``.
  * ``sla``           — ``warmth`` plus elastic repartition: the replica
    pool is re-split between SP-heavy large-resolution and batch-heavy
    small-resolution service as the arrival mix shifts, driven by the
    per-bucket rates the replicas' own ``ArrivalForecaster``s publish
    (``forecast.mean_gap_s``, folded).

``run_fleet`` is the host-side discrete-event execution harness (no jax,
no wall clock): batches run for their comm-model-predicted duration plus
a one-time trace stall per new bucket shape per replica — the warmth
signal.  ``benchmarks/fleet_sweep.py`` sweeps it; ``repro.launch.fleet``
is the CLI.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Iterable, Sequence

from .metrics import (
    JsonlTracker,
    Record,
    RecordingTracker,
    Tracker,
    TraceFold,
    read_jsonl,
)
from .sched import (
    Admission,
    ArrivalForecaster,
    PlanCache,
    RequestScheduler,
    SchedConfig,
)

ACTIVE = "active"
DRAINING = "draining"
FAILED = "failed"
_STATE_CODE = {ACTIVE: 0, DRAINING: 1, FAILED: 2}
_CODE_STATE = {v: k for k, v in _STATE_CODE.items()}

POLICIES = ("round_robin", "least_loaded", "warmth", "sla")


@dataclasses.dataclass
class FleetRequest:
    """Duck-typed request for the fleet tier (same surface the scheduler
    sim uses: no jax import needed)."""

    rid: int
    seq_len: int
    arrival: float
    sla: float | None = None
    submitted: float = 0.0
    drift_threshold: float | None = None


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Router-side knobs (all in simulated/served seconds)."""

    ship_every: float = 0.05  # period of the trace-shipping fold
    # warmth/sla: spill off the home pool when its effective depth
    # exceeds the fleet minimum by this many requests
    spill_depth: int = 10
    repartition_every: float = 0.2  # min seconds between sla repartitions


class Replica:
    """One serving replica: a mesh's scheduler/control stack plus the
    drain/fail state machine, publishing its state exclusively through
    its tracker so the router can consume it over shipped traces.

    The replica publishes (beyond what the scheduler stack already
    emits): ``replica.state`` and ``replica.queue_depth`` gauges on every
    transition, and ``replica.served`` / ``replica.batches`` counters on
    batch completion."""

    def __init__(self, rid: str, scheduler: RequestScheduler):
        self.rid = rid
        self.scheduler = scheduler
        self.tracker = scheduler.tracker
        self.state = ACTIVE
        self._publish_state()
        self._publish_depth()

    @classmethod
    def sim(cls, rid: str, trace_path: str | pathlib.Path | None = None, *,
            n_machines: int = 2, m_per_machine: int = 4, heads: int = 24,
            head_dim: int = 64, n_layers: int = 42, num_steps: int = 20,
            dp: int = 2, max_batch: int = 4, starvation_age: float = 1.0,
            default_slack: float = 10.0, defer_slack: float = 0.02,
            forecast_idle_age: float | None = 2.0) -> "Replica":
        """A replica with the full PR-3/5 host-side stack on the paper
        testbed flavour (N machines × M devices, dp-way batch split) —
        what the fleet sim and the launch CLI construct.  ``trace_path``
        selects the production sink (``JsonlTracker``; this file is what
        the router ships); None keeps the trace in memory
        (``RecordingTracker``, the test sink)."""
        tracker: Tracker = (JsonlTracker(trace_path)
                            if trace_path is not None else RecordingTracker())
        cache = PlanCache(n_machines=n_machines, m_per_machine=m_per_machine,
                          heads=heads, head_dim=head_dim, n_layers=n_layers,
                          num_steps=num_steps, dp=dp, tracker=tracker)
        cfg = SchedConfig(max_batch=max_batch, dp=dp,
                          starvation_age=starvation_age,
                          default_slack=default_slack,
                          defer_slack=defer_slack)
        forecaster = ArrivalForecaster(idle_age=forecast_idle_age,
                                       tracker=tracker)
        sched = RequestScheduler(cache, cfg, forecaster=forecaster,
                                 tracker=tracker)
        return cls(rid, sched)

    # -- scheduler delegation ---------------------------------------------
    @property
    def plan_cache(self) -> PlanCache:
        return self.scheduler.plan_cache

    @property
    def pending(self) -> int:
        return self.scheduler.pending

    def submit(self, req, now: float, *, resubmit: bool = False) -> None:
        assert self.state == ACTIVE, (
            f"router dispatched to {self.state} replica {self.rid}")
        self.scheduler.submit(req, now, resubmit=resubmit)
        self._publish_depth()

    def next_batch(self, now: float, flush: bool = False) -> Admission | None:
        # a draining replica has no future arrivals by definition, so its
        # padded candidates must not defer waiting for them
        adm = self.scheduler.next_batch(
            now, flush=flush or self.state == DRAINING)
        if adm is not None:
            self._publish_depth()
        return adm

    def requeue(self, reqs: list, pad_rows: int = 0) -> None:
        self.scheduler.requeue(reqs, pad_rows)
        self._publish_depth()

    def complete(self, adm: Admission, now: float) -> None:
        """Account one finished batch (called by the execution harness
        when the batch's last step lands)."""
        tags = {"seq": adm.seq_len}
        self.tracker.count("replica.served", len(adm.requests), tags=tags)
        self.tracker.count("replica.batches", tags=tags)

    # -- state machine -----------------------------------------------------
    def drain(self, now: float) -> None:
        """Stop accepting dispatch; the queue serves out."""
        self.state = DRAINING
        self._publish_state()

    def fail(self, now: float) -> list:
        """Fail the replica: queued (never-admitted) requests are
        evacuated for router re-dispatch, age intact."""
        self.state = FAILED
        self._publish_state()
        evacuated = self.scheduler.drain()
        self._publish_depth()
        return evacuated

    def resume(self, now: float) -> None:
        self.state = ACTIVE
        self._publish_state()

    # -- publication -------------------------------------------------------
    def _publish_state(self) -> None:
        self.tracker.log("replica.state", float(_STATE_CODE[self.state]))

    def _publish_depth(self) -> None:
        self.tracker.log("replica.queue_depth", float(self.pending))


@dataclasses.dataclass(frozen=True)
class ReplicaView:
    """Router-side snapshot of one replica, derived exclusively from the
    folded trace plus the router's own unshipped-dispatch ledger."""

    rid: str
    state: str
    queue_depth: int  # last folded replica.queue_depth sample
    in_flight: int  # router dispatches since the last ship
    warm: frozenset  # seq bands with a compiled step (folded step_miss)
    submitted: float  # folded sched.submitted total

    @property
    def effective_depth(self) -> int:
        return self.queue_depth + self.in_flight


class FleetRouter:
    """Global SLA-aware dispatch over a replica pool, fed exclusively by
    folded per-replica tracker streams (see module docstring)."""

    def __init__(self, replicas: Sequence[Replica],
                 policy: str = "warmth",
                 cfg: FleetConfig = FleetConfig(),
                 tracker: Tracker | None = None):
        assert policy in POLICIES, f"policy {policy!r} not in {POLICIES}"
        assert replicas, "a fleet needs at least one replica"
        self.replicas = list(replicas)
        self.by_rid = {r.rid: r for r in self.replicas}
        assert len(self.by_rid) == len(self.replicas), "duplicate rids"
        self.policy = policy
        self.cfg = cfg
        # the router's own sink: the fold target for shipped traces and
        # the stream its own decisions (dispatch/spill/repartition) land
        # in.  A JsonlTracker here writes the folded multi-replica trace
        # CI's schema gate validates.
        self.tracker = tracker if tracker is not None else Tracker()
        self._folds = {r.rid: TraceFold(tags={"replica": r.rid})
                       for r in self.replicas}
        self._inflight = {r.rid: 0 for r in self.replicas}
        self._rr = 0
        # band (seq_len) -> home pool of rids; grown lazily under
        # warmth/sla, rewritten by sla's elastic repartition
        self._pools: dict[int, tuple[str, ...]] = {}
        self._last_repartition: float | None = None

    # -- tracker-backed counters (legacy attribute surface) ---------------
    @property
    def dispatched(self) -> int:
        return int(self.tracker.counter_total("router.dispatched"))

    @property
    def spills(self) -> int:
        return int(self.tracker.counter_total("router.spills"))

    @property
    def repartitions(self) -> int:
        return int(self.tracker.counter("router.repartitions"))

    @property
    def requeued(self) -> int:
        """Requests re-dispatched after a replica failure."""
        return int(self.tracker.counter_total("router.requeued"))

    # -- trace shipping ----------------------------------------------------
    def _read_records(self, rep: Replica) -> Iterable[Record]:
        t = rep.tracker
        if isinstance(t, JsonlTracker):
            t.flush()
            # partial_tail="drop": a replica killed mid-write still folds
            # up to its last complete record
            return read_jsonl(t.path, partial_tail="drop")
        if isinstance(t, RecordingTracker):
            return t.records
        raise TypeError(
            f"replica {rep.rid} tracker {type(t).__name__} retains no "
            f"record stream to ship (use JsonlTracker or RecordingTracker)")

    def ship(self, now: float) -> int:
        """One shipping round: fold every replica's new records into the
        router tracker (namespaced per replica), reset the unshipped
        ledger, and — under the ``sla`` policy — reconsider the pool
        partition.  Returns the number of records folded."""
        total = 0
        for rep in self.replicas:
            total += self._folds[rep.rid].fold(self._read_records(rep),
                                               self.tracker)
            self._inflight[rep.rid] = 0
        self.tracker.count("router.ships")
        if self.policy == "sla":
            self._maybe_repartition(now)
        return total

    # -- the folded view ---------------------------------------------------
    def view(self, rid: str) -> ReplicaView:
        t = self.tracker
        tags = {"replica": rid}
        st = t.series("replica.state", tags)
        state = _CODE_STATE[int(st.last)] if st.n else ACTIVE
        depth = t.series("replica.queue_depth", tags)
        warm = frozenset(
            tg["seq"] for tg, _ in t.counter_items("plan_cache.step_miss")
            if tg.get("replica") == rid and "seq" in tg)
        submitted = sum(v for tg, v in t.counter_items("sched.submitted")
                        if tg.get("replica") == rid)
        return ReplicaView(rid=rid, state=state,
                           queue_depth=int(depth.last) if depth.n else 0,
                           in_flight=self._inflight[rid], warm=warm,
                           submitted=submitted)

    def views(self) -> list[ReplicaView]:
        return [self.view(r.rid) for r in self.replicas]

    def band_rates(self) -> dict[int, float]:
        """Per-band global arrival rate (requests/s): the sum over
        replicas of each one's folded ``ArrivalForecaster`` estimate
        (1 / last EWMA mean gap) — each forecaster sees only its
        replica's share, so the fleet rate is the sum."""
        rates: dict[int, float] = {}
        for tg, st in self.tracker.series_items("forecast.mean_gap_s"):
            seq = tg.get("seq")
            if seq is None or st.n == 0 or st.last <= 0.0:
                continue
            rates[seq] = rates.get(seq, 0.0) + 1.0 / st.last
        return rates

    # -- dispatch ----------------------------------------------------------
    def dispatch(self, req, now: float, *, resubmit: bool = False) -> str:
        """Route one request to a replica; returns the chosen rid."""
        live = [v for v in self.views() if v.state == ACTIVE]
        if not live:
            raise RuntimeError("fleet has no active replica to dispatch to")
        rid = self._pick(req.seq_len, live)
        self._inflight[rid] += 1
        self.tracker.count("router.dispatched",
                           tags={"seq": req.seq_len, "replica": rid})
        self.by_rid[rid].submit(req, now, resubmit=resubmit)
        return rid

    def redispatch(self, reqs: Sequence, now: float) -> list[str]:
        """Re-route requests evacuated from a failed replica (submission
        age preserved; counted as ``router.requeued``)."""
        rids = []
        for req in reqs:
            self.tracker.count("router.requeued", tags={"seq": req.seq_len})
            rids.append(self.dispatch(req, now, resubmit=True))
        return rids

    def _pick(self, seq: int, live: list[ReplicaView]) -> str:
        if self.policy == "round_robin":
            order = [r.rid for r in self.replicas]
            live_rids = {v.rid for v in live}
            for _ in range(len(order)):
                rid = order[self._rr % len(order)]
                self._rr += 1
                if rid in live_rids:
                    return rid
        if self.policy == "least_loaded":
            return min(live, key=lambda v: (v.effective_depth, v.rid)).rid
        # warmth / sla: band affinity with least-queue spill
        pool = self._pool_for(seq, live)
        members = [v for v in live if v.rid in pool]
        floor = min(v.effective_depth for v in live)
        if not members:
            # home pool entirely down (failed/draining): spill to a warm
            # live replica if any, else the least loaded
            self.tracker.count("router.spills", tags={"seq": seq})
            warm = [v for v in live if seq in v.warm]
            pickfrom = warm or live
            return min(pickfrom,
                       key=lambda v: (v.effective_depth, v.rid)).rid
        home = min(members, key=lambda v: (v.effective_depth, v.rid))
        if home.effective_depth - floor >= self.cfg.spill_depth:
            target = min(live, key=lambda v: (v.effective_depth, v.rid))
            if target.rid != home.rid:
                self.tracker.count("router.spills", tags={"seq": seq})
                return target.rid
        return home.rid

    def _pool_for(self, seq: int, live: list[ReplicaView]) -> tuple[str, ...]:
        pool = self._pools.get(seq)
        if pool is None:
            # first sighting of a band: prefer a replica whose folded
            # trace already shows a compiled step for it (warm), else
            # balance homes across replicas
            warm = [v.rid for v in live if seq in v.warm]
            if warm:
                rid = sorted(warm)[0]
            else:
                counts = {v.rid: 0 for v in live}
                for p in self._pools.values():
                    for r in p:
                        if r in counts:
                            counts[r] += 1
                rid = min(counts, key=lambda r: (counts[r], r))
            pool = self._pools[seq] = (rid,)
            self.tracker.log("router.pool_size", 1.0, tags={"seq": seq})
        return pool

    # -- elastic repartition (sla policy) ----------------------------------
    def _maybe_repartition(self, now: float) -> None:
        c = self.cfg
        if (self._last_repartition is not None
                and now - self._last_repartition < c.repartition_every):
            return
        rates = self.band_rates()
        if not rates:
            return
        live_rids = sorted(r.rid for r in self.replicas
                           if self.view(r.rid).state == ACTIVE)
        if not live_rids:
            return
        self._last_repartition = now
        # token-rate load per band: an SP-heavy 1024 request is 4x the
        # work of a 256 one at equal arrival rates
        loads = {seq: rate * seq for seq, rate in rates.items()}
        total = sum(loads.values())
        if total <= 0.0:
            return
        bands = sorted(loads, key=lambda s: (-loads[s], s))
        n = len(live_rids)
        shares = {b: max(1, round(n * loads[b] / total)) for b in bands}
        while sum(shares.values()) > max(n, len(bands)):
            over = [b for b in bands if shares[b] > 1]
            if not over:
                break
            shares[max(over, key=lambda b: shares[b])] -= 1
        while sum(shares.values()) < n:
            shares[bands[0]] += 1
        # contiguous proportional slot -> replica map (pools may overlap
        # only when there are more bands than replicas)
        total_slots = sum(shares.values())
        pools: dict[int, tuple[str, ...]] = {}
        slot = 0
        for b in bands:
            members = tuple(dict.fromkeys(
                live_rids[(slot + j) * n // total_slots]
                for j in range(shares[b])))
            pools[b] = members
            slot += shares[b]
        new_pools = dict(self._pools)
        new_pools.update(pools)
        if new_pools != self._pools:
            self._pools = new_pools
            self.tracker.count("router.repartitions")
            for b, p in pools.items():
                self.tracker.log("router.pool_size", float(len(p)),
                                 tags={"seq": b})


# ---------------------------------------------------------------------------
# host-side discrete-event execution harness
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FailureEvent:
    """One injected drain/fail: at time ``at`` replica ``rid`` drains
    (stops accepting dispatch, serves out) or fails (additionally
    evacuates its queue for router re-dispatch); it resumes
    ``revive_after`` seconds later (None = never)."""

    at: float
    rid: str
    kind: str = "fail"  # "fail" | "drain"
    revive_after: float | None = 0.25

    def __post_init__(self):
        assert self.kind in ("fail", "drain"), self.kind


def run_fleet(reqs: Sequence, router: FleetRouter, *,
              trace_cost_s: float = 0.04,
              failure: FailureEvent | None = None) -> dict:
    """Step the fleet through one arrival stream on simulated time (no
    wall clock, fully deterministic given the stream).

    Batches execute for their comm-model-predicted duration
    (``plan.t_batch``) plus a one-time ``trace_cost_s`` stall the first
    time a replica runs a given bucket shape — the jit trace the plan
    cache memoizes, and the asymmetry the warmth policy exploits.  Trace
    shipping happens every ``router.cfg.ship_every`` simulated seconds;
    a failure event forces an immediate ship (the failover signal IS a
    shipped trace, not a side channel).  Returns fleet-wide stats in the
    ``BENCH_fleet_sweep.json`` metrics shape."""
    eps = 1e-9
    reqs = sorted(reqs, key=lambda r: (r.arrival, r.rid))
    running: dict[str, tuple] = {}  # rid -> (adm, t_start, t_end)
    stats = {"pad_tokens": 0, "real_tokens": 0, "batches": 0,
             "max_wait": 0.0, "sla_miss": 0, "sla_met": 0, "sla_total": 0,
             "served": 0, "preemptions": 0}
    i = 0
    t = 0.0
    ship_every = router.cfg.ship_every
    next_ship = ship_every
    fail_t = failure.at if failure is not None else None
    revive_t: float | None = None

    def ship_due(now: float) -> None:
        nonlocal next_ship
        while next_ship <= now + eps:
            router.ship(next_ship)
            next_ship += ship_every

    def start_batches(now: float) -> None:
        flush = i >= len(reqs)
        for rep in router.replicas:
            if rep.rid in running or rep.state == FAILED or not rep.pending:
                continue
            adm = rep.next_batch(now, flush=flush)
            if adm is None:
                continue  # deferred for packing; retried at the next event
            dur = adm.plan.t_batch
            before = rep.plan_cache.traces
            rep.plan_cache.step_fn(adm.batch_rows, adm.seq_len,
                                   lambda: None,
                                   variant=adm.plan.num_patches)
            if rep.plan_cache.traces > before:
                dur += trace_cost_s  # first time this shape runs here
            running[rep.rid] = (adm, now, now + dur)

    def complete(rep: Replica, adm: Admission, start: float,
                 end: float) -> None:
        for r in adm.requests:
            stats["max_wait"] = max(stats["max_wait"], start - r.submitted)
            if r.sla is not None:
                stats["sla_total"] += 1
                if end - r.submitted > r.sla:
                    stats["sla_miss"] += 1
                else:
                    stats["sla_met"] += 1
        stats["pad_tokens"] += adm.pad_rows * adm.seq_len
        stats["real_tokens"] += len(adm.requests) * adm.seq_len
        stats["served"] += len(adm.requests)
        stats["batches"] += 1
        rep.complete(adm, end)

    while True:
        ship_due(t)
        start_batches(t)
        times = []
        if i < len(reqs):
            times.append(reqs[i].arrival)
        times.extend(end for (_, _, end) in running.values())
        if fail_t is not None:
            times.append(fail_t)
        if revive_t is not None:
            times.append(revive_t)
        if not times:
            break  # queues empty, nothing running, stream exhausted
        t = min(times)
        for rid in [rid for rid, (_, _, end) in running.items()
                    if end <= t + eps]:
            adm, start, end = running.pop(rid)
            complete(router.by_rid[rid], adm, start, end)
        if fail_t is not None and t + eps >= fail_t:
            rep = router.by_rid[failure.rid]
            if failure.kind == "drain":
                rep.drain(fail_t)
                router.ship(fail_t)
            else:
                evacuated = rep.fail(fail_t)
                router.ship(fail_t)  # failover signal = shipped trace
                router.redispatch(evacuated, fail_t)
            if failure.revive_after is not None:
                revive_t = fail_t + failure.revive_after
            fail_t = None
        if revive_t is not None and t + eps >= revive_t:
            router.by_rid[failure.rid].resume(revive_t)
            router.ship(revive_t)
            revive_t = None
        while i < len(reqs) and reqs[i].arrival <= t + eps:
            ship_due(reqs[i].arrival)
            router.dispatch(reqs[i], reqs[i].arrival)
            i += 1

    router.ship(t)  # final fold so the summary reads complete streams
    rt = router.tracker
    stats["makespan_s"] = t
    stats["sla_met_frac"] = (stats["sla_met"] / stats["sla_total"]
                             if stats["sla_total"] else 1.0)
    stats["spills"] = int(rt.counter_total("router.spills"))
    stats["repartitions"] = int(rt.counter("router.repartitions"))
    stats["requeued"] = int(rt.counter_total("router.requeued"))
    stats["traces"] = int(rt.counter_total("plan_cache.step_miss"))
    return stats
