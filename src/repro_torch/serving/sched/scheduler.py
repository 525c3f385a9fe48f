"""Request scheduler facade (DESIGN.md §9/§10): bucketer → forecaster →
admission → plan cache, behind the calls an engine needs (``submit`` /
``next_batch`` / ``requeue``).

The scheduler is pure host-side bookkeeping — no jax, no device state —
so the same object drives the real ``DiTServer`` and the analytical
discrete-event simulation in ``benchmarks/sched_sweep.py``.
"""
from __future__ import annotations

import dataclasses

from ..metrics import Tracker
from .admission import AdmissionPolicy, Candidate, SchedConfig
from .bucketer import Bucketer, BucketStats
from .forecast import ArrivalForecaster
from .plan_cache import PlanCache, PlanChoice


@dataclasses.dataclass(frozen=True)
class Admission:
    """One scheduling decision: which requests run next and under what
    plan."""

    seq_len: int
    requests: list
    batch_rows: int  # len(requests) + dp padding rows
    pad_rows: int
    plan: PlanChoice
    min_slack: float
    age: float  # oldest queue age at admission


class RequestScheduler:
    def __init__(self, plan_cache: PlanCache,
                 cfg: SchedConfig = SchedConfig(),
                 forecaster: ArrivalForecaster | None = None,
                 tracker: Tracker | None = None):
        self.cfg = cfg
        self.plan_cache = plan_cache
        self.bucketer = Bucketer()
        self.forecaster = forecaster
        # share the engine's sink by default (an engine passes its own;
        # standalone schedulers fall back to the plan cache's)
        self.tracker = tracker if tracker is not None else plan_cache.tracker
        self.policy = AdmissionPolicy(cfg, plan_cache, forecaster,
                                      tracker=self.tracker)

    # -- tracker-backed counters (legacy attribute surface, DESIGN.md §11)
    @property
    def admissions(self) -> int:
        return int(self.tracker.counter_total("sched.admissions"))

    @property
    def preempted(self) -> int:
        """Requests returned via ``requeue()``."""
        return int(self.tracker.counter("sched.requeued_requests"))

    def submit(self, req, now: float, *, resubmit: bool = False) -> None:
        """Enqueue a request, stamping its submission time (the basis for
        SLA deadlines and starvation ages) and feeding the bucket's
        arrival-rate estimate.

        ``resubmit=True`` is the fleet-failover path (serving/fleet.py):
        the request was evacuated from another replica, so ``submitted``
        is kept (accrued age and the original SLA deadline survive the
        re-dispatch, same invariant as ``requeue``) and the arrival is
        NOT fed to the forecaster — a failover is not new traffic."""
        if resubmit:
            self.tracker.count("sched.resubmitted", tags={"seq": req.seq_len})
        else:
            req.submitted = now
            if self.forecaster is not None:
                self.forecaster.observe(req.seq_len, now)
            self.tracker.count("sched.submitted", tags={"seq": req.seq_len})
        self.bucketer.add(req)

    def requeue(self, reqs: list, pad_rows: int = 0) -> None:
        """Park a preempted batch: its requests return to the HEAD of
        their bucket in original order with ``submitted`` untouched, so
        accrued starvation age survives the preemption (DESIGN.md §10),
        and the admission's bucket accounting is reversed (``pad_rows``
        from the Admission) so ``totals()`` counts only completed
        batches.  No arrival is recorded — a parked request is not new
        traffic.  ``admissions`` is NOT decremented: it counts
        ``next_batch`` decisions, parked or not."""
        self.bucketer.requeue(reqs, pad_rows)
        self.tracker.count("sched.requeued_requests", len(reqs))

    def drain(self) -> list:
        """Evacuate every queued request (global FIFO by submission,
        ``submitted`` untouched) — a failed/draining fleet replica hands
        these back to the router for re-dispatch (serving/fleet.py)."""
        reqs = self.bucketer.drain()
        if reqs:
            self.tracker.count("sched.drained", len(reqs))
        return reqs

    @property
    def pending(self) -> int:
        return self.bucketer.pending

    def next_batch(self, now: float, flush: bool = False) -> Admission | None:
        """Pick and dequeue the next batch; None = nothing admissible
        (queue empty, or every candidate is worth deferring and ``flush``
        is False)."""
        cand = self.policy.pick(self.bucketer.nonempty(), now, flush=flush)
        if cand is None:
            return None
        reqs = cand.bucket.pop(cand.k, now, self.cfg.dp)
        t = self.tracker
        tags = {"seq": cand.bucket.seq_len}
        t.count("sched.admissions", tags=tags)
        t.count("sched.pad_rows", cand.pad_rows, tags=tags)
        t.log("sched.batch_wait_s", cand.age, tags=tags)
        t.log("sched.min_slack_s", cand.min_slack, tags=tags)
        return Admission(cand.bucket.seq_len, reqs, cand.batch_rows,
                         cand.pad_rows, cand.plan, cand.min_slack, cand.age)

    def waiting_candidates(self, now: float) -> list[Candidate]:
        """Scored candidates over the currently queued buckets WITHOUT
        dequeuing — what the preemption policy inspects between sampler
        steps (sched/control.py)."""
        return self.policy.candidates(self.bucketer.nonempty(), now)

    def totals(self) -> BucketStats:
        """Aggregated padding-waste / starvation-age accounting."""
        return self.bucketer.totals()
