"""SLA-aware cross-bucket admission (DESIGN.md §9).

Each scheduling round scores candidate (bucket, batch-size) pairs and
admits the best one — across buckets, not head-of-line.  The score is in
seconds, combining:

  * **deadline slack** — min over the candidate's requests of
    ``deadline - now - predicted_batch_latency``, with the batch latency
    taken from the comm model via the plan cache.  Tight slack ⇒ urgent.
  * **padding cost** — the device time the dp-divisibility pad would
    waste, ``pad_rows / batch_rows * batch_latency``.
  * **aging credit** — ``oldest_age * aging_rate`` subtracted from the
    score, so waiting buckets monotonically gain urgency.

Two hard rules sit above the scoring:

  * **starvation bound** — a bucket whose oldest request has waited
    ``starvation_age`` or longer MUST be served next (most overdue first);
    scoring only breaks ties among non-overdue buckets.
  * **deferral** — a candidate that needs padding rows may wait for more
    arrivals while its slack exceeds ``defer_slack`` (unless ``flush`` is
    set, i.e. no more arrivals are coming); this is what converts greedy
    fragment batches into dp-aligned ones.  With an ``ArrivalForecaster``
    attached (DESIGN.md §10) the wait is no longer open-ended: the
    candidate defers only while the forecast time for the missing rows to
    arrive — EWMA interarrival gap plus a variance safety margin — fits
    inside its slack.  A bucket whose arrivals have dried up is served
    padded immediately instead of stalling until ``flush``.
"""
from __future__ import annotations

import dataclasses

from ..metrics import Tracker
from .bucketer import Bucket, aged_priority, padded_rows
from .forecast import ArrivalForecaster
from .plan_cache import PlanCache, PlanChoice


@dataclasses.dataclass(frozen=True)
class SchedConfig:
    max_batch: int = 4
    dp: int = 1  # data-parallel degree the batch must divide into
    starvation_age: float = 30.0  # s: hard admission bound
    aging_rate: float = 1.0  # s of score credit per s of queue age
    default_slack: float = 60.0  # assumed slack for requests without SLA
    defer_slack: float = 1.0  # padded candidates wait while slack > this
    # std-dev multiplier on the forecast fill time: higher inflates the
    # predicted wait under jittery arrivals, so padded candidates give up
    # deferring (and serve padded) sooner; 0 trusts the mean gap alone
    forecast_safety: float = 1.0


@dataclasses.dataclass(frozen=True)
class Candidate:
    bucket: Bucket
    k: int  # real requests admitted
    batch_rows: int  # k + dp padding rows
    pad_rows: int
    plan: PlanChoice
    min_slack: float
    age: float
    score: float


class AdmissionPolicy:
    def __init__(self, cfg: SchedConfig, plan_cache: PlanCache,
                 forecaster: ArrivalForecaster | None = None,
                 tracker: Tracker | None = None):
        self.cfg = cfg
        self.plans = plan_cache
        self.forecaster = forecaster
        self.tracker = tracker if tracker is not None else plan_cache.tracker

    def _worth_deferring(self, c: Candidate, now: float) -> bool:
        """Whether a padded candidate should wait for more arrivals.

        Without a forecaster: the PR-3 rule (wait while slack allows).
        With one: wait only while the predicted time for the missing rows
        to arrive also fits inside the slack — the explicit deferral
        horizon (DESIGN.md §10)."""
        if c.min_slack <= self.cfg.defer_slack:
            return False  # too urgent to wait, forecast or not
        if self.forecaster is None:
            return True
        fill = self.forecaster.expected_fill_time(
            c.bucket.seq_len, c.pad_rows, now,
            safety=self.cfg.forecast_safety)
        if fill is None:
            return True  # no rate estimate yet: keep the PR-3 behavior
        return fill <= c.min_slack - self.cfg.defer_slack

    def _candidate(self, b: Bucket, k: int, now: float) -> Candidate:
        c = self.cfg
        pad = padded_rows(k, c.dp)
        rows = k + pad
        plan = self.plans.select(rows, b.seq_len)
        slack = b.min_slack(now, plan.t_batch, k, c.default_slack)
        age = b.oldest_age(now)
        pad_cost = pad / rows * plan.t_batch
        score = slack + pad_cost - aged_priority(0.0, age, c.aging_rate)
        return Candidate(b, k, rows, pad, plan, slack, age, score)

    def candidates(self, buckets: list[Bucket], now: float) -> list[Candidate]:
        c = self.cfg
        out = []
        for b in buckets:
            ks = {min(len(b), c.max_batch)}
            aligned = (min(len(b), c.max_batch) // c.dp) * c.dp
            if aligned > 0:
                ks.add(aligned)  # pad-free alternative when enough queued
            for k in sorted(ks):
                out.append(self._candidate(b, k, now))
        return out

    def pick(self, buckets: list[Bucket], now: float,
             flush: bool = False) -> Candidate | None:
        cands = self.candidates(buckets, now)
        if not cands:
            return None
        c = self.cfg
        overdue = [x for x in cands if x.age >= c.starvation_age]
        if overdue:
            # starvation bound: most overdue first; bigger batch breaks ties
            best = max(overdue, key=lambda x: (x.age, x.k))
            self.tracker.count("sched.overdue_admissions",
                               tags={"seq": best.bucket.seq_len})
            return best
        if not flush:
            eligible = [x for x in cands
                        if x.pad_rows == 0
                        or not self._worth_deferring(x, now)]
            if not eligible:
                # every padded option is worth waiting on
                self.tracker.count("sched.deferrals")
                return None
            cands = eligible
        # lowest score = most urgent; ties to the older, then longer bucket
        return min(cands, key=lambda x: (x.score, -x.age, -x.bucket.seq_len))
